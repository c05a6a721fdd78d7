"""The paper's engine as an architecture of the registry (``wcoj``): its
shapes, worst-case-optimal join steps at the scale of §5.1's largest
datasets, as the JAX package's ``repro.configs.wcoj`` gives them, and a
smoke run of the port's engine.

Shapes:
  * ``triangle_frontier`` — one vectorized-LFTJ expansion level of the
    3-clique on an Orkut-scale CSR (234,370,166 CSR entries), frontier
    sharded over (pod, data);
  * ``path_spmv`` — one #Minesweeper counting message (SpMV) on a
    LiveJournal-scale graph, edges sharded;
  * ``fourclique_check`` — the check-heavy level (two membership probes
    per candidate) of the 4-clique;
  * the rest, the JAX package's §Perf variants of those levels.

Each shape's dry-run cell (``cell()``) runs the port's level step
(``core.vlftj._expand_level``) or its segment sum on abstract arguments
of that scale; ``launch.dryrun`` counts its cost.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from ..core.vlftj import _expand_level
from ..device import resolve_device
from ..layers.sharding import is_dtensor
from ..models.gnn.data import gather, scatter_sum
from .common import Cell, _dataxes, named, sds

WCOJ_SHAPES = {
    "triangle_frontier": dict(kind="join", n_nodes=3_072_441,
                              n_edges=234_370_166, frontier=1 << 20,
                              width=512, n_bound=2, n_probe=1),
    "path_spmv": dict(kind="spmv", n_nodes=4_847_571,
                      n_edges=137_987_546),
    "fourclique_check": dict(kind="join", n_nodes=3_072_441,
                             n_edges=234_370_166, frontier=1 << 19,
                             width=512, n_bound=3, n_probe=2),
    # §Perf hillclimb variants (beyond-paper; baselines above unchanged)
    "triangle_frontier_tile": dict(
        kind="join", n_nodes=3_072_441, n_edges=234_370_166,
        frontier=1 << 20, width=512, n_bound=2, n_probe=1,
        variant="tile_bucketed", tile_frac=0.9375, check_width=512),
    "fourclique_check_tile": dict(
        kind="join", n_nodes=3_072_441, n_edges=234_370_166,
        frontier=1 << 19, width=512, n_bound=3, n_probe=2,
        variant="tile_bucketed", tile_frac=0.9375, check_width=512),
    "triangle_frontier_rot": dict(
        kind="join", n_nodes=3_072_441, n_edges=234_370_166,
        frontier=1 << 20, width=512, n_bound=2, n_probe=1,
        variant="rotate"),
    "triangle_frontier_rot2l": dict(
        kind="join", n_nodes=3_072_441, n_edges=234_370_166,
        frontier=1 << 20, width=512, n_bound=2, n_probe=1,
        variant="rotate2l", stride=128),
    "fourclique_check_rot2l": dict(
        kind="join", n_nodes=3_072_441, n_edges=234_370_166,
        frontier=1 << 19, width=512, n_bound=3, n_probe=2,
        variant="rotate2l", stride=128),
    # A4: + frontier sharded over the FULL mesh (the model axis has no
    # MXU work in a join, but its HBM bandwidth is real)
    "triangle_frontier_opt": dict(
        kind="join", n_nodes=3_072_441, n_edges=234_370_166,
        frontier=1 << 20, width=512, n_bound=2, n_probe=1,
        variant="rotate2l", stride=128, full_mesh=True),
    "fourclique_check_opt": dict(
        kind="join", n_nodes=3_072_441, n_edges=234_370_166,
        frontier=1 << 19, width=512, n_bound=3, n_probe=2,
        variant="rotate2l", stride=128, full_mesh=True),
}


def _head_tail(x, k: int, n: int):
    """``(x[:k], x[k:])`` of ``n`` rows; a DTensor split along its rows is
    cut on each chip at ``k / n`` of its own rows (the rows stay where
    they are, where slicing the global rows would gather them), so every
    chip sends the same share to each check path."""
    if not is_dtensor(x):
        return x[:k], x[k:]
    from torch.distributed.tensor.experimental import local_map
    pl = list(x.placements)
    cut = lambda t: (t[:k * t.shape[0] // n], t[k * t.shape[0] // n:])
    return local_map(cut, out_placements=(pl, pl), in_placements=(pl,),
                     device_mesh=x.device_mesh)(x)


@dataclass
class WCOJArch:
    arch_id: str = "wcoj"
    shapes: dict = field(default_factory=lambda: dict(WCOJ_SHAPES))

    family = "wcoj"

    def cell(self, shape_name: str, mesh) -> Cell:
        sh = self.shapes[shape_name]
        dax = _dataxes(mesh)
        if sh.get("full_mesh"):
            dax = tuple(mesh.axis_names)  # joins use every axis' HBM
        if sh["kind"] == "spmv":
            n = sh["n_nodes"]
            e = -(-sh["n_edges"] // 512) * 512  # pad to shard boundary

            def spmv(indices, src_ids, c):
                return scatter_sum(gather(c, indices.long()), src_ids, n)

            args = (sds((e,), torch.int32), sds((e,), torch.int32),
                    sds((n,), torch.int64))
            in_sh = named(mesh, ((dax,), (dax,), ()))
            return Cell(self.arch_id, shape_name, "forward", spmv, args,
                        in_shardings=in_sh,
                        out_shardings=named(mesh, ()),
                        model_flops=2.0 * e,
                        note="counting message pass (#MS Idea 8)")
        n, e = sh["n_nodes"], sh["n_edges"]
        c, w, nb = sh["frontier"], sh["width"], sh["n_bound"]
        n_iter = 18  # ceil(log2(max_deg ~ 100k)) + margin
        probe_cols = tuple(range(nb))  # all bound vars adjacent via edges
        variant = sh.get("variant", "bsearch")

        def rows(k, like):
            return torch.ones((k,), dtype=torch.bool, device=like.device)

        if variant == "tile_bucketed":
            # degree-bucketed membership: most rows (tile_frac, per the
            # power-law degree CDF) gather their check segment once and
            # compare it densely; only the heavy tail binary-searches
            ct = int(c * sh["tile_frac"]) // 512 * 512
            cw = sh["check_width"]

            def join_step(indptr, indices, frontier, mult):
                base = dict(probe_cols=probe_cols, n_unary=0,
                            lower_cols=(nb - 1,), upper_cols=(),
                            width=w, n_iter=n_iter, count_only=True,
                            needs_degree=False, unroll=True)
                (f1, f2), (m1, m2) = (_head_tail(t, ct, c)
                                      for t in (frontier, mult))
                c1 = _expand_level(
                    indptr, indices, (), f1, m1, rows(f1.shape[0], f1),
                    check_mode="tile", check_width=cw, **base)
                c2 = _expand_level(
                    indptr, indices, (), f2, m2, rows(f2.shape[0], f2),
                    **base)
                return c1.sum() + c2.sum()
        elif variant in ("rotate", "rotate2l"):
            # only the P-1 non-probe membership checks (rotated from the
            # per-row argmin probe); "2l" adds the two-level search, whose
            # most rounds hit the stride-times smaller summary array
            two_level = variant == "rotate2l"
            stride = sh.get("stride", 128)
            kw2 = {}
            if two_level:
                kw2 = dict(check_mode="bsearch2", summary_stride=stride,
                           n_iter2=int(math.ceil(math.log2(2 * stride + 2)))
                           + 1)
                n1 = int(math.ceil(math.log2(131072 // stride))) + 1

            def join_step(indptr, indices, frontier, mult, summary=None):
                counts = _expand_level(
                    indptr, indices, (), frontier, mult,
                    rows(frontier.shape[0], frontier),
                    probe_cols=probe_cols, n_unary=0,
                    lower_cols=(nb - 1,), upper_cols=(), width=w,
                    n_iter=(n1 if two_level else n_iter),
                    count_only=True, needs_degree=False,
                    unroll=True, rotate_checks=True,
                    summary=summary, **kw2)
                return counts.sum()

            if two_level:
                args = (sds((n + 1,), torch.int32), sds((e,), torch.int32),
                        sds((c, nb), torch.int32), sds((c,), torch.int64),
                        sds((e // stride,), torch.int32))
                in_sh = named(mesh, ((), (), (dax, None), (dax,), ()))
                flops = c * w * (sh["n_probe"] * 20 * 4 + 8)
                return Cell(self.arch_id, shape_name, "forward",
                            join_step, args, in_shardings=in_sh,
                            out_shardings=named(mesh, ()),
                            model_flops=float(flops),
                            note="vLFTJ level, rotated checks + "
                                 "2-level search")
        else:
            def join_step(indptr, indices, frontier, mult):
                counts = _expand_level(
                    indptr, indices, (), frontier, mult,
                    rows(frontier.shape[0], frontier),
                    probe_cols=probe_cols, n_unary=0,
                    lower_cols=(nb - 1,), upper_cols=(), width=w,
                    n_iter=n_iter, count_only=True, needs_degree=False,
                    unroll=True)
                return counts.sum()

        args = (sds((n + 1,), torch.int32), sds((e,), torch.int32),
                sds((c, nb), torch.int32), sds((c,), torch.int64))
        in_sh = named(mesh, ((), (), (dax, None), (dax,)))
        # per candidate: n_probe bsearches x n_iter compares + filters
        flops = c * w * (sh["n_probe"] * n_iter * 4 + 8)
        return Cell(self.arch_id, shape_name, "forward", join_step, args,
                    in_shardings=in_sh, out_shardings=named(mesh, ()),
                    model_flops=float(flops),
                    note="vectorized LFTJ expansion level")

    def smoke(self, device: torch.device | str = "cuda") -> dict:
        """The 3-clique of ``powerlaw_cluster(200, 4, seed=0)`` counted by
        ``vlftj`` on ``device`` and by the host's ``lftj_ref``; the two
        must be equal."""
        from ..core import GraphDB, get_query, lftj_count, vlftj_count
        from ..graphs import powerlaw_cluster
        dev = resolve_device(device, "WCOJArch.smoke")
        g = powerlaw_cluster(200, 4, seed=0)
        gdb = GraphDB(g, {}, device=dev)
        c = vlftj_count(get_query("3-clique"), gdb)
        ref = lftj_count(get_query("3-clique"), gdb.to_database())
        if c != ref:
            raise ValueError(f"wcoj smoke: vlftj counts {c} triangles, "
                             f"lftj_ref {ref}")
        return {"triangles": c}
