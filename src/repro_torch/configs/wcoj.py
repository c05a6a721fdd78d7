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

The dry-run cells of these shapes (``cell()``) are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..device import resolve_device

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


@dataclass
class WCOJArch:
    arch_id: str = "wcoj"
    shapes: dict = field(default_factory=lambda: dict(WCOJ_SHAPES))

    family = "wcoj"

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
