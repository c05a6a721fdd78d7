"""Row-partitioned CSR: joins over graphs too large to replicate (the port
of ``repro.dist.sharded_csr``).

``spmd_join_step`` replicates the whole CSR on every rank — fine until
the graph outgrows a card's memory.  :class:`ShardedGraphDB` splits the
node domain into ``n_shards`` contiguous, edge-balanced ranges; shard
``s`` stores only its own rows (a local ``indptr`` rebased to 0 plus the
matching ``indices`` slice) and an owner map (the range ``bounds``) says
which shard serves any vertex.

Two executions consume the layout:

* :func:`sharded_count` — the host-level reference driver.  A full
  vectorized-LFTJ level loop in which *every* adjacency access goes
  through :meth:`ShardedGraphDB.gather_segments` /
  :meth:`~ShardedGraphDB.degrees_of`, i.e. only per-shard arrays are
  ever touched and cross-shard traffic is metered in
  ``ShardedGraphDB.exchange`` — the oracle the parity tests compare
  against the replicated engines on every tier-1 query shape.
* :func:`spmd_sharded_join_step` — the rank-level SPMD expansion over
  a ``torch.distributed`` process group.  Each rank holds one shard's
  block; per level the frontier's probe and check adjacencies are
  collected during an ``n_shards``-hop ring rotation of the CSR blocks
  (the same ring wiring as ``dist.overlap.ring_all_reduce`` —
  :func:`~repro_torch.dist.overlap.ring_schedule`; one
  ``batch_isend_irecv`` a hop), membership checks binary-search the
  gathered segments (``searchsorted_segments``), and one ``all_reduce``
  folds the counts.  Peak memory per rank is one CSR shard (plus the
  in-flight neighbor block), not the whole graph.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from ..core.plan import (GraphStats, JoinPlan, compile_levels,
                         executor_geometry)
from ..core.query import Query
from ..device import check_group_device
from ..graphs.csr import CSRGraph, degrees_from_indptr
from ..kernels import ops as kops
from .overlap import ring_hop, ring_schedule
from .sharded_join import _on, _pad_block, _step_device


class ShardedGraphDB:
    """Row-partitioned CSR + replicated unary sets.

    Shard ``s`` owns the contiguous node range ``[bounds[s],
    bounds[s+1])``, chosen so shard *edge* counts balance (a degree-sorted
    split would balance better under extreme skew but break the
    contiguous owner map the device exchange needs).  Unary predicates
    stay replicated — they are node bitmaps, small next to the adjacency.

    ``exchange`` meters the traffic a real deployment would put on the
    interconnect: ``gathers`` counts vectorized gather rounds (each maps
    to one ring rotation on devices) and ``values`` the adjacency
    entries shipped.
    """

    def __init__(self, csr: CSRGraph, n_shards: int,
                 unary: dict[str, np.ndarray] | None = None):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.n_shards = n_shards
        self.n_nodes = csr.n_nodes
        self.n_edges = csr.n_edges
        targets = np.linspace(0, csr.indices.shape[0], n_shards + 1)
        bounds = np.searchsorted(csr.indptr, targets[1:-1], side="left")
        self.bounds = np.concatenate(
            [[0], np.maximum.accumulate(bounds), [csr.n_nodes]]
        ).astype(np.int64)
        self.local_indptr: list[np.ndarray] = []
        self.local_indices: list[np.ndarray] = []
        for s in range(n_shards):
            lo, hi = self.bounds[s], self.bounds[s + 1]
            iptr = csr.indptr[lo:hi + 1] - csr.indptr[lo]
            self.local_indptr.append(iptr.astype(np.int64))
            self.local_indices.append(
                csr.indices[csr.indptr[lo]:csr.indptr[hi]].astype(np.int64))
        self.unary = {k: np.asarray(v) for k, v in (unary or {}).items()}
        self.exchange = {"gathers": 0, "values": 0}

    # -- owner map -----------------------------------------------------------
    def owner_of(self, values: np.ndarray) -> np.ndarray:
        """Shard id owning each vertex."""
        v = np.asarray(values, dtype=np.int64)
        return np.searchsorted(self.bounds, v, side="right") - 1

    @property
    def shard_sizes(self) -> list[tuple[int, int]]:
        """Per-shard (nodes, edges) — the replication this layout avoids."""
        return [(int(self.bounds[s + 1] - self.bounds[s]),
                 int(self.local_indices[s].shape[0]))
                for s in range(self.n_shards)]

    # -- sharded accessors (all adjacency IO goes through these) -------------
    def degrees_of(self, values: np.ndarray) -> np.ndarray:
        """Degree lookup via each vertex's owning shard."""
        v = np.asarray(values, dtype=np.int64).ravel()
        owner = self.owner_of(v)
        deg = np.zeros(v.shape[0], dtype=np.int64)
        for s in range(self.n_shards):
            m = owner == s
            if not m.any():
                continue
            li = v[m] - self.bounds[s]
            iptr = self.local_indptr[s]
            deg[m] = iptr[li + 1] - iptr[li]
        self.exchange["gathers"] += 1
        return deg.reshape(np.asarray(values).shape)

    def gather_segments(self, values: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Adjacency of each vertex, row-major flattened.

        Returns ``(deg (R,), flat (deg.sum(),), reps (deg.sum(),))``:
        segment ``i`` occupies ``flat[offs[i]:offs[i+1]]`` (sorted, since
        shard slices preserve CSR order) and ``reps`` maps flat entries
        back to rows.  Host stand-in for one ring rotation: each shard
        contributes exactly the rows it owns.
        """
        v = np.asarray(values, dtype=np.int64).ravel()
        owner = self.owner_of(v)
        deg = np.zeros(v.shape[0], dtype=np.int64)
        starts = np.zeros(v.shape[0], dtype=np.int64)
        for s in range(self.n_shards):
            m = owner == s
            if not m.any():
                continue
            li = v[m] - self.bounds[s]
            iptr = self.local_indptr[s]
            starts[m] = iptr[li]
            deg[m] = iptr[li + 1] - iptr[li]
        total = int(deg.sum())
        flat = np.empty(total, dtype=np.int64)
        offs = np.concatenate([[0], np.cumsum(deg)])
        reps = np.repeat(np.arange(v.shape[0]), deg)
        pos = np.arange(total) - np.repeat(offs[:-1], deg)
        src = starts[reps] + pos
        own = owner[reps]
        for s in range(self.n_shards):
            m = own == s
            if m.any():
                flat[m] = self.local_indices[s][src[m]]
        self.exchange["gathers"] += 1
        self.exchange["values"] += total
        return deg, flat, reps

    # -- planner / device bridges --------------------------------------------
    def graph_stats(self) -> GraphStats:
        """Planner stats from shard metadata alone (no reassembly)."""
        max_deg = max((int(degrees_from_indptr(iptr).max(initial=0))
                       for iptr in self.local_indptr), default=0)
        n = max(1, self.n_nodes)
        return GraphStats(
            n_nodes=self.n_nodes, n_edges=self.n_edges,
            max_degree=max_deg, avg_degree=self.n_edges / n,
            unary_sizes=tuple(sorted(
                (name, int(len(ids))) for name, ids in self.unary.items())))

    def replicated(self) -> CSRGraph:
        """Reassembled full CSR — for parity tests only."""
        indptr = [np.zeros(1, dtype=np.int64)]
        off = 0
        for s in range(self.n_shards):
            indptr.append(self.local_indptr[s][1:] + off)
            off += int(self.local_indices[s].shape[0])
        return CSRGraph(indptr=np.concatenate(indptr),
                        indices=np.concatenate(self.local_indices)
                        if self.local_indices else np.zeros(0, np.int64),
                        n_nodes=self.n_nodes)

    def device_blocks(self) -> dict:
        """Uniformly padded per-shard blocks for the SPMD ring step.

        ``indptr`` (S, Ln+1) is end-padded with its last value (padding
        nodes read as degree 0); ``indices`` (S, Le) is zero-padded.
        """
        ln = max(self.bounds[s + 1] - self.bounds[s]
                 for s in range(self.n_shards))
        le = max(1, max((idx.shape[0] for idx in self.local_indices),
                        default=1))
        indptr = np.zeros((self.n_shards, ln + 1), dtype=np.int32)
        indices = np.zeros((self.n_shards, le), dtype=np.int32)
        for s in range(self.n_shards):
            iptr = self.local_indptr[s]
            indptr[s, :iptr.shape[0]] = iptr
            indptr[s, iptr.shape[0]:] = iptr[-1]
            idx = self.local_indices[s]
            indices[s, :idx.shape[0]] = idx
        return {"indptr": indptr, "indices": indices,
                "bounds": self.bounds.astype(np.int32)}


def _segment_member(deg_s, flat_s, reps_s, cand, cand_rows,
                    n_nodes: int) -> np.ndarray:
    """Membership of ``cand`` (row ``cand_rows``) in per-row sorted
    segments, via one global searchsorted over row-disjoint keys."""
    keys_seg = reps_s * n_nodes + flat_s          # globally ascending
    keys_c = cand_rows * n_nodes + cand
    idx = np.searchsorted(keys_seg, keys_c)
    ok = idx < keys_seg.shape[0]
    found = np.zeros(cand.shape[0], dtype=bool)
    found[ok] = keys_seg[idx[ok]] == keys_c[ok]
    return found


def sharded_count(query: Query, sgdb: ShardedGraphDB,
                  plan: JoinPlan | None = None,
                  chunk_rows: int = 8192) -> int:
    """Full WCOJ count touching the CSR only through shard-local arrays.

    Mirrors the vectorized-LFTJ level semantics (min-degree probe,
    membership checks, unary bitmaps, ``<`` filters, degree pruning) with
    every adjacency read routed through the sharded accessors, so its
    result equals the replicated engines' exactly while
    ``sgdb.exchange`` records the cross-shard traffic.
    """
    if plan is None:
        from ..core.planner import plan_query
        plan = plan_query(query, sgdb.graph_stats(), engine="vlftj")
    levels = plan.levels or compile_levels(query, plan.gao)
    n = sgdb.n_nodes
    bitmap: dict[str, np.ndarray] = {}
    for name, ids in sgdb.unary.items():
        bm = np.zeros(n, dtype=bool)
        bm[ids[ids < n]] = True
        bitmap[name] = bm

    def domain(lp) -> np.ndarray:
        if lp.unary:
            base = min((sgdb.unary[u] for u in lp.unary), key=len)
            vals = np.unique(np.asarray(base, dtype=np.int64))
            vals = vals[vals < n]
        else:
            vals = np.arange(n, dtype=np.int64)
        for u in lp.unary:
            vals = vals[bitmap[u][vals]]
        if lp.needs_degree:
            vals = vals[sgdb.degrees_of(vals) > 0]
        return vals

    k = len(levels)
    # trace hook: per-level exchange deltas (gathers / adjacency values
    # shipped) become 'exchange' events on the active trace — pure host
    # counter reads, mirroring what a real interconnect would carry
    from ..obs import current_trace
    tr = current_trace()

    def note_level(level: int, rows: int, g0: int, v0: int) -> None:
        if tr is None:
            return
        dg = sgdb.exchange["gathers"] - g0
        dv = sgdb.exchange["values"] - v0
        tr.level(level, obs_rows=rows,
                 var=plan.gao[level] if level < len(plan.gao) else None,
                 est_rows=(plan.level_est_rows[level]
                           if level < len(plan.level_est_rows) else None))
        tr.event("exchange", level=level, gathers=dg, values=dv,
                 bytes=dv * 8)

    frontier = domain(levels[0])[:, None]
    note_level(0, int(frontier.shape[0]),
               sgdb.exchange["gathers"], sgdb.exchange["values"])
    if k == 1:
        return int(frontier.shape[0])
    total = 0
    for level in range(1, k):
        g0, v0 = sgdb.exchange["gathers"], sgdb.exchange["values"]
        lp = levels[level]
        last = level == k - 1
        if frontier.shape[0] == 0:
            return total if last else 0
        if not lp.edge_sources:
            vals = domain(lp)
            if last and not lp.lower and not lp.upper:
                add = int(frontier.shape[0]) * int(vals.shape[0])
                note_level(level, total + add, g0, v0)
                return total + add
            reps = np.repeat(np.arange(frontier.shape[0]), vals.shape[0])
            cand = np.tile(vals, frontier.shape[0])
            ok = np.ones(cand.shape[0], dtype=bool)
            for col in lp.lower:
                ok &= cand > frontier[reps, col]
            for col in lp.upper:
                ok &= cand < frontier[reps, col]
            if last:
                note_level(level, total + int(ok.sum()), g0, v0)
                return total + int(ok.sum())
            frontier = np.concatenate(
                [frontier[reps[ok]], cand[ok][:, None]], axis=1)
            note_level(level, int(frontier.shape[0]), g0, v0)
            continue
        srcs = list(lp.edge_sources)
        out_parts: list[np.ndarray] = []
        for s0 in range(0, frontier.shape[0], chunk_rows):
            chunk = frontier[s0:s0 + chunk_rows]
            xs = chunk[:, srcs]                              # (C, P)
            deg = sgdb.degrees_of(xs)
            p = np.argmin(deg, axis=1)
            probe = np.take_along_axis(xs, p[:, None], axis=1)[:, 0]
            dstar, cand, reps = sgdb.gather_segments(probe)
            keep = np.ones(cand.shape[0], dtype=bool)
            for ci in range(len(srcs)):
                # gather check segments only for rows whose probe is a
                # DIFFERENT column — the probe column's adjacency is the
                # candidate set itself, already shipped (and its rows'
                # membership is trivially true)
                need_rows = np.flatnonzero(p != ci)
                if need_rows.size == 0:
                    continue
                seg = sgdb.gather_segments(xs[need_rows, ci])
                mask_c = (p != ci)[reps]
                comp = np.searchsorted(need_rows, reps[mask_c])
                keep[mask_c] &= _segment_member(*seg, cand[mask_c],
                                                comp, n)
            for u in lp.unary:
                keep &= bitmap[u][cand]
            for col in lp.lower:
                keep &= cand > chunk[reps, col]
            for col in lp.upper:
                keep &= cand < chunk[reps, col]
            if lp.needs_degree:
                keep &= sgdb.degrees_of(cand) > 0
            if last:
                total += int(keep.sum())
            else:
                out_parts.append(np.concatenate(
                    [chunk[reps[keep]], cand[keep][:, None]], axis=1))
        if last:
            note_level(level, total, g0, v0)
            return total
        frontier = (np.concatenate(out_parts, axis=0) if out_parts
                    else np.zeros((0, frontier.shape[1] + 1), np.int64))
        note_level(level, int(frontier.shape[0]), g0, v0)
    return total


# ---------------------------------------------------------------------------
# rank-level SPMD ring step
# ---------------------------------------------------------------------------

def spmd_sharded_join_step(group, level_kw: dict, sgdb: ShardedGraphDB,
                           device: torch.device | str = "cuda"):
    """Sharded-CSR counterpart of :func:`~repro_torch.dist.sharded_join
    .spmd_join_step`: one expansion level over ``group`` with **no CSR
    replication**.

    Each rank holds one shard's padded ``(indptr, indices)`` block
    (``ShardedGraphDB.device_blocks``, padded to the largest shard so
    every hop moves blocks of one size) on ``device``.  The frontier is
    split into rank blocks as usual; probe/check adjacency that lives on
    other shards is collected while the CSR blocks rotate around the ring
    (the :func:`~repro_torch.dist.overlap.ring_schedule` wiring — after
    hop ``s`` rank ``me`` holds shard ``(me - s) % S``'s block, so ``S``
    hops see every row; at one rank no hop moves anything).  Membership
    checks binary-search the gathered, per-row sorted segments.  A rank
    runs its block in chunks of the executor's row chunk, each with its
    own ring rotation, so the gathered ``(rows, width)`` tiles stay
    chunk-sized.  The returned function maps ``(frontier, mult)`` to the
    global weighted count — frontiers of any length (the wrapper pads
    to the rank multiple and zeroes the padding's ``mult``).

    ``sgdb.n_shards`` must equal the group's size, and the ring rotates
    over one group: a sequence of groups (the JAX function's several
    mesh axes) is refused.  Unary bitmaps are not supported (pre-filter
    the frontier; the replicated step has the same contract).
    """
    if isinstance(group, (list, tuple)):
        raise ValueError("the sharded-CSR ring rotates over exactly one "
                         "process group; make one with dist.new_group")
    dev = _step_device(device, "spmd_sharded_join_step")
    check_group_device(group, dev, "spmd_sharded_join_step")
    n_dev, _ = ring_schedule(group)
    if sgdb.n_shards != n_dev:
        raise ValueError(f"graph is sharded {sgdb.n_shards} ways but the "
                         f"process group has {n_dev} ranks")
    if level_kw.get("n_unary", 0):
        raise ValueError("unary bitmaps are replicated; pre-filter the "
                         "frontier instead")
    me = dist.get_rank(group)
    blocks = sgdb.device_blocks()
    bounds = [int(b) for b in blocks["bounds"]]
    home_iptr = torch.from_numpy(blocks["indptr"][me]).to(dev)
    home_idx = torch.from_numpy(blocks["indices"][me]).to(dev)
    ln = home_iptr.shape[0] - 1
    le = home_idx.shape[0]
    probe_cols = tuple(level_kw["probe_cols"])
    lower_cols = tuple(level_kw.get("lower_cols", ()))
    upper_cols = tuple(level_kw.get("upper_cols", ()))
    width = int(level_kw["width"])
    needs_degree = bool(level_kw.get("needs_degree", False))
    n_iter = int(math.ceil(math.log2(max(2, width)))) + 1
    chunk = executor_geometry(0, width=width)[1]
    sentinel = sgdb.n_nodes              # > any vertex id
    j = torch.arange(width, dtype=torch.int32, device=dev)

    def ring_deg_tiles(xs, want_tiles: bool):
        """Rotate the CSR blocks; collect degree (and segment tiles) for
        every vertex in ``xs``, whichever shard owns it."""
        degs = torch.zeros(xs.shape, dtype=torch.int32, device=dev)
        tiles = (torch.full(xs.shape + (width,), sentinel,
                            dtype=torch.int32, device=dev)
                 if want_tiles else None)
        cur_iptr, cur_idx = home_iptr, home_idx
        for s in range(n_dev):
            sid = (me - s) % n_dev
            lo, hi = bounds[sid], bounds[sid + 1]
            mine = (xs >= lo) & (xs < hi)
            li = (xs - lo).clamp(0, max(0, ln - 1)).long()
            st = cur_iptr[li]
            dg = cur_iptr[li + 1] - st
            degs = torch.where(mine, dg, degs)
            if want_tiles:
                tl = cur_idx[(st[..., None] + j).clamp(0, le - 1).long()]
                tl = torch.where(j < dg[..., None], tl, sentinel)
                tiles = torch.where(mine[..., None], tl, tiles)
            if s < n_dev - 1:
                cur_iptr = ring_hop(cur_iptr, group)
                if want_tiles:
                    cur_idx = ring_hop(cur_idx, group)
        return degs, tiles

    def chunk_count(f, m):
        xs = f[:, list(probe_cols)]                              # (C, P)
        degs, tiles = ring_deg_tiles(xs, True)
        p = torch.argmin(degs, dim=1)
        cand = tiles.gather(1, p[:, None, None].expand(-1, 1, width))[:, 0]
        keep = j[None, :] < degs.gather(1, p[:, None])
        base = (torch.arange(f.shape[0], dtype=torch.int32, device=dev)
                * width)[:, None]
        for ci in range(len(probe_cols)):
            # each row's check segment sits sorted at [ci, :deg) of its
            # tile, cut at the tile's width as the JAX step's whole-tile
            # search cuts it: one segmented binary search over the flat
            # tiles, never past a row's own tile
            end = base + degs[:, ci:ci + 1].clamp(max=width)
            _, found = kops.searchsorted_segments(
                tiles[:, ci].reshape(-1), base, end, cand, n_iter)
            keep &= found | (p == ci)[:, None]
        for col in lower_cols:
            keep &= cand > f[:, col][:, None]
        for col in upper_cols:
            keep &= cand < f[:, col][:, None]
        if needs_degree:
            # second ring pass, starting again from the home blocks
            degc, _ = ring_deg_tiles(cand.clamp(0, sentinel - 1), False)
            keep &= (degc > 0) & (cand < sentinel)
        return (keep.sum(dim=1, dtype=torch.int64) * m).sum()

    def step(frontier, mult) -> int:
        fr, ml = _pad_block(frontier, mult, n_dev, me)
        fr = _on(fr, dev, torch.int32, "frontier")
        ml = _on(ml, dev, torch.int64, "mult")
        total = torch.zeros((), dtype=torch.int64, device=dev)
        for s in range(0, fr.shape[0], chunk):
            total += chunk_count(fr[s:s + chunk], ml[s:s + chunk])
        dist.all_reduce(total, group=group)
        return int(total)

    step.n_shards = n_dev
    return step
