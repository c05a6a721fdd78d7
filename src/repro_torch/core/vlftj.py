"""Vectorized LeapFrog TrieJoin in PyTorch — the port of ``repro.core.vlftj``.

A *frontier* of partial bindings advances one GAO level per step:

  1. **probe**: per frontier row, pick the shortest adjacency segment among
     the row's bound edge-neighbors (the leapfrog "smallest iterator
     first" rule, chosen per row with vector ops);
  2. **candidates**: the probe segment's values, a (rows, W) padded tile;
  3. **checks**: every other edge constraint, by the row's check mode:
     segmented binary search (``bsearch``, the ``searchsorted_segments``
     kernel), its two-level form over a ``summary:<s>`` array
     (``bsearch2``), a gather-once tile compare of the check segment
     (``tile``, the ``tile_member_mask`` kernel), or, for rows whose
     bound sources are all hubs of a :class:`HybridGraphDB`, a bitset
     bit test (``bitset``, the ``bitset_member_mask`` kernel); ``auto``
     sends rows whose check segments fit ``tile_width`` to ``tile`` and
     the heavy tail to ``bsearch``.  Every unary predicate is a bitmap
     gather, every ``<`` filter a vector compare;
  4. **expand**: compact the surviving lanes into the next frontier.

The structure is the reference's: the level step runs on ``gdb.device``
and the frontier is host numpy at every level boundary (the
``level_callback`` contract hands it to the host).  Within a level the
group's frontier goes to the device once, chunks are sliced there, and
survivors are compacted there, so only the next frontier comes back.
The final level of a count never materializes: surviving candidates are
counted and dotted with row multiplicities, summed on the device.
Enumeration re-enters the final level chunk by chunk
(:meth:`VLFTJ.last_level_counts`, :meth:`VLFTJ.last_level_extensions`),
which ``results/`` pages through.  Counts are int64 throughout.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..kernels import ops as kops
from ..layers.sharding import take
from .device_graph import GraphDB
from .plan import (GraphStats, JoinPlan, LevelPlan, compile_levels,
                   executor_geometry)
from .query import Query

CHECK_MODES = ("bsearch", "bsearch2", "tile", "auto")

#: the JAX package's older name of the per-level compiler, which lives
#: in ``core.plan`` so the planner and the engine share one definition
compile_plan = compile_levels


def _expand_level(indptr, indices, bitmaps, frontier, mult, row_valid, *,
                  probe_cols, n_unary, lower_cols, upper_cols, width, n_iter,
                  count_only, needs_degree, unroll=False, check_mode="bsearch",
                  check_width=0, rotate_checks=False, summary=None,
                  summary_stride=128, n_iter2=9, rep_tag=None,
                  bitset_words=None, clamp_ids=True):
    """One GAO level for a frontier chunk.

    frontier: (C, n_bound) int32; mult: (C,) int64; row_valid: (C,) bool,
    all on one device.  Returns weighted counts (C,) int64 if
    ``count_only`` else ``(cand, keep)``, both (C, width).

    ``check_mode='bitset'`` (hybrid layout): every bound edge source in
    the chunk is a hub, so membership of a live lane (``j < deg_star``)
    is one gather into its ``bitset_words`` row plus a bit test;
    ``rep_tag`` maps vertex id to bitset row (the caller's bucketing
    guarantees tags >= 0 here).
    ``'tile'``: the check segment is gathered once and every live lane
    (``j < deg_star``) is compared with its first ``check_width`` values
    (the caller buckets rows so that segments fit, or accepts the
    truncation).
    ``'bsearch2'``: a first search over ``summary`` (every
    ``summary_stride``-th index, ``n_iter`` rounds), then ``n_iter2``
    rounds in the window it leaves.

    ``unroll`` is the JAX package's loop-unrolling switch, accepted and
    ignored (eager PyTorch has no loop to unroll).  ``clamp_ids`` gathers
    ``indptr`` at frontier ids clamped to [-L, L-1] (L = len(indptr)):
    JAX wraps a negative index once and clamps the rest, where PyTorch
    raises, so an id outside the graph reads what it reads in JAX.
    ``VLFTJ``, whose frontiers hold only vertex ids, turns it off.

    On DTensors (the WCOJ cells on a mesh) each chip expands its own
    frontier rows against the whole graph: the gathers are local
    (``layers.sharding.take``), the kernels' custom ops run under their
    sharding rules, and the caller's sum of the counts is a partial sum
    over the chips, reduced where the cell's output is laid out whole
    (as ``dist.sharded_join.spmd_join_step`` reduces it by hand).
    """
    m = indices.shape[0]
    dev = frontier.device
    if clamp_ids:
        n_ptr = indptr.shape[0]

        def at(ids):
            return take(indptr, ids.clamp(-n_ptr, n_ptr - 1))
    else:
        def at(ids):
            return take(indptr, ids)
    xs = frontier[:, list(probe_cols)]                        # (C, P)
    starts = at(xs)
    degs = at(xs + 1) - starts                                # (C, P)
    p = torch.argmin(degs, dim=1)                             # (C,)

    def sel(a):
        return a.gather(1, p[:, None])[:, 0]

    start_star = sel(starts)
    deg_star = sel(degs)

    j = torch.arange(width, dtype=torch.int32, device=dev)
    cand_idx = start_star[:, None] + j[None, :]
    cand = take(indices, cand_idx.clamp(0, max(0, m - 1)))    # (C, W)
    keep = (j[None, :] < deg_star[:, None]) & row_valid[:, None]

    # the tile and bitset checks test only the live lanes (0 for invalid
    # rows): keep already ANDs them, so no count changes
    lane_len = (torch.where(row_valid, deg_star, 0).to(torch.int32)
                if check_mode in ("tile", "bitset") else None)

    # membership checks against every other bound edge-neighbor's segment.
    # rotate_checks synthesizes exactly the P-1 non-probe sources per row
    # (rotating from the argmin) — no wasted self-check lanes.
    n_probe = len(probe_cols)
    if rotate_checks and n_probe > 1:
        check_sources = [
            (xs.gather(1, (p[:, None] + s) % n_probe)[:, 0], None)
            for s in range(1, n_probe)]
    else:
        check_sources = [(xs[:, ci], ci) for ci in range(n_probe)]
    for y, ci in check_sources:
        if check_mode == "bitset":
            found = kops.bitset_member_mask(bitset_words, rep_tag[y], cand,
                                            lane_len)
        else:
            lo = at(y)[:, None]
            hi = at(y + 1)[:, None]
            if check_mode == "tile":
                found = kops.tile_member_mask(indices, lo, hi, cand,
                                              check_width, lane_len)
            elif check_mode == "bsearch2":
                _, found = kops.searchsorted_segments_2level(
                    indices, summary, lo, hi, cand, stride=summary_stride,
                    n1=n_iter, n2=n_iter2)
            else:
                _, found = kops.searchsorted_segments(indices, lo, hi, cand,
                                                      n_iter)
        if ci is None:
            keep &= found
        else:
            keep &= found | (p == ci)[:, None]  # the probe needs no check

    n = bitmaps[0].shape[0] if n_unary else 0
    for b in range(n_unary):
        keep &= take(bitmaps[b], cand.clamp(0, n - 1))
    for col in lower_cols:
        keep &= cand > frontier[:, col][:, None]
    for col in upper_cols:
        keep &= cand < frontier[:, col][:, None]
    if needs_degree:
        keep &= (take(indptr, cand + 1) - take(indptr, cand)) > 0

    if count_only:
        return keep.sum(dim=1, dtype=torch.int64) * mult
    return cand, keep


def _filter_values(indptr, bitmaps, values, *, needs_degree):
    keep = torch.ones_like(values, dtype=torch.bool)
    for bm in bitmaps:
        keep &= bm[values]
    if needs_degree:
        keep &= (indptr[values + 1] - indptr[values]) > 0
    return keep


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    if t.shape[0] == rows:
        return t
    pad = t.new_zeros((rows - t.shape[0],) + tuple(t.shape[1:]))
    return torch.cat([t, pad])


class VLFTJ:
    """Host-orchestrated, device-vectorized LFTJ over a :class:`GraphDB`."""

    def __init__(self, query: Query, gdb: GraphDB,
                 gao: tuple[str, ...] | None = None,
                 chunk_rows: int = 8192,
                 elem_budget: int = 1 << 22,
                 width: int | None = None,
                 check_mode: str = "bsearch",
                 tile_width: int = 512,
                 rotate_checks: bool = False,
                 summary_stride: int = 128,
                 plan: JoinPlan | None = None):
        if check_mode not in CHECK_MODES:
            raise ValueError(f"unknown check_mode {check_mode!r}; "
                             f"options: {CHECK_MODES}")
        if plan is None:
            from .planner import plan_query
            plan = plan_query(query, GraphStats.of(gdb), engine="vlftj",
                              gao=gao)
        elif gao is not None and tuple(gao) != plan.gao:
            raise ValueError("both plan= and a conflicting gao= given")
        self.query = query
        self.gdb = gdb
        self.join_plan = plan
        self.gao = plan.gao
        self.plan = plan.levels or compile_levels(query, self.gao)
        self.n_iter = gdb.bsearch_iters
        self.width, self.chunk_rows = executor_geometry(
            gdb.max_degree, chunk_rows, elem_budget, width)
        # membership strategy: 'bsearch' (binary search), 'bsearch2' (its
        # two-level form), 'tile' (gather-once tile compare of the first
        # tile_width values of each check segment), 'auto' (rows whose
        # check segments fit tile_width take 'tile', the rest 'bsearch')
        self.check_mode = check_mode
        self.tile_width = tile_width
        self.rotate_checks = rotate_checks
        self.summary_stride = summary_stride
        if check_mode == "bsearch2":
            blocks = max(2, gdb.max_degree // summary_stride + 2)
            self.n_iter1 = int(math.ceil(math.log2(blocks))) + 1
            self.n_iter2 = int(math.ceil(math.log2(2 * summary_stride
                                                     + 2))) + 1
        # hybrid-layout routing: the planner's per-level representation
        # choice is honoured only when the GraphDB carries a bitset layout
        # (hubs occupy the renumbered id prefix)
        layout = getattr(gdb, "layout", None)
        self._n_hubs = int(layout.n_hubs) if layout is not None else 0
        lv = plan.level_layouts
        self.level_layouts = (lv if len(lv) == len(self.plan)
                              else ("array",) * len(self.plan))
        # the reference's stats namespace, key for key: scalar counters
        # plus per-GAO-level observations (level_rows: frontier size after
        # the level binds; level_wall_s: host wall time in the level;
        # level_paths: rows per check path).  ll_compiles stays 0: eager
        # PyTorch compiles nothing per frontier shape, so there is no
        # ahead-of-time cache for the final level to fill.
        self.stats = {"chunks": 0, "frontier_peak": 0, "candidates": 0,
                      "tile_rows": 0, "bsearch_rows": 0, "bitset_rows": 0,
                      "ll_compiles": 0, "ll_calls": 0, "rows_expanded": 0,
                      "level_rows": {}, "level_wall_s": {},
                      "level_paths": {}}

    # -- host helpers --------------------------------------------------------
    def _domain_values(self, lp: LevelPlan) -> np.ndarray:
        """Unary-filtered candidate domain for an edge-unconstrained var."""
        if lp.unary:
            base = min((self.gdb.unary[u] for u in lp.unary), key=len)
            values = np.asarray(base, dtype=np.int32)
        else:
            values = np.arange(self.gdb.n_nodes, dtype=np.int32)
        bitmaps = [self.gdb.dev(f"bitmap:{u}") for u in lp.unary]
        keep = _filter_values(
            self.gdb.dev("indptr"), bitmaps,
            torch.from_numpy(values).to(self.gdb.device),
            needs_degree=lp.needs_degree)
        return values[keep.cpu().numpy()]

    def _expand_dense(self, frontier, mult, lp, last_count):
        """A level with no bound edge neighbor: cross product with the
        (unary-filtered) domain.  Rare; GAO choice avoids it."""
        values = self._domain_values(lp)
        C = frontier.shape[0]
        if last_count and not lp.lower and not lp.upper:
            return None, None, int(mult.sum()) * values.shape[0]
        reps = np.repeat(np.arange(C), values.shape[0])
        vals = np.tile(values, C)
        ok = np.ones(vals.shape[0], dtype=bool)
        for col in lp.lower:
            ok &= vals > frontier[reps, col]
        for col in lp.upper:
            ok &= vals < frontier[reps, col]
        reps, vals = reps[ok], vals[ok]
        if last_count:
            return None, None, int(mult[reps].sum())
        nf = np.concatenate([frontier[reps], vals[:, None].astype(np.int32)],
                            axis=1)
        return nf, mult[reps], 0

    def _bucket(self, frontier, mult, lp, layout: str = "array"):
        """Bucket rows by membership strategy: representation tags first
        (hybrid layout), then degree (``check_mode='auto'``).

        When the plan marked this level ``'bitset'``/``'mixed'`` and the
        graph carries a layout, rows whose bound edge sources are *all*
        hubs take the bitset path; the rest take the configured array
        strategy.  Hubs are the renumbered id prefix, so the tag test is
        one compare.  Under ``'auto'``, rows whose bound sources all have
        degree <= ``tile_width`` take ``'tile'``, the rest ``'bsearch'``.
        """
        out = []
        if (layout != "array" and self._n_hubs and lp.edge_sources
                and len(lp.edge_sources) >= 2 and frontier.shape[0]):
            elig = (frontier[:, list(lp.edge_sources)]
                    < self._n_hubs).all(axis=1)
            if elig.any():
                self.stats["bitset_rows"] += int(elig.sum())
                out.append((frontier[elig], mult[elig], "bitset"))
                rest = ~elig
                frontier, mult = frontier[rest], mult[rest]
            if frontier.shape[0] == 0:
                return out
        if self.check_mode != "auto" or not lp.edge_sources:
            mode = (self.check_mode if self.check_mode in
                    ("tile", "bsearch2") else "bsearch")
            return out + [(frontier, mult, mode)]
        deg = self.gdb.csr.degrees
        maxdeg = np.max(deg[frontier[:, list(lp.edge_sources)]], axis=1)
        tile = maxdeg <= self.tile_width
        self.stats["tile_rows"] += int(tile.sum())
        self.stats["bsearch_rows"] += int((~tile).sum())
        if tile.any():
            out.append((frontier[tile], mult[tile], "tile"))
        if (~tile).any():
            out.append((frontier[~tile], mult[~tile], "bsearch"))
        return out

    # -- main loop -----------------------------------------------------------
    def _run(self, count_only: bool = True, frontier: np.ndarray | None = None,
             mult: np.ndarray | None = None, max_levels: int | None = None,
             start_level: int | None = None):
        """Advance the frontier through GAO levels ``< max_levels``
        (default: all).  ``start_level`` resumes mid-join from a frontier
        with that many columns bound (default: the frontier's width).
        The plan's ``level_callback`` runs at every interior level
        boundary with host ``(frontier, mult)``; it may return a
        replacement pair, or raise to suspend — a later
        ``_run(frontier=, mult=, start_level=)`` resumes without losing
        or repeating work."""
        gdb = self.gdb
        dev = gdb.device
        indptr, indices = gdb.dev("indptr"), gdb.dev("indices")
        # device profiling (repro_torch.obs.profile): resolved once per
        # run; None (the default) keeps every hook below a dead branch
        # (lazy import: repro_torch.obs imports core at package level)
        from ..obs.profile import current_profile
        prof = current_profile()
        n_levels = len(self.plan) if max_levels is None else max_levels
        lv_rows = self.stats["level_rows"]
        lv_wall = self.stats["level_wall_s"]
        lv_paths = self.stats["level_paths"]
        if frontier is None:
            t0 = time.perf_counter()
            frontier = self._domain_values(self.plan[0])[:, None]
            lv_rows[0] = int(frontier.shape[0])
            lv_wall[0] = round(time.perf_counter() - t0, 6)
        frontier = np.asarray(frontier, dtype=np.int32)
        if mult is None:
            mult = np.ones(frontier.shape[0], dtype=np.int64)
        start = frontier.shape[1] if start_level is None else start_level
        cb = self.join_plan.level_callback

        def boundary(level, frontier, mult):
            if cb is None or level >= n_levels - 1:
                return frontier, mult
            upd = cb(level, frontier, mult)
            if upd is None:
                return frontier, mult
            return (np.asarray(upd[0], dtype=np.int32),
                    np.asarray(upd[1], dtype=np.int64))

        total = 0
        for level in range(start, n_levels):
            t_lv = time.perf_counter()
            lp = self.plan[level]
            bitmaps = tuple(gdb.dev(f"bitmap:{u}") for u in lp.unary)
            last = level == n_levels - 1
            last_count = last and count_only
            self.stats["rows_expanded"] += int(frontier.shape[0])
            if not lp.edge_sources:
                frontier, mult, add = self._expand_dense(
                    frontier, mult, lp, last_count)
                total += add
                if last_count:
                    lv_rows[level] = int(total)
                    lv_wall[level] = (lv_wall.get(level, 0.0)
                                      + round(time.perf_counter() - t_lv, 6))
                    return total
                lv_rows[level] = int(frontier.shape[0])
                lv_wall[level] = (lv_wall.get(level, 0.0)
                                  + round(time.perf_counter() - t_lv, 6))
                if prof is not None:
                    prof.sample_memory(dev)
                frontier, mult = boundary(level, frontier, mult)
                continue
            C = frontier.shape[0]
            if C == 0:
                lv_rows[level] = 0
                break
            groups = self._bucket(frontier, mult, lp,
                                  layout=self.level_layouts[level])
            paths = lv_paths.setdefault(level, {})
            for gfrontier, _, mode in groups:
                paths[mode] = paths.get(mode, 0) + int(gfrontier.shape[0])
            new_rows, new_vals, new_mult = [], [], []
            level_total = torch.zeros((), dtype=torch.int64, device=dev)
            for gfrontier, gmult, mode in groups:
                gf = torch.from_numpy(np.ascontiguousarray(gfrontier)).to(dev)
                gm = torch.from_numpy(np.ascontiguousarray(gmult)).to(dev)
                kw = self._level_kw(lp, len(bitmaps), mode)
                for s in range(0, gf.shape[0], self.chunk_rows):
                    e = min(gf.shape[0], s + self.chunk_rows)
                    # pad a partial chunk only to the next power of two:
                    # kernel cost tracks live rows, and the set of chunk
                    # shapes stays at log2(chunk_rows)
                    crows = min(self.chunk_rows,
                                max(8, 1 << (e - s - 1).bit_length()))
                    fchunk = _pad_rows(gf[s:e], crows)
                    mchunk = _pad_rows(gm[s:e], crows)
                    rv = torch.arange(crows, device=dev) < (e - s)
                    self.stats["chunks"] += 1
                    self.stats["candidates"] += crows * self.width
                    args = (indptr, indices, bitmaps, fchunk, mchunk, rv)
                    # kernel-wall bracket: CUDA events on the card (read
                    # at the level boundary, where the loop waits for
                    # the device anyway), the host clock on the CPU
                    mark = None if prof is None else prof.kernel_mark(dev)
                    if last_count:
                        level_total += _expand_level(
                            *args, count_only=True, **kw).sum()
                    else:
                        cand, keep = _expand_level(*args, count_only=False,
                                                   **kw)
                        rows, cols = torch.nonzero(keep, as_tuple=True)
                        new_rows.append(fchunk[rows])
                        new_vals.append(cand[rows, cols])
                        new_mult.append(mchunk[rows])
                    if prof is not None:
                        prof.record_jit_call()
                        prof.record_kernel_since(
                            "intersect_bitset" if mode == "bitset"
                            else "intersect", mark, dev)
            if last_count:
                total += int(level_total)
                lv_rows[level] = int(total)
                lv_wall[level] = (lv_wall.get(level, 0.0)
                                  + round(time.perf_counter() - t_lv, 6))
                if prof is not None:
                    prof.settle()
                    prof.sample_memory(dev)
                return total
            k = frontier.shape[1]
            frontier = torch.cat(
                [torch.cat(new_rows) if new_rows else
                 torch.zeros((0, k), dtype=torch.int32, device=dev),
                 (torch.cat(new_vals)[:, None] if new_vals else
                  torch.zeros((0, 1), dtype=torch.int32, device=dev))],
                dim=1).cpu().numpy()
            mult = (torch.cat(new_mult).cpu().numpy() if new_mult
                    else np.zeros(0, np.int64))
            # record before the boundary callback: a budget callback may
            # raise (preemption) and the observation must survive it
            lv_rows[level] = int(frontier.shape[0])
            lv_wall[level] = (lv_wall.get(level, 0.0)
                              + round(time.perf_counter() - t_lv, 6))
            if prof is not None:
                # the frontier is on the host: every bracket has ended
                prof.settle()
                prof.sample_memory(dev)
            frontier, mult = boundary(level, frontier, mult)
            self.stats["frontier_peak"] = max(self.stats["frontier_peak"],
                                              frontier.shape[0])
        if count_only:
            return int(mult.sum())
        return frontier

    def _level_kw(self, lp: LevelPlan, n_unary: int, mode: str) -> dict:
        """The level step's keywords for one check mode."""
        kw = dict(probe_cols=lp.edge_sources, n_unary=n_unary,
                  lower_cols=lp.lower, upper_cols=lp.upper, width=self.width,
                  n_iter=self.n_iter, needs_degree=lp.needs_degree,
                  check_mode=mode,
                  check_width=self.tile_width if mode == "tile" else 0,
                  rotate_checks=self.rotate_checks, clamp_ids=False)
        if mode == "bsearch2":
            kw.update(n_iter=self.n_iter1, n_iter2=self.n_iter2,
                      summary=self.gdb.dev(f"summary:{self.summary_stride}"),
                      summary_stride=self.summary_stride)
        elif mode == "bitset":
            kw.update(rep_tag=self.gdb.dev("rep_tag"),
                      bitset_words=self.gdb.dev("bitset_words"))
        return kw

    # -- enumeration support -------------------------------------------------
    def last_level_counts(self, frontier: np.ndarray,
                          row_valid: np.ndarray | None = None) -> np.ndarray:
        """Surviving final-level extension counts per penultimate-frontier
        row (unit multiplicity), (C,) int64 — the cheap pass the cursor
        sizes its expansion chunks by.  Same constraints as
        :meth:`last_level_extensions`."""
        lp = self.plan[-1]
        frontier = np.asarray(frontier, dtype=np.int32)
        C = frontier.shape[0]
        if row_valid is None:
            row_valid = np.ones(C, dtype=bool)
        if C == 0:
            return np.zeros(0, dtype=np.int64)
        if not lp.edge_sources:
            counts, _ = self.last_level_extensions(frontier, row_valid)
            return counts
        return self._final_level_call(frontier, row_valid, count_only=True)

    def last_level_extensions(self, frontier: np.ndarray,
                              row_valid: np.ndarray | None = None
                              ) -> tuple[np.ndarray, np.ndarray]:
        """Surviving final-level extensions for one penultimate-frontier
        chunk: ``(counts (C,), values (counts.sum(),))``, both int64, each
        row's values ascending (CSR adjacencies are sorted).  The check
        mode is the executor's, except that ``'auto'`` runs as
        ``'bsearch'``: its degree bucketing reorders rows, which would
        break the row-aligned counts the cursor pages by."""
        lp = self.plan[-1]
        frontier = np.asarray(frontier, dtype=np.int32)
        C = frontier.shape[0]
        if row_valid is None:
            row_valid = np.ones(C, dtype=bool)
        if C == 0:
            return (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64))
        if not lp.edge_sources:
            # dense level: per-row cross product with the sorted domain
            values = np.sort(self._domain_values(lp))
            counts = np.zeros(C, dtype=np.int64)
            out: list[np.ndarray] = []
            for r in range(C):
                if not row_valid[r]:
                    continue
                vals = values
                for col in lp.lower:
                    vals = vals[vals > frontier[r, col]]
                for col in lp.upper:
                    vals = vals[vals < frontier[r, col]]
                counts[r] = vals.shape[0]
                out.append(vals)
            flat = (np.concatenate(out) if out
                    else np.zeros(0, dtype=np.int64))
            return counts, flat.astype(np.int64)
        return self._final_level_call(frontier, row_valid, count_only=False)

    def _final_level_call(self, frontier: np.ndarray, row_valid: np.ndarray,
                          count_only: bool):
        """Run the final level for one frontier chunk on the device:
        per-row counts (C,) int64 if ``count_only``, else ``(counts,
        values)`` with the surviving values compacted on the device in
        row-major order.  ``ll_calls`` counts these calls."""
        lp = self.plan[-1]
        gdb = self.gdb
        dev = gdb.device
        bitmaps = tuple(gdb.dev(f"bitmap:{u}") for u in lp.unary)
        mode = self.check_mode if self.check_mode in ("tile", "bsearch2") \
            else "bsearch"
        C = frontier.shape[0]
        args = (gdb.dev("indptr"), gdb.dev("indices"), bitmaps,
                torch.from_numpy(np.ascontiguousarray(frontier)).to(dev),
                torch.ones(C, dtype=torch.int64, device=dev),
                torch.from_numpy(np.ascontiguousarray(row_valid)).to(dev))
        self.stats["ll_calls"] += 1
        kw = self._level_kw(lp, len(bitmaps), mode)
        from ..obs.profile import current_profile
        prof = current_profile()
        mark = None if prof is None else prof.kernel_mark(dev)
        if count_only:
            out = (_expand_level(*args, count_only=True, **kw),)
        else:
            cand, keep = _expand_level(*args, count_only=False, **kw)
            out = (keep.sum(dim=1, dtype=torch.int64),
                   cand[keep].to(torch.int64))
        if prof is not None:
            prof.record_jit_call()
            prof.record_kernel_since("intersect", mark, dev)
        out = tuple(t.cpu().numpy() for t in out)
        if prof is not None:
            prof.settle()
        return out[0] if count_only else out

    # -- public API ----------------------------------------------------------
    def count(self) -> int:
        return int(self._run(count_only=True))

    def enumerate(self, limit: int | None = None,
                  seeds: np.ndarray | None = None) -> np.ndarray:
        """All output tuples: int64, columns in GAO order
        (``self.output_vars``), rows lexicographically sorted; ``limit``
        truncates after the ordering.  ``seeds`` pre-binds the first GAO
        variable."""
        frontier = None if seeds is None \
            else np.asarray(seeds, dtype=np.int32)[:, None]
        rows = np.asarray(self._run(count_only=False, frontier=frontier),
                          dtype=np.int64)
        if rows.shape[0] == 0:
            return np.zeros((0, len(self.plan)), dtype=np.int64)
        rows = rows[np.lexsort(rows.T[::-1])]
        return rows if limit is None else rows[:limit]

    @property
    def output_vars(self) -> tuple[str, ...]:
        """Column order of :meth:`enumerate` (the plan's GAO)."""
        return self.gao

    # -- suspend / resume ----------------------------------------------------
    def advance(self, frontier: np.ndarray | None = None,
                mult: np.ndarray | None = None,
                start_level: int | None = None,
                max_levels: int | None = None) -> np.ndarray:
        """Advance a partial-binding frontier through GAO levels and
        return the ``(rows', max_levels)`` int64 frontier of surviving
        bindings (``None`` frontier: start from the level-0 domain;
        ``None`` mult: ones; ``None`` max_levels: all levels).  Raises
        whatever the plan's ``level_callback`` raises."""
        out = self._run(count_only=False, frontier=frontier, mult=mult,
                        start_level=start_level, max_levels=max_levels)
        return np.asarray(out, dtype=np.int64)

    def resume_count(self, frontier: np.ndarray, mult: np.ndarray,
                     start_level: int | None = None) -> int:
        """Finish a suspended count from its ``(frontier, mult)`` state:
        the weighted count of all completions of the partial bindings."""
        return int(self._run(
            count_only=True,
            frontier=np.asarray(frontier, dtype=np.int32),
            mult=np.asarray(mult, dtype=np.int64),
            start_level=start_level))

    def seeded_count(self, seed_values: np.ndarray,
                     seed_mult: np.ndarray) -> int:
        """Count with the first GAO variable pre-bound and weighted (the
        hybrid engine seeds the clique part with path-part counts)."""
        return int(self._run(
            count_only=True,
            frontier=np.asarray(seed_values, dtype=np.int32)[:, None],
            mult=np.asarray(seed_mult, dtype=np.int64)))


def vlftj_count(query: Query, gdb: GraphDB,
                gao: tuple[str, ...] | None = None, **kw) -> int:
    return VLFTJ(query, gdb, gao, **kw).count()
