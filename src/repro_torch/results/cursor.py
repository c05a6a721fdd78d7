"""Chunked, bounded-memory streaming of join output in fixed-size pages
(the port of ``repro.results.cursor``).

Flat enumeration of a worst-case-optimal join materializes the full
cross-product of the final GAO level — the one thing the counting path
carefully avoids.  :class:`ResultCursor` keeps that property for
enumeration: it materializes only the *penultimate* frontier, sorts it
lexicographically once, then re-enters the final VLFTJ level
(``VLFTJ.last_level_extensions``, on the executor's device and with its
check mode) one frontier chunk at a time, flattening each chunk with
:func:`repro_torch.results.expand.segment_expand` and handing out pages
of ``page_rows`` rows.

Expansion chunks are sized by *measured* fanout: a first counting pass
(``VLFTJ.last_level_counts``, run at the executor's full chunk width)
yields per-row extension counts, and chunk boundaries are cut where
cumulative counts cross ``page_rows``.  One chunk therefore contributes
at most ``max(width, page_rows)`` buffered rows (a single row can emit
up to ``width``), and pulling stops as soon as a page is covered, so the
tail buffer never exceeds ``page_rows + max(width, page_rows)`` rows
(``width`` = the executor's padded candidate-tile width, a data
constant) — tracked in ``stats['peak_buffer_rows']`` and asserted in the
tests.  Both passes pad to fixed geometries.  A *dense* final level (no
bound edge neighbor — rare; GAO choice avoids it) has domain-sized
fanout instead, so it streams one frontier row at a time with its
extension run sliced to the page size, keeping the same bound.
Concatenating every page reproduces ``VLFTJ.enumerate`` exactly: the
frontier is lex-sorted, per-row extensions ascend, so pages arrive in
global lexicographic order.

With a :class:`repro_torch.obs.DeviceProfile` active, each expansion
is one call of the ``segment_outer`` family, timed on the host clock
(the expansion is host numpy), as the JAX package names the same hook.

``from_rows`` / ``from_blocks`` wrap already-materialized output (the
non-VLFTJ engines) in the same page interface, so every engine pages
the same way.
"""
from __future__ import annotations

import time
from typing import Iterable, Iterator

import numpy as np

from ..core.vlftj import VLFTJ
from .expand import segment_expand


def _segment_expand(prefix, counts, vals):
    """``segment_expand`` with the device-profile wall hook — two clock
    reads when a profile is active, nothing otherwise."""
    # lazy: repro_torch.obs imports core at package level
    from ..obs.profile import current_profile
    prof = current_profile()
    if prof is None:
        return segment_expand(prefix, counts, vals)
    t0 = time.perf_counter()
    out = segment_expand(prefix, counts, vals)
    prof.record_jit_call()
    prof.record_kernel("segment_outer", time.perf_counter() - t0)
    return out


class ResultCursor:
    """Page iterator over join output in the source's column order.

    ``take(n)`` returns the next ``n`` rows (fewer at the end, an empty
    ``(0, k)`` array once drained); ``next_page()`` returns
    ``take(page_rows)`` or ``None`` when exhausted; iteration yields
    pages.  ``vars`` names the columns; rows are int64 and arrive in
    lexicographic order.

    Args:
        executor: the :class:`~repro_torch.core.vlftj.VLFTJ` instance to
            stream from (its plan fixes the column order ``vars``).
        page_rows: rows per page — also the tail-buffer bound knob (the
            buffer never exceeds ``page_rows + max(width, page_rows)``
            rows).
        seeds: optional pre-bindings of the first GAO variable.
        frontier: optional *resume* frontier — an ``(n, w)`` int32 array
            of partial bindings with ``w <= k - 1`` GAO columns already
            bound, e.g. the state a ``level_callback`` suspended.  The
            cursor continues the join from level ``w`` instead of level
            0; with ``w == k - 1`` (the penultimate frontier) no
            interior level runs at all and paging starts immediately.
        skip_rows: drop this many leading output rows before serving
            any — the other half of snapshot resume: a stream that
            already delivered ``n`` rows restarts with ``skip_rows=n``
            and continues row-for-row where it left off (the block
            stream is deterministic, so the skip is exact).

    Raises:
        ValueError: ``page_rows < 1``.
        Whatever the executor's plan ``level_callback`` raises while
            the first ``take``/``next_page`` call is still building the
            penultimate frontier (interior levels run lazily on first
            pull); the state it carries resumes via ``frontier=``.

    Example::

        cur = ResultCursor(VLFTJ(q, gdb, plan=plan), page_rows=512)
        first = cur.take(512)
        # ... suspend: remember cur.penultimate / cur.rows_emitted ...
        cur2 = ResultCursor(VLFTJ(q, gdb, plan=plan), page_rows=512,
                            frontier=cur.penultimate,
                            skip_rows=cur.rows_emitted)
        rest = [p for p in cur2]    # continues after `first`, exactly
    """

    def __init__(self, executor: VLFTJ, page_rows: int = 1024,
                 seeds: np.ndarray | None = None,
                 frontier: np.ndarray | None = None,
                 skip_rows: int = 0):
        if page_rows < 1:
            raise ValueError("page_rows must be >= 1")
        #: the live VLFTJ this cursor streams from (None for wrapped
        #: sources) — its ``stats`` carry the kernel counters a trace or
        #: metrics snapshot harvests after paging
        self.executor: VLFTJ | None = executor
        self.vars = executor.gao
        self.page_rows = page_rows
        self.stats = {"pages": 0, "rows": 0, "chunks": 0, "count_chunks": 0,
                      "peak_buffer_rows": 0, "frontier_rows": 0}
        self._k = len(executor.gao)
        self._buf: list[np.ndarray] = []
        self._buffered = 0
        self._drained = False
        self.exhausted = False
        #: the lex-sorted penultimate frontier, available once the first
        #: page is pulled (None for single-level plans and wrapped
        #: sources) — what a mid-paging suspension snapshots
        self.penultimate: np.ndarray | None = None
        self._skip = int(skip_rows)
        blocks = self._vlftj_blocks(executor, seeds, frontier)
        self._blocks: Iterator[np.ndarray] = (
            blocks if not self._skip else self._skipped(blocks))

    # -- alternate sources ---------------------------------------------------
    @classmethod
    def from_blocks(cls, columns: tuple[str, ...],
                    blocks: Iterable[np.ndarray],
                    page_rows: int = 1024) -> "ResultCursor":
        """Cursor over an iterable of row blocks already in lex order."""
        cur = cls.__new__(cls)
        cur.executor = None
        cur.vars = tuple(columns)
        cur.page_rows = page_rows
        cur.stats = {"pages": 0, "rows": 0, "chunks": 0, "count_chunks": 0,
                     "peak_buffer_rows": 0, "frontier_rows": 0}
        cur._k = len(cur.vars)
        cur._buf = []
        cur._buffered = 0
        cur._drained = False
        cur.exhausted = False
        cur.penultimate = None
        cur._skip = 0
        cur._blocks = iter(blocks)
        return cur

    @classmethod
    def from_rows(cls, columns: tuple[str, ...], rows: np.ndarray,
                  page_rows: int = 1024) -> "ResultCursor":
        """Cursor over one materialized (lex-sorted) row array."""
        rows = np.asarray(rows, dtype=np.int64).reshape(-1, len(columns))
        return cls.from_blocks(columns, [rows] if rows.shape[0] else [],
                               page_rows)

    # -- the VLFTJ streaming source ------------------------------------------
    def _skipped(self, blocks: Iterator[np.ndarray]) -> Iterator[np.ndarray]:
        """Drop the first ``skip_rows`` output rows (snapshot resume)."""
        left = self._skip
        for block in blocks:
            if left >= block.shape[0]:
                left -= block.shape[0]
                continue
            yield block[left:] if left else block
            left = 0

    def _vlftj_blocks(self, ex: VLFTJ, seeds: np.ndarray | None,
                      resume: np.ndarray | None = None
                      ) -> Iterator[np.ndarray]:
        k = len(ex.plan)
        if k == 1:
            vals = (np.asarray(seeds) if seeds is not None
                    else ex._domain_values(ex.plan[0]))
            vals = np.sort(vals.astype(np.int64))
            self.stats["frontier_rows"] = int(vals.shape[0])
            for s in range(0, vals.shape[0], self.page_rows):
                yield vals[s:s + self.page_rows, None]
            return
        if resume is not None:
            seed_frontier = np.asarray(resume, dtype=np.int32)
        elif seeds is not None:
            seed_frontier = np.asarray(seeds, dtype=np.int32)[:, None]
        else:
            seed_frontier = None
        frontier = np.asarray(
            ex._run(count_only=False, frontier=seed_frontier,
                    max_levels=k - 1), dtype=np.int64)
        if frontier.shape[0] == 0:
            return
        frontier = frontier[np.lexsort(frontier.T[::-1])]
        self.penultimate = frontier
        self.stats["frontier_rows"] = int(frontier.shape[0])
        if not ex.plan[-1].edge_sources:
            # dense final level (no bound edge neighbor): the fanout is
            # the unary-filtered *domain*, not the adjacency width, so
            # chunking by rows cannot bound the buffer — stream one row
            # at a time and slice its extension run to the page size
            for i in range(frontier.shape[0]):
                counts, vals = ex.last_level_extensions(
                    frontier[i:i + 1].astype(np.int32))
                self.stats["chunks"] += 1
                for s in range(0, vals.shape[0], self.page_rows):
                    part = vals[s:s + self.page_rows]
                    yield _segment_expand(
                        frontier[i:i + 1],
                        np.array([part.shape[0]], dtype=np.int64), part)
            return
        # Two interleaved passes, both under the buffer bound.  Per
        # counting window (the executor's full chunk width — the cheap
        # Idea-8 path), per-row final-level counts are measured and
        # expansion chunks are cut where cumulative counts cross
        # page_rows (one overfull row may emit up to `width`).  Sizing
        # chunks by measured fanout instead of the worst-case tile
        # width is what keeps the dispatch count at ~output/page_rows
        # rather than frontier/(page_rows/width) — the ~10x small-page
        # throughput penalty this replaces.  Counting stays lazy, one
        # window ahead of the pages actually pulled, so a client that
        # stops after the first page pays one counting dispatch, not
        # the whole frontier.  Every dispatch is padded to a fixed
        # geometry (two shapes in all: the counting window and the
        # expansion chunk).
        F = frontier.shape[0]
        cstep = ex.chunk_rows
        cap = max(1, min(ex.chunk_rows, self.page_rows))
        for w0 in range(0, F, cstep):
            wreal = min(cstep, F - w0)
            window = frontier[w0:w0 + wreal]
            wpad = (window if wreal == cstep
                    else np.pad(window, ((0, cstep - wreal), (0, 0))))
            wvalid = np.zeros(cstep, dtype=bool)
            wvalid[:wreal] = True
            counts = ex.last_level_counts(
                wpad.astype(np.int32), wvalid)[:wreal]
            self.stats["count_chunks"] += 1
            cum = np.concatenate([[0], np.cumsum(counts)])
            i = 0
            while i < wreal:
                j = int(np.searchsorted(cum, cum[i] + self.page_rows,
                                        side="right")) - 1
                j = min(max(j, i + 1), i + cap, wreal)
                real = j - i
                chunk = window[i:j]
                if real < cap:
                    chunk = np.pad(chunk, ((0, cap - real), (0, 0)))
                valid = np.zeros(cap, dtype=bool)
                valid[:real] = True
                ccounts, vals = ex.last_level_extensions(
                    chunk.astype(np.int32), valid)
                self.stats["chunks"] += 1
                if vals.shape[0]:
                    yield _segment_expand(chunk[:real], ccounts[:real],
                                           vals)
                i = j

    # -- paging --------------------------------------------------------------
    def take(self, n: int | None = None) -> np.ndarray:
        """The next ``n`` rows (default ``page_rows``); empty when drained."""
        n = self.page_rows if n is None else n
        while self._buffered < n and not self._drained:
            try:
                block = next(self._blocks)
            except StopIteration:
                self._drained = True
                break
            if block.shape[0]:
                self._buf.append(block)
                self._buffered += int(block.shape[0])
                self.stats["peak_buffer_rows"] = max(
                    self.stats["peak_buffer_rows"], self._buffered)
        if self._buf:
            cat = (self._buf[0] if len(self._buf) == 1
                   else np.concatenate(self._buf, axis=0))
            out, rest = cat[:n], cat[n:]
            self._buf = [rest] if rest.shape[0] else []
            self._buffered = int(rest.shape[0])
        else:
            out = np.zeros((0, self._k), dtype=np.int64)
        self.stats["pages"] += 1
        self.stats["rows"] += int(out.shape[0])
        self.exhausted = self._drained and self._buffered == 0
        return out

    @property
    def rows_emitted(self) -> int:
        """Total output rows delivered so far, counting any resume skip
        — the ``rows_emitted`` a mid-paging snapshot records."""
        return self._skip + self.stats["rows"]

    def next_page(self) -> np.ndarray | None:
        """``take(page_rows)``, or ``None`` once the stream is exhausted."""
        page = self.take(self.page_rows)
        return page if page.shape[0] else None

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            page = self.next_page()
            if page is None:
                return
            yield page
