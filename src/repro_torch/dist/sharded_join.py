"""Sharded worst-case-optimal join execution (the port of
``repro.dist.sharded_join``).

Two granularities of parallelism, matching the paper's evaluation setup:

* :func:`spmd_join_step` / :func:`spmd_spmv_step` — rank-level SPMD over
  a ``torch.distributed`` process group.  Every rank is handed the same
  global arrays (as every JAX device sees the global array of a
  ``shard_map``) and takes its own contiguous block of the frontier (or
  edge list); it runs the *same* expansion level (``vlftj._expand_level``,
  reused verbatim — the kernel never learns it is distributed) against a
  replicated CSR, and one ``all_reduce`` folds the per-rank counts.
  Binding-space sharding means no shuffle: a partial binding's whole
  subtree lives on the rank that owns the seed row.
* :class:`PartitionedJoin` — host-level static over-partitioning (the
  granularity factor).  The first GAO level's domain is dealt into
  ``n_workers x granularity`` cost-balanced parts
  (:func:`repro_torch.core.plan.partition_first_level`); parts go to
  workers with the same deterministic deal as
  :func:`repro_torch.train.stragglers.reassign_shards`, so a dead
  worker's parts can be re-dealt without recomputing anything.

**Mesh to process group.**  The JAX functions take ``(mesh, ...,
axis_names=None)``; these take ``(group, ...)``, ``group=None`` meaning
the default group.  A mesh's axes flatten into the ranks of one group
(rank ``r`` holds the block ``PartitionSpec(axes)`` gives device ``r``);
a subset of axes is a subgroup the caller makes with
``dist.new_group``.  A step runs on ``device`` (the card unless the
caller asks for the CPU), and the group's backend must be the one for
that device: NCCL for ``cuda``, gloo for ``cpu``.

**Chunked blocks.**  XLA fuses the reference's one ``_expand_level``
over a whole shard; eager PyTorch would materialise every ``(rows,
width)`` intermediate of it (soc-Slashdot0811's triangle level is
889,427 rows at width 2048).  So a rank runs its block in chunks of the
executor's row chunk (``executor_geometry``), sums on the device, and
all-reduces once.  The count is the same.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch
import torch.distributed as dist

from ..core.device_graph import GraphDB
from ..core.plan import JoinPlan, executor_geometry, partition_first_level
from ..core.query import Query
from ..core.vlftj import VLFTJ, _expand_level
from ..device import check_group_device, resolve_device
from ..train.stragglers import reassign_shards
from .pool import WorkerPool


def _step_device(device, what: str) -> torch.device:
    """``device`` for an SPMD step, with the card's index made explicit
    (``cuda`` -> ``cuda:<current>``) so tensors compare equal to it."""
    dev = resolve_device(device, what)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _on(x, dev: torch.device, dtype: torch.dtype | None,
        what: str) -> torch.Tensor:
    """``x`` as a tensor on ``dev`` (of ``dtype``; None keeps its own):
    host arrays are copied there; a tensor on another device raises (no
    silent staging through the host)."""
    if isinstance(x, torch.Tensor):
        if x.device != dev:
            raise ValueError(f"{what} is on {x.device}, the step runs on "
                             f"{dev}")
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(np.asarray(x)).to(device=dev, dtype=dtype)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pad_block(frontier, mult, n_shards: int, rank: int
               ) -> tuple[np.ndarray | torch.Tensor, np.ndarray | torch.Tensor]:
    """This rank's contiguous block of the frontier padded to a multiple
    of ``n_shards`` rows; the padding's ``mult`` is zero."""
    rows = int(frontier.shape[0])
    pad = (-rows) % n_shards
    if pad:
        if isinstance(frontier, torch.Tensor):
            frontier = torch.cat([frontier, frontier.new_zeros(
                (pad, frontier.shape[1]))])
        else:
            frontier = np.concatenate([np.asarray(frontier), np.zeros(
                (pad, frontier.shape[1]), dtype=np.int32)])
        if isinstance(mult, torch.Tensor):
            mult = torch.cat([mult, mult.new_zeros(pad)])
        else:
            mult = np.concatenate([np.asarray(mult, dtype=np.int64),
                                   np.zeros(pad, dtype=np.int64)])
    block = (rows + pad) // n_shards
    lo = rank * block
    return frontier[lo:lo + block], mult[lo:lo + block]


def spmd_join_step(group, level_kw: dict, plan: JoinPlan | None = None,
                   device: torch.device | str = "cuda"):
    """Build a rank-sharded expansion-level counter over ``group``.

    ``level_kw`` holds the static arguments of ``vlftj._expand_level``
    (probe_cols, lower_cols, width, n_iter, ...).  The returned function
    maps ``(indptr, indices, frontier, mult)`` to the global weighted
    count, a 0-d int64 tensor on ``device``, the same on
    every rank: CSR replicated, frontier/mult split into contiguous rank
    blocks.

    Frontiers of any length are accepted: the wrapper pads rows to the
    rank-count multiple and zeroes the padding's ``mult`` itself.  When
    ``plan`` carries a :attr:`~repro_torch.core.plan.JoinPlan.level_callback`
    (``dist.rebalance.FrontierRebalancer``), the callback runs on the
    host frontier first, so a skew-triggered re-deal can reorder rows
    into cost-balanced rank blocks before the dispatch.
    """
    dev = _step_device(device, "spmd_join_step")
    check_group_device(group, dev, "spmd_join_step")
    n_shards = dist.get_world_size(group)
    rank = dist.get_rank(group)
    kw = dict(level_kw)
    kw.setdefault("count_only", True)
    chunk = executor_geometry(0, width=int(kw["width"]))[1]
    callback = getattr(plan, "level_callback", None)

    def step(indptr, indices, frontier, mult):
        if callback is not None:
            fr, ml = _host(frontier), _host(mult)
            # callback convention (VLFTJ._run): `level` is the level
            # just expanded, so its frontier has level+1 bound columns
            # and the callback prices levels[level+1] — the level this
            # step is about to dispatch
            upd = callback(fr.shape[1] - 1, fr, ml)
            if upd is not None:
                frontier, mult = upd
        fr, ml = _pad_block(frontier, mult, n_shards, rank)
        iptr = _on(indptr, dev, torch.int32, "indptr")
        idx = _on(indices, dev, torch.int32, "indices")
        fr = _on(fr, dev, torch.int32, "frontier")
        ml = _on(ml, dev, torch.int64, "mult")
        total = torch.zeros((), dtype=torch.int64, device=dev)
        for s in range(0, fr.shape[0], chunk):
            f = fr[s:s + chunk]
            rv = torch.ones(f.shape[0], dtype=torch.bool, device=dev)
            total += _expand_level(iptr, idx, (), f, ml[s:s + chunk], rv,
                                   **kw).sum()
        dist.all_reduce(total, group=group)
        return total

    step.n_shards = n_shards
    return step


def spmd_spmv_step(group, n_nodes: int, device: torch.device | str = "cuda"):
    """Edge-sharded counting SpMV (the #Minesweeper message pass, Idea 8).

    The returned function maps ``(indices, src_ids, c)`` to
    ``y[v] = sum_{(v,u) in E} c[u]``: each rank takes its contiguous
    block of the edges (``indices``/``src_ids``), the count vector ``c``
    is replicated, and the per-rank segment sums are folded with one
    ``all_reduce`` into the output every rank returns.  Edge rows must
    divide the rank count (trim or pad to the rank boundary), as the
    JAX package's edge sharding requires.
    """
    dev = _step_device(device, "spmd_spmv_step")
    check_group_device(group, dev, "spmd_spmv_step")
    n_shards = dist.get_world_size(group)
    rank = dist.get_rank(group)

    def step(indices, src_ids, c):
        e = int(indices.shape[0])
        if e % n_shards or int(src_ids.shape[0]) != e:
            raise ValueError(f"{e} edge rows do not split over {n_shards} "
                             "ranks; trim or pad to the rank boundary")
        blk = e // n_shards
        sl = slice(rank * blk, (rank + 1) * blk)
        idx = _on(indices, dev, torch.int64, "indices")[sl]
        sid = _on(src_ids, dev, torch.int64, "src_ids")[sl]
        cv = _on(c, dev, None, "c")
        part = torch.zeros(n_nodes, dtype=cv.dtype, device=dev)
        part.index_add_(0, sid, cv[idx])
        dist.all_reduce(part, group=group)
        return part

    return step


class PartitionedJoin:
    """Granularity-factor partitioned WCOJ (host-level work splitting).

    Splits the first GAO level's seed domain into
    ``n_workers * granularity`` cost-balanced parts and runs each part as
    a seeded count on the shared :class:`~repro_torch.core.vlftj.VLFTJ`
    executor.  Parts are dealt to workers statically (part ``p`` to
    worker ``p % n_workers``; with ``dead`` workers, survivors pick up
    the orphaned parts via the same deterministic re-deal the training
    loop uses) and execute on a real concurrent pool
    (:class:`~repro_torch.dist.pool.WorkerPool`) — one worker per alive
    schedule entry, each draining its owned parts in schedule order.
    ``backend='auto'`` selects process vs thread by payload; the
    seeded-count task holds the executor's tensors, so it lands on
    threads, which share the graph and the kernel library.
    ``backend='sequential'`` runs the parts one after another in the
    calling thread (the equality baseline in the tests).

    On the card the pool threads share the default CUDA stream: a
    stream per thread was no faster (the threads wait on the host, not
    on the card), and one stream keeps every tensor on the stream it was
    made on.

    ``stats`` after :meth:`count`:

    * ``parts`` — number of parts (``n_workers * granularity``);
    * ``part_sizes`` — seeds per part (balanced to within one);
    * ``part_time`` / ``part_counts`` — per-part seconds and counts;
    * ``worker_time`` — per-worker summed part time (len ``n_workers``;
      dead workers stay at 0.0);
    * ``makespan`` — max worker time, ``<= total_time`` always;
    * ``total_time`` — summed part time (single-worker equivalent);
    * ``backend`` / ``wall_time`` — what the pool actually ran on, and
      the concurrent wall-clock (incl. pool overhead; compare with
      ``makespan``, which aggregates pure part seconds).

    On threads sharing one card, a part's seconds include the other
    workers' kernels queued on the stream before its own reads wait for
    them, so ``makespan`` and ``total_time`` count shared card time more
    than once; ``wall_time`` is the concurrent wall.
    """

    def __init__(self, query: Query, gdb: GraphDB, n_workers: int = 4,
                 granularity: int = 2, plan: JoinPlan | None = None,
                 dead: frozenset[int] | set[int] = frozenset(),
                 backend: str = "auto", **vlftj_kw):
        if n_workers < 1 or granularity < 1:
            raise ValueError("n_workers and granularity must be >= 1")
        self.executor = VLFTJ(query, gdb, plan=plan, **vlftj_kw)
        self.query = query
        self.gdb = gdb
        self.n_workers = n_workers
        self.granularity = granularity
        self.n_parts = n_workers * granularity
        seeds = self.executor._domain_values(self.executor.plan[0])
        self.parts = partition_first_level(
            self.executor.join_plan, seeds, gdb.csr.degrees, self.n_parts)
        self.schedule = reassign_shards(n_workers, set(dead), granularity)
        self.backend = backend
        self.stats: dict = {
            "parts": self.n_parts,
            "part_sizes": [int(p.shape[0]) for p in self.parts],
        }

    def _count_part(self, seeds: np.ndarray) -> int:
        return self.executor.seeded_count(
            seeds.astype(np.int32), np.ones(seeds.shape[0], dtype=np.int64))

    def count(self) -> int:
        # warm the kernel library and the graph's tensors once before
        # fanning out: the first part would otherwise build them while
        # every other worker waits on the same lock, charging the build
        # to one part's time and skewing the makespan accounting
        if self.parts and self.backend != "sequential":
            warm = max(self.parts, key=lambda p: p.shape[0])
            self._count_part(warm[:1])
        pool = WorkerPool(self.schedule, backend=self.backend)
        results, ptime, wall, backend = pool.run(self._count_part,
                                                 self.parts)
        part_time = np.zeros(self.n_parts)
        part_counts = np.zeros(self.n_parts, dtype=np.int64)
        for pid, c in results.items():
            part_counts[pid] = c
            part_time[pid] = ptime[pid]
        worker_time = [0.0] * self.n_workers
        for worker, owned in self.schedule.items():
            worker_time[worker] = float(part_time[owned].sum())
        self.stats.update({
            "part_time": part_time.tolist(),
            "part_counts": part_counts.tolist(),
            "worker_time": worker_time,
            "makespan": max(worker_time),
            "total_time": float(part_time.sum()),
            "backend": backend,
            "wall_time": wall,
        })
        return int(part_counts.sum())

    def pages(self, page_rows: int = 1024) -> Iterator[np.ndarray]:
        """Stream the join's output as fixed-size pages in global
        GAO-lexicographic order.

        Each part gets its own bounded-memory
        :class:`~repro_torch.results.ResultCursor` (the shared executor
        seeded with the part's first-level values).  The parts partition
        the first GAO variable's *domain*, so streams interleave only at
        first-column granularity: the part holding the globally smallest
        head row owns every row up to the next part's head value, and
        whole runs splice over with one ``searchsorted`` — the merge a
        scatter-gather coordinator would run over real workers' page
        responses, with no per-row Python work."""
        from ..results.cursor import ResultCursor

        k = len(self.executor.gao)
        streams: list[list] = []      # [head buffer, cursor] per live part
        for p in self.parts:
            if p.shape[0] == 0:
                continue
            cur = ResultCursor(self.executor, page_rows=page_rows,
                               seeds=p.astype(np.int32))
            page = cur.next_page()
            if page is not None:
                streams.append([page, cur])
        out: list[np.ndarray] = []
        buffered = 0
        while streams:
            i = min(range(len(streams)),
                    key=lambda j: tuple(streams[j][0][0]))
            buf, cur = streams[i]
            others = [streams[j][0][0, 0]
                      for j in range(len(streams)) if j != i]
            if others:
                # first-column values are disjoint across parts, so the
                # run boundary is where the next part's head value starts
                cut = int(np.searchsorted(buf[:, 0], min(others),
                                          side="left"))
            else:
                cut = buf.shape[0]
            take, rest = buf[:cut], buf[cut:]
            if rest.shape[0]:
                streams[i][0] = rest
            else:
                nxt = cur.next_page()
                if nxt is None:
                    streams.pop(i)
                else:
                    streams[i][0] = nxt
            out.append(take)
            buffered += take.shape[0]
            while buffered >= page_rows:
                cat = np.concatenate(out) if len(out) > 1 else out[0]
                yield cat[:page_rows]
                cat = cat[page_rows:]
                out = [cat] if cat.shape[0] else []
                buffered = int(cat.shape[0])
        if buffered:
            yield (np.concatenate(out)
                   if len(out) > 1 else out[0]).reshape(-1, k)

    def enumerate(self, limit: int | None = None, page_rows: int = 1024):
        """All output tuples as a :class:`~repro_torch.results.ResultSet`
        — columns in the plan's GAO order, rows lex-sorted (``limit``
        truncates after the ordering), produced by merging the per-part
        page streams of :meth:`pages`."""
        from ..results.result_set import ResultSet

        out: list[np.ndarray] = []
        taken = 0
        for page in self.pages(page_rows=page_rows):
            out.append(page)
            taken += page.shape[0]
            if limit is not None and taken >= limit:
                break
        rows = (np.concatenate(out, axis=0) if out
                else np.zeros((0, len(self.executor.gao)), dtype=np.int64))
        return ResultSet(self.executor.gao,
                         rows if limit is None else rows[:limit])
