"""Preemptive multi-tenant query scheduling — quantum-sliced execution
(the port of ``repro.serve.scheduler``).

``QueryServer.execute`` runs each request to completion, so one heavy
lollipop enumeration starves every small query queued behind it.  This
module adds SaGe-style *web preemption* on top of the engine's existing
suspend/resume machinery (``VLFTJ._run(start_level=)`` +
``JoinPlan.level_callback`` — the same level-boundary hook the
distributed rebalancer uses):

* :class:`PlanSnapshot` — the serializable suspended state of an
  in-flight plan: the partial-binding ``frontier``, its ``mult``
  multiplicities, the resume level, and (past the penultimate level)
  the final-phase tail state — rows already tallied (counts) or already
  delivered (enumeration).  ``to_bytes``/``from_bytes`` round-trip it
  without pickle.
* :class:`QuantumBudget` — a ``level_callback`` that charges every
  frontier the engine builds against a per-slice quantum measured in
  **rows expanded**, not wall time (deterministic, so fairness is
  testable), and raises :class:`Preempted` carrying a snapshot when the
  quantum is exhausted.  Suspension happens only at GAO level
  boundaries — the engine's host-visible synchronization points — so
  resume is loss-free by construction.
* :class:`QuantumScheduler` — a round-robin run queue over concurrent
  :class:`~repro_torch.serve.query_server.QueryRequest` s: each job runs one
  quantum and either completes or parks its suspended state in the
  server's cursor registry (same LRU eviction and restart semantics as
  pagination cursors), then goes to the back of the queue.  Per-tenant
  quotas (max in-flight, max parked frontier bytes) gate admission
  429-style.

The quantum accounting unit: interior GAO levels charge the rows of
each frontier they build; the final level charges output rows as pages
stream (enumeration) or penultimate-frontier rows as count windows
tally (counting).  Both are exact, data-dependent, and reproducible
across runs, and the same in both packages: ``tests/test_torch_serve.py``
holds the port's counts, rows, quanta, preemptions and virtual clocks
equal to the JAX package's on every tier-1 query shape, and a snapshot
written by either package resumes in the other (the byte format of
:meth:`PlanSnapshot.to_bytes` is the contract).
"""
from __future__ import annotations

import contextlib
import io
import json
import struct
import time
from collections import deque
from dataclasses import dataclass

import numpy as np

from ..core import VLFTJ, get_query
from ..core.plan import pow2ceil
from ..obs import DeviceProfile, QueryTrace, span
from ..results import ResultCursor
from .query_server import QueryRequest, QueryResult, QueryServer


# ---------------------------------------------------------------------------
# suspended state
# ---------------------------------------------------------------------------

@dataclass
class PlanSnapshot:
    """Serializable suspended state of an in-flight plan.

    ``frontier`` is the ``(rows, w)`` int32 array of partial bindings
    with ``w`` GAO columns bound; ``mult`` the ``(rows,)`` int64
    multiplicities.  ``phase`` says what the snapshot suspended:

    * ``'frontier'`` — an interior GAO level; resume feeds
      ``(frontier, mult)`` back into ``VLFTJ.advance`` /
      ``VLFTJ._run(start_level=)``;
    * ``'final'`` — the final level: ``frontier`` is the completed
      (lex-sorted) penultimate frontier, and the tail state is
      ``offset``/``partial_total`` for counting jobs or
      ``rows_emitted`` for enumeration jobs (resume via
      ``ResultCursor(frontier=..., skip_rows=rows_emitted)``).
    """

    query_name: str
    gao: tuple[str, ...]
    frontier: np.ndarray
    mult: np.ndarray
    phase: str = "frontier"    # 'frontier' | 'final'
    offset: int = 0            # final/count: frontier rows already tallied
    partial_total: int = 0     # final/count: weighted count so far
    rows_emitted: int = 0      # final/rows: output rows already delivered

    @property
    def start_level(self) -> int:
        """The GAO level execution resumes at (== bound column count)."""
        return int(self.frontier.shape[1])

    @property
    def nbytes(self) -> int:
        """Parked bytes — what the per-tenant frontier quota meters."""
        return int(self.frontier.nbytes + self.mult.nbytes)

    def to_bytes(self) -> bytes:
        """Pickle-free wire form: json header + two raw .npy arrays."""
        head = json.dumps({
            "query_name": self.query_name, "gao": list(self.gao),
            "phase": self.phase, "offset": self.offset,
            "partial_total": self.partial_total,
            "rows_emitted": self.rows_emitted,
        }).encode()
        buf = io.BytesIO()
        buf.write(struct.pack("<I", len(head)))
        buf.write(head)
        np.save(buf, np.ascontiguousarray(self.frontier, dtype=np.int32),
                allow_pickle=False)
        np.save(buf, np.ascontiguousarray(self.mult, dtype=np.int64),
                allow_pickle=False)
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes) -> "PlanSnapshot":
        buf = io.BytesIO(data)
        (hlen,) = struct.unpack("<I", buf.read(4))
        head = json.loads(buf.read(hlen).decode())
        frontier = np.load(buf, allow_pickle=False)
        mult = np.load(buf, allow_pickle=False)
        return cls(head["query_name"], tuple(head["gao"]), frontier, mult,
                   phase=head["phase"], offset=head["offset"],
                   partial_total=head["partial_total"],
                   rows_emitted=head["rows_emitted"])


class Preempted(Exception):
    """Raised at a GAO level boundary when a quantum expires; carries
    the :class:`PlanSnapshot` that resumes the join loss-free."""

    def __init__(self, snapshot: PlanSnapshot):
        super().__init__(
            f"preempted at level {snapshot.start_level} "
            f"({snapshot.frontier.shape[0]} frontier rows)")
        self.snapshot = snapshot


class QuantumBudget:
    """``JoinPlan.level_callback`` that meters frontier rows expanded.

    Wraps (and runs first) any ``inner`` callback already on the plan —
    e.g. the distributed rebalancer — so budget accounting composes
    with adaptive execution.  ``charge`` is also called by the
    scheduler's final-phase loops, making this object the single meter
    a job's deterministic cost accumulates on (``total_rows``).
    """

    def __init__(self, quantum_rows: int | None, query_name: str,
                 gao: tuple[str, ...], inner=None):
        self.quantum_rows = quantum_rows   # None: never preempt (FIFO)
        self.query_name = query_name
        self.gao = gao
        self.inner = inner
        self.consumed = 0      # rows charged this slice
        self.total_rows = 0    # lifetime rows (the deterministic clock)

    def refill(self) -> None:
        self.consumed = 0

    def charge(self, rows: int) -> bool:
        """Add ``rows`` to the meters; True when the slice is spent."""
        self.consumed += int(rows)
        self.total_rows += int(rows)
        return (self.quantum_rows is not None
                and self.consumed >= self.quantum_rows)

    def __call__(self, level, frontier, mult):
        if self.inner is not None:
            upd = self.inner(level, frontier, mult)
            if upd is not None:
                frontier, mult = upd
        if self.charge(frontier.shape[0]):
            raise Preempted(PlanSnapshot(
                self.query_name, self.gao,
                np.asarray(frontier, dtype=np.int32),
                np.asarray(mult, dtype=np.int64)))
        return frontier, mult


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

class AdmissionError(RuntimeError):
    """429-style rejection: the tenant is over quota.  ``status`` mirrors
    the HTTP code a fronting server would return."""

    status = 429

    def __init__(self, tenant: str, reason: str):
        super().__init__(f"tenant {tenant!r} over quota: {reason}")
        self.tenant = tenant
        self.reason = reason


@dataclass(frozen=True)
class TenantQuota:
    """Per-tenant admission limits.

    ``max_in_flight`` caps concurrently admitted (queued or running)
    requests; ``max_frontier_bytes`` caps the bytes of suspended
    frontier state parked in the registry — the memory a preempted
    tenant is allowed to pin between quanta.
    """

    max_in_flight: int = 8
    max_frontier_bytes: int = 64 << 20


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------

class _Job:
    __slots__ = ("id", "token", "req", "tenant", "plan", "gdb", "label",
                 "budget", "executor", "window", "collect_rows", "pages",
                 "rows_collected", "quanta", "preemptions", "restarts",
                 "parked_nbytes", "t_submit", "t_queued", "vclock_submit",
                 "result", "seq", "trace", "profile", "quantum_rows_initial")

    def __init__(self, jid: int, req: QueryRequest, plan, gdb, label,
                 budget: QuantumBudget, collect_rows: bool, vclock: int):
        self.id = jid
        self.token = f"sched-{jid}"
        self.req = req
        self.tenant = req.tenant
        self.plan = plan
        self.gdb = gdb
        self.label = label
        self.budget = budget
        self.executor: VLFTJ | None = None
        self.window = 0
        self.collect_rows = collect_rows
        self.pages: list[np.ndarray] = []
        self.rows_collected = 0
        self.quanta = 0
        self.preemptions = 0
        self.restarts = 0
        self.parked_nbytes = 0
        # time.perf_counter seconds: at submission, and when the job last
        # went back into the run queue
        self.t_submit = self.t_queued = time.perf_counter()
        self.vclock_submit = vclock
        self.result: QueryResult | None = None
        # per-job trace (req.trace): preempt/resume/restart events land
        # here; the restart-backoff quantum growth is visible both as
        # events and in the result stats (quantum_rows_initial/_final)
        self.trace: QueryTrace | None = (
            QueryTrace(req.query_name, plan.gao, plan.engine)
            if req.trace else None)
        # per-job device profile (req.profile): kernel-library builds
        # recorded while this job runs carry a per-quantum attribution label
        # (``sched-<id>/q<k>``), set by the scheduler around each slice
        self.profile: DeviceProfile | None = (
            DeviceProfile(req.query_name, plan.engine)
            if req.profile else None)
        self.quantum_rows_initial = budget.quantum_rows


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------

class QuantumScheduler:
    """Round-robin quantum scheduler over a :class:`QueryServer`.

    Args:
        server: the server whose plan cache, warm graphs, and cursor
            registry this scheduler shares.
        quantum_rows: rows expanded per scheduling slice (the quantum).
            Deterministic: the same workload preempts at the same
            boundaries on every run.
        policy: ``'quantum'`` (preemptive round-robin) or ``'fifo'``
            (run each job to completion in submission order — the
            baseline the serve benchmark compares against).
        quotas: per-tenant :class:`TenantQuota` overrides.
        default_quota: quota applied to tenants not in ``quotas``.

    Usage::

        sched = QuantumScheduler(server, quantum_rows=4096)
        sched.submit(QueryRequest("3-lollipop", limit=10**6))   # heavy
        sched.submit(QueryRequest("3-clique", tenant="b"))      # small
        results = sched.run()    # small completes long before heavy

    ``submit`` raises :class:`AdmissionError` (``status == 429``) when
    the tenant is over quota.  Suspended jobs park their state in the
    server's cursor registry under a ``sched-<n>`` token with the same
    LRU eviction semantics as pagination cursors; an evicted job
    restarts from scratch on its next quantum (and counts a restart in
    its result stats) rather than failing.
    """

    def __init__(self, server: QueryServer, quantum_rows: int = 8192,
                 policy: str = "quantum",
                 quotas: dict[str, TenantQuota] | None = None,
                 default_quota: TenantQuota | None = None):
        if policy not in ("quantum", "fifo"):
            raise ValueError(f"unknown policy {policy!r}; "
                             "options: ('quantum', 'fifo')")
        if quantum_rows < 1:
            raise ValueError("quantum_rows must be >= 1")
        self.server = server
        self.quantum_rows = quantum_rows
        self.policy = policy
        self.quotas = dict(quotas or {})
        self.default_quota = default_quota or TenantQuota()
        self._queue: deque[_Job] = deque()
        self._jobs: list[_Job] = []
        self._by_token: dict[str, _Job] = {}
        self._in_flight: dict[str, int] = {}
        self._seq = 0
        self.vclock = 0   # total rows expanded across all jobs
        self.stats = {"quanta": 0, "preemptions": 0, "restarts": 0,
                      "rejected": 0, "completed": 0, "parked_evictions": 0}

    # -- admission -----------------------------------------------------------
    def quota_for(self, tenant: str) -> TenantQuota:
        return self.quotas.get(tenant, self.default_quota)

    def _tenant_parked_bytes(self, tenant: str) -> int:
        return sum(j.parked_nbytes for j in self._jobs
                   if j.tenant == tenant and j.result is None)

    def submit(self, req: QueryRequest, collect_rows: bool = True) -> str:
        """Admit one request; returns its job token (``sched-<n>``).

        Args:
            req: the request.  ``req.tenant`` selects the quota;
                ``req.limit`` makes it an enumeration job (rows stream
                across quanta until ``limit`` rows are collected).
            collect_rows: enumeration jobs buffer their pages into the
                final result when True; False streams-and-discards
                (count delivered rows only) so a huge enumeration can
                be drained with bounded memory.

        Raises:
            AdmissionError: the tenant is at ``max_in_flight`` admitted
                requests, or its parked suspended state already exceeds
                ``max_frontier_bytes``.
            ValueError: ``req.cursor`` continuations — those resume
                server-side cursors directly via ``QueryServer.execute``
                and never enter the run queue.
        """
        if req.cursor is not None:
            raise ValueError("cursor continuations resume via "
                             "QueryServer.execute, not the scheduler")
        quota = self.quota_for(req.tenant)
        if self._in_flight.get(req.tenant, 0) >= quota.max_in_flight:
            self.stats["rejected"] += 1
            raise AdmissionError(
                req.tenant, f"max_in_flight={quota.max_in_flight} reached")
        if self._tenant_parked_bytes(req.tenant) >= quota.max_frontier_bytes:
            self.stats["rejected"] += 1
            raise AdmissionError(
                req.tenant,
                f"parked frontier bytes over "
                f"max_frontier_bytes={quota.max_frontier_bytes}")
        with span("sched.submit", request=f"sched-{self._seq + 1}",
                  tenant=req.tenant, query=req.query_name):
            sel = req.selectivity or self.server.default_selectivity
            gdb = self.server._gdb_for(sel, req.seed)
            output = "rows" if req.limit is not None else "count"
            plan, _cached = self.server._plan_for(req, gdb, output=output)
            budget = QuantumBudget(
                None if self.policy == "fifo" else self.quantum_rows,
                req.query_name, plan.gao, inner=plan.level_callback)
            self._seq += 1
            job = _Job(self._seq, req, plan, gdb, plan.engine, budget,
                       collect_rows, self.vclock)
            self._jobs.append(job)
            self._by_token[job.token] = job
            self._queue.append(job)
            self._in_flight[req.tenant] = \
                self._in_flight.get(req.tenant, 0) + 1
        return job.token

    def result(self, token: str) -> QueryResult | None:
        """The :class:`QueryResult` of the job ``submit`` returned
        ``token`` for; None while it is still queued or running, and for
        a token this scheduler never issued."""
        job = self._by_token.get(token)
        return None if job is None else job.result

    # -- parking -------------------------------------------------------------
    def _park(self, job: _Job, payload) -> None:
        """Park suspended state in the server's cursor registry.

        The payload (a :class:`PlanSnapshot` or a live
        :class:`ResultCursor`) is subject to the registry's LRU cap and
        the tenant's frontier-byte quota; over-quota parking evicts the
        tenant's *other* parked jobs oldest-first (reason ``'quota'``),
        and a payload that alone exceeds the quota fails the job with a
        429-style result.
        """
        nb = payload.nbytes if isinstance(payload, PlanSnapshot) else (
            int(payload.penultimate.nbytes)
            if getattr(payload, "penultimate", None) is not None else 0)
        quota = self.quota_for(job.tenant)
        if nb > quota.max_frontier_bytes:
            self._finish_rejected(
                job, f"suspended frontier ({nb} bytes) exceeds "
                     f"max_frontier_bytes={quota.max_frontier_bytes}")
            return
        while self._tenant_parked_bytes(job.tenant) + nb \
                > quota.max_frontier_bytes:
            victim = next((j for j in self._jobs
                           if j.tenant == job.tenant and j is not job
                           and j.parked_nbytes > 0 and j.result is None),
                          None)
            if victim is None:
                break
            self.server._close_cursor(victim.token, "quota")
            victim.parked_nbytes = 0
            self.stats["parked_evictions"] += 1
        job.parked_nbytes = nb
        self.server._register_cursor(payload, job.label, job.plan,
                                     token=job.token)

    def _unpark(self, job: _Job):
        """Retrieve parked state; None means fresh start (first quantum,
        or the registry evicted the job's state — count a restart)."""
        entry = self.server._cursors.pop(job.token, None)
        if entry is not None:
            job.parked_nbytes = 0
            return entry[0]
        reason = self.server._closed.get(job.token)
        if reason in ("evicted", "quota") and job.quanta > 1:
            job.restarts += 1
            self.stats["restarts"] += 1
            job.parked_nbytes = 0
            if job.budget.quantum_rows is not None:
                # restart backoff: a registry smaller than the number of
                # concurrently-preempting jobs makes parked snapshots
                # mutually evict — restart-from-scratch forever.  Double
                # the quantum on every eviction restart so the work done
                # per restart grows geometrically and the job finishes
                # within one slice after O(log(total work)) restarts.
                job.budget.quantum_rows *= 2
            # the backoff growth is caller-visible: a restart event on
            # the job's trace plus quantum_rows_final in result stats
            self.server.metrics_registry.counter(
                "scheduler_restarts", reason=reason).inc()
            if job.trace is not None:
                job.trace.event("restart", reason=reason,
                                quantum_rows=job.budget.quantum_rows,
                                rows_lost=job.budget.total_rows)
        return None

    # -- execution -----------------------------------------------------------
    def _executor(self, job: _Job) -> VLFTJ:
        if job.executor is None:
            plan = job.plan.with_level_callback(job.budget)
            job.executor = VLFTJ(get_query(job.req.query_name), job.gdb,
                                 plan=plan)
            job.window = max(64, min(job.executor.chunk_rows,
                                     pow2ceil(self.quantum_rows)))
        return job.executor

    def _preemptible(self, job: _Job) -> bool:
        return (job.plan.engine == "vlftj"
                and not self.server._routes_to_dist(job.plan, job.gdb)
                and len(job.plan.gao) >= 2)

    def _finish(self, job: _Job, count: int,
                rows: np.ndarray | None = None,
                next_cursor: str | None = None) -> None:
        self._in_flight[job.tenant] -= 1
        self.stats["completed"] += 1
        trace = job.trace
        if trace is not None:
            if job.executor is not None:
                trace.record_engine(job.executor.stats, gao=job.plan.gao,
                                    est_rows=job.plan.level_est_rows)
                if job.req.limit is None and len(job.plan.gao):
                    # the scheduler drives the final level itself
                    # (windowed tallies), so the engine's level_rows
                    # stops at the penultimate level — close it here
                    trace.level(len(job.plan.gao) - 1, obs_rows=count)
            trace.finish(count=count, quanta=job.quanta,
                         preemptions=job.preemptions,
                         restarts=job.restarts,
                         rows_expanded=job.budget.total_rows)
        if job.profile is not None:
            job.profile.publish(trace=trace,
                                registry=self.server.metrics_registry)
        job.result = QueryResult(
            job.req, count, job.label, time.perf_counter() - job.t_submit,
            plan=job.plan, rows=rows,
            row_vars=job.plan.gao if rows is not None else None,
            next_cursor=next_cursor, trace=trace, profile=job.profile,
            stats={"quanta": job.quanta, "preemptions": job.preemptions,
                   "restarts": job.restarts,
                   "rows_expanded": job.budget.total_rows,
                   "vclock_submit": job.vclock_submit,
                   "vclock_done": self.vclock,
                   "policy": self.policy,
                   # restart-backoff visibility (doubles per eviction
                   # restart in _unpark): final == initial iff no
                   # eviction restart grew the quantum
                   "quantum_rows_initial": job.quantum_rows_initial,
                   "quantum_rows_final": job.budget.quantum_rows})

    def _finish_rejected(self, job: _Job, reason: str) -> None:
        self._in_flight[job.tenant] -= 1
        self.stats["rejected"] += 1
        job.result = QueryResult(
            job.req, 0, "rejected", time.perf_counter() - job.t_submit,
            plan=job.plan,
            stats={"status": 429, "error": reason, "quanta": job.quanta,
                   "vclock_submit": job.vclock_submit,
                   "vclock_done": self.vclock, "policy": self.policy})

    def step(self) -> bool:
        """Run one quantum of the job at the head of the run queue.

        Returns True if any job ran (False: queue empty).  The job
        either completes (its :class:`QueryResult` gains scheduling
        stats) or re-enters the queue tail with its state parked.
        """
        if not self._queue:
            return False
        job = self._queue.popleft()
        if job.result is not None:     # failed while parked (quota)
            return True
        job.quanta += 1
        with span("sched.quantum", request=job.token,
                  quantum=job.quanta) as rec:
            if rec is not None:
                rec.attrs["waited_ms"] = \
                    rec.start_ns / 1e6 - job.t_queued * 1e3
            self._quantum(job)
        return True

    def _quantum(self, job: _Job) -> None:
        self.stats["quanta"] += 1
        self.server.metrics_registry.counter("scheduler_quanta").inc()
        job.budget.refill()
        before = job.budget.total_rows
        try:
            with contextlib.ExitStack() as stack:
                if job.trace is not None:
                    stack.enter_context(job.trace.activate())
                if job.profile is not None:
                    # per-quantum compile attribution: a kernel-library
                    # build this slice triggers is labelled with the job
                    # and quantum that paid for it
                    stack.enter_context(job.profile.activate())
                    stack.enter_context(job.profile.attribute(
                        f"{job.token}/q{job.quanta}"))
                done = self._advance(job)
        except Preempted as p:
            job.preemptions += 1
            self.stats["preemptions"] += 1
            self.server.metrics_registry.counter(
                "scheduler_preemptions").inc()
            if job.trace is not None:
                job.trace.event(
                    "preempt", level=p.snapshot.start_level,
                    frontier_rows=int(p.snapshot.frontier.shape[0]),
                    quantum=job.quanta,
                    rows_expanded=job.budget.total_rows)
            self._park(job, p.snapshot)
            done = False
        self.vclock += job.budget.total_rows - before
        if job.result is not None:
            # completion time on the shared rows-expanded clock must
            # include this (final) quantum's own work, which is only
            # added to the vclock here, after _finish already ran
            job.result.stats["vclock_done"] = self.vclock
        if not done and job.result is None:
            job.t_queued = time.perf_counter()
            self._queue.append(job)

    def run(self) -> list[QueryResult]:
        """Drain the queue; results in submission order (rejected jobs
        carry ``stats['status'] == 429``)."""
        while self.step():
            pass
        return [j.result for j in self._jobs if j.result is not None]

    # -- one quantum of one job ---------------------------------------------
    def _advance(self, job: _Job) -> bool:
        """Advance ``job`` by one quantum; True when complete."""
        state = self._unpark(job)
        if not self._preemptible(job):
            return self._run_opaque(job)
        ex = self._executor(job)
        k = len(ex.plan)
        if job.trace is not None and state is not None:
            if isinstance(state, PlanSnapshot):
                job.trace.event("resume", phase=state.phase,
                                level=state.start_level,
                                frontier_rows=int(state.frontier.shape[0]),
                                quantum=job.quanta)
            else:
                job.trace.event("resume", phase="rows", quantum=job.quanta,
                                rows_emitted=job.rows_collected)
        if job.req.limit is not None:
            return self._advance_rows(job, ex, state)
        # counting job: build the penultimate frontier (preemptible at
        # level boundaries), then tally the final level in fixed-size
        # windows so preemption points exist inside the final level too
        if state is None or (isinstance(state, PlanSnapshot)
                             and state.phase == "frontier"):
            frontier = ex.advance(
                frontier=None if state is None else state.frontier,
                mult=None if state is None else state.mult,
                max_levels=k - 1)                      # may raise Preempted
            if frontier.shape[0] == 0:
                self._finish(job, 0)
                return True
            frontier = frontier[np.lexsort(frontier.T[::-1])]
            state = PlanSnapshot(
                job.req.query_name, ex.gao,
                frontier.astype(np.int32),
                np.ones(frontier.shape[0], dtype=np.int64), phase="final")
        snap: PlanSnapshot = state
        F = snap.frontier.shape[0]
        while snap.offset < F:
            if job.budget.quantum_rows is not None \
                    and job.budget.consumed >= job.budget.quantum_rows:
                job.preemptions += 1
                self.stats["preemptions"] += 1
                self.server.metrics_registry.counter(
                    "scheduler_preemptions").inc()
                if job.trace is not None:
                    job.trace.event("preempt", level=len(ex.plan),
                                    phase="final", offset=snap.offset,
                                    quantum=job.quanta,
                                    rows_expanded=job.budget.total_rows)
                self._park(job, snap)
                return False
            real = min(job.window, F - snap.offset)
            chunk = snap.frontier[snap.offset:snap.offset + real]
            if real < job.window:
                chunk = np.pad(chunk, ((0, job.window - real), (0, 0)))
            valid = np.zeros(job.window, dtype=bool)
            valid[:real] = True
            counts = ex.last_level_counts(chunk, valid)[:real]
            m = snap.mult[snap.offset:snap.offset + real]
            snap.partial_total += int((counts * m).sum())
            snap.offset += real
            job.budget.charge(real)
        self._finish(job, snap.partial_total)
        return True

    def _advance_rows(self, job: _Job, ex: VLFTJ, state) -> bool:
        """One quantum of an enumeration job: pull pages until the
        quantum is spent, the limit is reached, or the stream ends."""
        if isinstance(state, ResultCursor):
            cur = state
        elif isinstance(state, PlanSnapshot):
            # resume from a suspended frontier; rows this job already
            # collected (e.g. before a registry eviction forced a
            # restart) are skipped so no page is delivered twice
            skip = max(job.rows_collected, state.rows_emitted)
            cur = ResultCursor(ex, page_rows=self.server.page_rows,
                               frontier=state.frontier, skip_rows=skip)
        else:
            cur = ResultCursor(ex, page_rows=self.server.page_rows,
                               skip_rows=job.rows_collected)
        limit = job.req.limit
        while True:
            want = min(self.server.page_rows, limit - job.rows_collected)
            if want <= 0:
                break
            try:
                page = cur.take(want)       # first pull may build levels
            except Preempted:
                raise                        # generator is dead; snapshot
            if page.shape[0] == 0:
                break
            job.rows_collected += int(page.shape[0])
            if job.collect_rows:
                job.pages.append(page)
            if job.budget.charge(page.shape[0]):
                break
        if job.rows_collected < limit and not cur.exhausted:
            if job.budget.quantum_rows is not None \
                    and job.budget.consumed >= job.budget.quantum_rows:
                job.preemptions += 1
                self.stats["preemptions"] += 1
                self.server.metrics_registry.counter(
                    "scheduler_preemptions").inc()
                if job.trace is not None:
                    job.trace.event("preempt", phase="rows",
                                    rows_emitted=job.rows_collected,
                                    quantum=job.quanta,
                                    rows_expanded=job.budget.total_rows)
                self._park(job, cur)
                return False
        rows = None
        next_cursor = None
        if job.collect_rows:
            rows = (np.concatenate(job.pages, axis=0) if job.pages
                    else np.zeros((0, len(ex.gao)), dtype=np.int64))
            if not cur.exhausted:
                # hand the live tail back as a normal pagination cursor:
                # the client continues via QueryServer.execute(cursor=)
                next_cursor = self.server._register_cursor(
                    cur, job.label, job.plan)
        self._finish(job, job.rows_collected, rows=rows,
                     next_cursor=next_cursor)
        return True

    def _run_opaque(self, job: _Job) -> bool:
        """Non-preemptible fallback: engines without the level-boundary
        hook (yannakakis/hybrid/refs) and dist-routed plans run to
        completion in one quantum."""
        if job.req.limit is not None:
            cur, label = self.server._open_cursor(job.plan, job.gdb,
                                                  job.req)
            job.label = label
            rows = cur.take(job.req.limit)
            next_cursor = None
            if job.collect_rows and not cur.exhausted:
                next_cursor = self.server._register_cursor(
                    cur, label, job.plan)
            self._finish(job, int(rows.shape[0]),
                         rows=rows if job.collect_rows else None,
                         next_cursor=next_cursor)
            return True
        c, label, _estats = self.server._execute_plan(job.plan, job.gdb,
                                                      job.req)
        job.label = label
        self._finish(job, c)
        return True
