"""Batched graph-pattern query serving — the paper's workload as a service
(the port of ``repro.serve.query_server``).

The RDBMS story of the paper is interactive: clients submit pattern
queries (with per-request node samples / selectivities) against a resident
graph.  ``QueryServer`` keeps the device-resident CSR warm — every
``GraphDB`` it builds lives on ``device``, the card unless the caller
asks for the CPU — and serves through the plan/execute split
(``core.plan`` / ``core.planner``):

  * every request is planned once into a
    :class:`~repro_torch.core.plan.JoinPlan`, verified, and executed via
    ``core.engine.execute_stats``;
  * plans are memoized in an LRU :class:`~repro_torch.core.planner.PlanCache`
    keyed by (query structure, stats fingerprint), so repeated pattern
    shapes skip planning entirely — ``plan_cache_info()`` exposes the
    hit/miss counters;
  * ``execute_many`` groups same-plan requests so consecutive
    executions of one plan run back to back on one warm graph;
  * graphs at or above ``dist_edge_threshold`` directed edges run their
    ``vlftj`` plans through :class:`repro_torch.dist.PartitionedJoin`
    (granularity-factor over-partitioning on a thread pool; engine label
    ``vlftj+partitioned``, pool stats in ``last_dist_stats``), counts
    and pages alike;
  * requests with ``limit=`` (or a continuation ``cursor=``) return
    *rows*, not counts: the server opens a bounded-memory
    :class:`~repro_torch.results.ResultCursor` (``core.engine.stream`` —
    plans resolve with ``output='rows'`` through the same plan cache, so
    same-plan grouping is preserved), hands back one page plus an opaque
    ``next_cursor`` token, and resumes the cursor on the next request
    without re-planning or re-executing the prefix.

The server passes no check mode: its engines run the default ``bsearch``
(the port accepts four modes and raises on any other).
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import GraphDB, GraphStats, JoinPlan, PlanCache, get_query
from ..core import engine as engine_mod
from ..device import resolve_device
from ..graphs import CSRGraph, node_sample
from ..obs import (DeviceProfile, MetricsRegistry, QueryTrace, get_registry,
                   normalize_engine_stats, span)
from ..results import ResultCursor


@dataclass
class QueryRequest:
    """One client request against the resident graph.

    ``query_name`` picks a paper pattern
    (``repro_torch.core.PAPER_QUERIES``);
    ``selectivity``/``seed`` regenerate the per-request unary samples;
    ``engine`` pins a physical operator (default: planner's choice).
    ``limit`` turns the request into enumeration (one page of up to
    ``limit`` rows) and ``cursor`` resumes a previous response's
    ``next_cursor`` token.  ``tenant`` names the quota bucket the
    preemptive scheduler (``repro_torch.serve.scheduler``) meters admission
    and parked-frontier bytes against; the plain ``execute`` path
    ignores it.
    """

    query_name: str
    selectivity: float | None = None   # regenerate v1/v2 samples at 1/s
    seed: int = 0
    engine: str = "auto"
    # enumeration: limit= asks for (up to) that many rows; cursor= resumes
    # a previous response's next_cursor token (limit then sizes the page)
    limit: int | None = None
    cursor: str | None = None
    tenant: str = "default"
    #: record a :class:`repro_torch.obs.QueryTrace` for this request —
    #: per-level est/obs cardinality and scheduler events — returned as
    #: ``QueryResult.trace``.  Off by default: a disabled tracer costs
    #: nothing (``tests/test_torch_obs.py`` guards zero extra launches).
    trace: bool = False
    #: record a :class:`repro_torch.obs.DeviceProfile` for this request
    #: — dispatch counts, library builds, per-kernel wall breakdown,
    #: memory watermarks — returned as ``QueryResult.profile`` and
    #: published into the server's metrics registry.  Off by default with
    #: the same no-extra-launch guarantee (``tests/test_torch_obs.py``).
    profile: bool = False

    @property
    def wants_rows(self) -> bool:
        return self.limit is not None or self.cursor is not None


@dataclass
class QueryResult:
    """One response: the count (or page-row count), the engine label
    that actually ran, and observability in ``stats`` — always the
    server's ``plan_cache`` hit/miss counters and cursor-registry state
    (open cursors + closed-token reason tallies); direct (unscheduled)
    count responses add ``stats["engine"]``, the unified per-engine
    schema
    (:data:`repro_torch.obs.ENGINE_REQUIRED_KEYS` — rows expanded, kernel
    dispatches, jit calls/compiles, per-level rows/wall/paths, with the
    engine's native counters under ``raw``); scheduled results add the
    scheduling counters (``quanta``/``preemptions``/``restarts``/
    ``rows_expanded``/``quantum_rows_initial``/``quantum_rows_final``/
    ``vclock_*``).  The full key namespace is documented in
    ``docs/OBSERVABILITY.md``."""

    request: QueryRequest
    count: int
    engine: str
    #: seconds from submission to the answer, on the monotonic
    #: ``time.perf_counter`` clock
    latency_s: float
    plan: JoinPlan | None = None
    plan_cached: bool = False
    # enumeration responses: one page of output tuples (count = page
    # rows), its column order, and the continuation token (None when the
    # result set is exhausted)
    rows: np.ndarray | None = None
    row_vars: tuple[str, ...] | None = None
    next_cursor: str | None = field(default=None)
    stats: dict = field(default_factory=dict)
    #: the request's :class:`repro_torch.obs.QueryTrace` when
    #: ``req.trace`` was set (export with ``trace.to_jsonl()``); None
    #: otherwise.
    trace: QueryTrace | None = None
    #: the request's :class:`repro_torch.obs.DeviceProfile` when
    #: ``req.profile`` was set (export with ``profile.to_dict()``); None
    #: otherwise.
    profile: DeviceProfile | None = None


class QueryServer:
    """The port's query server over one resident CSR graph.

    ``device`` is where every ``GraphDB`` the server warms lives and its
    engines run: ``"cuda"`` by default, which raises here when the
    process has no card; ``"cpu"`` runs the plain PyTorch path.  The
    other arguments are the JAX package's."""

    def __init__(self, csr: CSRGraph, default_selectivity: float = 10.0,
                 plan_cache_size: int = 256,
                 dist_edge_threshold: int | None = 1 << 22,
                 dist_workers: int = 4, dist_granularity: int = 2,
                 page_rows: int = 1024, max_open_cursors: int = 64,
                 metrics: MetricsRegistry | None = None,
                 request_log: str | None = None,
                 device: torch.device | str = "cuda"):
        self.csr = csr
        self.device = resolve_device(device, "QueryServer")
        # structured request log: one JSON line per execute() call —
        # trace_id, query, tenant, engine, count, latency, status — with
        # the same trace_id stamped into the request's QueryTrace /
        # DeviceProfile meta for correlation (schema:
        # docs/OBSERVABILITY.md).  None disables logging entirely.
        self.request_log = request_log
        self._log_lock = threading.Lock()
        self._request_seq = 0
        # process metrics: plan-cache traffic, cursor closes by reason,
        # scheduler quanta, pool makespans — one registry, snapshotted by
        # metrics().  Default: the process-wide registry; pass a private
        # MetricsRegistry for isolation.
        self.metrics_registry = metrics if metrics is not None \
            else get_registry()
        self.default_selectivity = default_selectivity
        # the edge tensors (indptr, indices, src_ids, summaries) depend on
        # the CSR alone: built once, on a warm graph's first engine call,
        # and shared by every warm graph, which builds only its bitmaps
        self._edges = GraphDB(self.csr, {}, device=self.device)
        self._warm: dict = {}
        self._stats: dict = {}
        self.plan_cache = PlanCache(maxsize=plan_cache_size)
        # graphs at or above dist_edge_threshold directed edges run their
        # vlftj plans through dist.PartitionedJoin (granularity-factor
        # over-partitioning); None disables the route entirely.
        self.dist_edge_threshold = dist_edge_threshold
        self.dist_workers = dist_workers
        self.dist_granularity = dist_granularity
        self.last_dist_stats: dict | None = None
        self._dist_joins: dict = {}
        # open enumeration cursors: token -> (cursor, engine label, plan),
        # LRU-capped at max_open_cursors so abandoned paginations (a
        # client that never follows next_cursor) cannot accumulate
        # frontier arrays for the life of the server.  _closed remembers
        # *why* a token is gone ('evicted' vs 'exhausted') so the resume
        # error can tell a client whether restarting pagination would
        # help — an evicted stream is restartable, an exhausted one was
        # fully delivered (bounded: tokens are monotonic, keep the tail)
        self.page_rows = page_rows
        self.max_open_cursors = max_open_cursors
        self._cursors: "OrderedDict[str, tuple[ResultCursor, str, JoinPlan]]" \
            = OrderedDict()
        self._closed: "OrderedDict[str, str]" = OrderedDict()
        self._close_reasons: dict[str, int] = {}
        self._cursor_seq = 0

    def _close_cursor(self, token: str, reason: str) -> None:
        """Drop a registry entry, remembering *why* (``'exhausted'`` |
        ``'evicted'`` | ``'quota'``) for the resume-error message and
        the ``cursor_info()`` tallies."""
        self._cursors.pop(token, None)
        self._closed[token] = reason
        self._close_reasons[reason] = self._close_reasons.get(reason, 0) + 1
        self.metrics_registry.counter("server_cursor_closed",
                                      reason=reason).inc()
        while len(self._closed) > 4 * self.max_open_cursors:
            self._closed.popitem(last=False)

    def _register_cursor(self, payload, label: str, plan: JoinPlan | None,
                         token: str | None = None) -> str:
        """Park a payload (pagination cursor or a scheduler
        :class:`~repro_torch.serve.scheduler.PlanSnapshot`) in the LRU
        registry; the oldest entries are evicted past
        ``max_open_cursors`` with reason ``'evicted'``."""
        if token is None:
            self._cursor_seq += 1
            token = f"cur-{self._cursor_seq}"
        self._cursors[token] = (payload, label, plan)
        self._cursors.move_to_end(token)
        while len(self._cursors) > self.max_open_cursors:
            self._close_cursor(next(iter(self._cursors)), "evicted")
        return token

    def cursor_info(self) -> dict:
        """Registry observability: open-entry count and closed-token
        reason tallies — surfaced in every ``QueryResult.stats``."""
        return {"open": len(self._cursors),
                "closed": dict(self._close_reasons)}

    def _result_stats(self, engine_stats: dict | None = None) -> dict:
        out = {"plan_cache": self.plan_cache_info(),
               "cursors": self.cursor_info()}
        if engine_stats is not None:
            out["engine"] = engine_stats
        return out

    def metrics(self) -> dict:
        """Snapshot of the server's :class:`~repro_torch.obs.MetricsRegistry`:
        every counter/gauge/histogram series as ``"name{labels}" ->
        value`` (the full catalog is docs/OBSERVABILITY.md).  Level
        gauges (open cursors, plan-cache size) are refreshed here, so a
        snapshot is always current."""
        reg = self.metrics_registry
        reg.gauge("server_open_cursors").set(len(self._cursors))
        reg.gauge("server_plan_cache_size").set(len(self.plan_cache))
        reg.counter("server_metrics_snapshots").inc()
        return reg.snapshot()

    # -- request log ---------------------------------------------------------
    def _next_trace_id(self) -> str:
        with self._log_lock:
            self._request_seq += 1
            return f"req-{self._request_seq}"

    def _log_request(self, trace_id: str, req: QueryRequest,
                     t0: float, result: QueryResult | None = None,
                     error: Exception | None = None) -> None:
        """Append one JSON line to the structured request log.

        The line carries the generated ``trace_id`` — the same id
        stamped into the request's trace/profile meta — so a log entry
        joins to its exported trace artifact.  No-op when the server has
        no ``request_log``.
        """
        if self.request_log is None:
            return
        rec = {"ts": round(time.time(), 3), "trace_id": trace_id,
               "query": req.query_name, "tenant": req.tenant,
               "status": "ok" if error is None else "error",
               "latency_s": round((result.latency_s if result is not None
                                   else time.perf_counter() - t0), 6),
               "engine": (result.engine if result is not None
                          else req.engine)}
        if result is not None:
            rec["count"] = result.count
            rec["plan_cached"] = bool(result.plan_cached)
            if result.next_cursor is not None:
                rec["next_cursor"] = result.next_cursor
            rec["traced"] = result.trace is not None
            if result.profile is not None:
                prof = result.profile
                rec["profile"] = {
                    "jit_compiles": prof.jit["compiles"],
                    "jit_calls": prof.jit["calls"],
                    "compile_wall_s": round(prof.jit["compile_wall_s"], 6),
                    "peak_live_bytes": prof.memory["peak_live_bytes"]}
        if error is not None:
            rec["error"] = f"{type(error).__name__}: {error}"
        self.metrics_registry.counter("server_requests",
                                      status=rec["status"]).inc()
        line = json.dumps(rec)
        with self._log_lock:
            with open(self.request_log, "a") as f:
                f.write(line + "\n")

    def _routes_to_dist(self, plan: JoinPlan, gdb: GraphDB) -> bool:
        return (self.dist_edge_threshold is not None
                and plan.engine == "vlftj"
                and gdb.csr.n_edges >= self.dist_edge_threshold)

    def _dist_join_for(self, plan: JoinPlan, gdb: GraphDB,
                       req: QueryRequest):
        """Memoized per (plan, graph): the seed-domain sort and the part
        schedule amortize over same-plan request groups."""
        from ..dist.sharded_join import PartitionedJoin
        # count and rows plans for one query differ only in output_mode,
        # which the partition layer never reads — share one instance
        key = (plan.query.atoms, plan.query.filters, plan.gao, id(gdb))
        pj = self._dist_joins.get(key)
        if pj is None:
            pj = PartitionedJoin(get_query(req.query_name), gdb,
                                 n_workers=self.dist_workers,
                                 granularity=self.dist_granularity,
                                 plan=plan)
            self._dist_joins[key] = pj
        return pj

    def _execute_plan(self, plan: JoinPlan, gdb: GraphDB,
                      req: QueryRequest) -> tuple[int, str, dict]:
        """(count, engine label, normalized engine stats); large graphs
        take the partitioned path."""
        with span("server.execute") as rec:
            if self._routes_to_dist(plan, gdb):
                pj = self._dist_join_for(plan, gdb, req)
                c = pj.count()
                self.last_dist_stats = pj.stats
                label = plan.engine + "+partitioned"
                stats = normalize_engine_stats(label, pj.stats)
            else:
                c, stats = engine_mod.execute_stats(plan, gdb)
                label = plan.engine
            if rec is not None:
                rec.attrs["engine"] = label
                if "spmvs" in stats["raw"]:
                    rec.attrs["spmvs"] = stats["raw"]["spmvs"]
        return c, label, stats

    def _gdb_for(self, selectivity: float, seed: int) -> GraphDB:
        key = (round(selectivity, 6), seed)
        if key not in self._warm:
            # the server builds its one copy of the edge tensors for its
            # first warm graph (on whichever engine call first reads
            # them); every later warm graph shares that copy
            edges = "shared" if self._warm else "built"
            with span("server.sample", selectivity=selectivity, seed=seed,
                      edges=edges):
                unary = {f"v{i}": node_sample(self.csr.n_nodes, selectivity,
                                              seed=seed * 7 + i)
                         for i in range(1, 5)}
                self._warm[key] = GraphDB(self.csr, unary,
                                          device=self.device,
                                          edges=self._edges)
            self.metrics_registry.counter("server_warm_graphs",
                                          edges=edges).inc()
        return self._warm[key]

    def _stats_for(self, gdb: GraphDB) -> GraphStats:
        key = id(gdb)
        if key not in self._stats:
            with span("server.stats"):
                self._stats[key] = GraphStats.of(gdb)
        return self._stats[key]

    def _plan_for(self, req: QueryRequest, gdb: GraphDB,
                  output: str = "count") -> tuple[JoinPlan, bool]:
        """(plan, was_cache_hit) for one request.

        Every served plan passes static verification
        (:func:`repro_torch.analysis.verify_for_execution`) before
        dispatch; a :class:`repro_torch.analysis.PlanVerificationError`
        propagates to
        the request's error result.  Verification memoizes on
        ``(plan, stats fingerprint)``, so cache hits re-verify at dict
        cost."""
        from ..analysis import verify_for_execution
        q = get_query(req.query_name)
        stats = self._stats_for(gdb)
        hits_before = self.plan_cache.hits
        with span("server.plan") as rec:
            plan = self.plan_cache.get_or_plan(q, stats, req.engine,
                                               output=output)
            hit = self.plan_cache.hits > hits_before
            if rec is not None:
                rec.attrs["hit"] = hit
        self.metrics_registry.counter(
            "server_plan_cache", outcome="hit" if hit else "miss").inc()
        with span("server.verify"):
            verify_for_execution(plan, gdb)
        return plan, hit

    def plan_cache_info(self) -> dict:
        return {"hits": self.plan_cache.hits,
                "misses": self.plan_cache.misses,
                "size": len(self.plan_cache)}

    # -- enumeration / pagination -------------------------------------------
    def _open_cursor(self, plan: JoinPlan, gdb: GraphDB,
                     req: QueryRequest) -> tuple[ResultCursor, str]:
        """(cursor, engine label); large graphs stream the merged
        per-part pages of the partitioned join."""
        q = get_query(req.query_name)
        if self._routes_to_dist(plan, gdb):
            pj = self._dist_join_for(plan, gdb, req)
            cur = ResultCursor.from_blocks(
                pj.executor.gao, pj.pages(page_rows=self.page_rows),
                page_rows=self.page_rows)
            return cur, plan.engine + "+partitioned"
        return engine_mod.stream(q, gdb, plan=plan,
                                 page_rows=self.page_rows), plan.engine

    def _rows_result(self, req: QueryRequest, cur: ResultCursor,
                     label: str, plan: JoinPlan | None, cached: bool,
                     token: str | None, t0: float,
                     trace_id: str | None = None) -> QueryResult:
        # per-page profile: the final-level calls and the expansion
        # (segment_outer) run inside take(), so the activation brackets it
        prof = (DeviceProfile(req.query_name, label) if req.profile
                else None)
        with contextlib.ExitStack() as stack:
            if prof is not None:
                stack.enter_context(prof.activate())
            page = cur.take(req.limit if req.limit is not None
                            else self.page_rows)
        if prof is not None:
            prof.set_meta(engine=label, tenant=req.tenant,
                          trace_id=trace_id)
            prof.publish(registry=self.metrics_registry)
        if cur.exhausted:
            if token is not None:
                self._close_cursor(token, "exhausted")
            token = None
        else:
            token = self._register_cursor(cur, label, plan, token=token)
        return QueryResult(req, int(page.shape[0]), label,
                           time.perf_counter() - t0, plan=plan,
                           plan_cached=cached, rows=page, row_vars=cur.vars,
                           next_cursor=token, stats=self._result_stats(),
                           profile=prof)

    def execute(self, req: QueryRequest) -> QueryResult:
        """Run one request to completion (or to one cursor page).

        Args:
            req: count requests (no ``limit``/``cursor``) return the
                pattern count; ``limit=`` requests return one page of
                rows plus a ``next_cursor`` continuation token;
                ``cursor=`` requests resume a parked server-side cursor
                (``limit`` then sizes the page).

        Returns:
            A :class:`QueryResult`; ``stats`` carries the plan-cache
            counters and cursor-registry state at response time.

        Raises:
            ValueError: resuming a dead cursor token.  The message says
                why it died: ``evicted`` (LRU aged it out — restart
                pagination from the first page), ``exhausted`` (fully
                delivered — do not restart), or ``unknown`` (never
                issued, or aged out of the closed-token memory).
            KeyError: unknown ``query_name``.

        Example::

            r = server.execute(QueryRequest("3-path", limit=100))
            while r.next_cursor is not None:
                r = server.execute(QueryRequest(
                    "3-path", limit=100, cursor=r.next_cursor))

        For preemptive, fair scheduling of *concurrent* requests use
        :meth:`execute_concurrent` instead — this method runs a single
        request to completion and a heavy one will block the caller.
        """
        t0 = time.perf_counter()
        trace_id = self._next_trace_id()
        try:
            with span("server.request", request=trace_id,
                      query=req.query_name):
                res = self._execute_impl(req, t0, trace_id)
        except Exception as e:
            self._log_request(trace_id, req, t0, error=e)
            raise
        self._log_request(trace_id, req, t0, result=res)
        return res

    def _execute_impl(self, req: QueryRequest, t0: float,
                      trace_id: str) -> QueryResult:
        if req.cursor is not None:
            try:
                cur, label, plan = self._cursors[req.cursor]
            except KeyError:
                reason = self._closed.get(req.cursor)
                if reason == "evicted":
                    raise ValueError(
                        f"evicted cursor {req.cursor!r}: the server keeps "
                        f"at most {self.max_open_cursors} open cursors and "
                        "this one aged out — restart pagination from the "
                        "first page") from None
                if reason == "exhausted":
                    raise ValueError(
                        f"exhausted cursor {req.cursor!r}: the result set "
                        "was fully delivered; do not restart") from None
                raise ValueError(
                    f"unknown cursor {req.cursor!r}") from None
            return self._rows_result(req, cur, label, plan, True,
                                     req.cursor, t0, trace_id)
        sel = req.selectivity or self.default_selectivity
        gdb = self._gdb_for(sel, req.seed)
        if req.wants_rows:
            plan, cached = self._plan_for(req, gdb, output="rows")
            cur, label = self._open_cursor(plan, gdb, req)
            return self._rows_result(req, cur, label, plan, cached,
                                     None, t0, trace_id)
        plan, cached = self._plan_for(req, gdb)
        if req.trace or req.profile:
            tr = (QueryTrace(req.query_name, plan.gao, plan.engine)
                  if req.trace else None)
            prof = (DeviceProfile(req.query_name, plan.engine)
                    if req.profile else None)
            with contextlib.ExitStack() as stack:
                if tr is not None:
                    stack.enter_context(tr.activate())
                if prof is not None:
                    stack.enter_context(prof.activate())
                c, label, estats = self._execute_plan(plan, gdb, req)
            if tr is not None:
                tr.set_meta(engine=label, tenant=req.tenant,
                            plan_cached=cached, trace_id=trace_id)
            if prof is not None:
                prof.set_meta(engine=label, tenant=req.tenant,
                              trace_id=trace_id)
                prof.publish(trace=tr, registry=self.metrics_registry)
            return QueryResult(req, c, label, time.perf_counter() - t0,
                               plan=plan, plan_cached=cached,
                               stats=self._result_stats(estats), trace=tr,
                               profile=prof)
        c, label, estats = self._execute_plan(plan, gdb, req)
        return QueryResult(req, c, label, time.perf_counter() - t0,
                           plan=plan, plan_cached=cached,
                           stats=self._result_stats(estats))

    def execute_batch(self, reqs: list[QueryRequest]) -> list[QueryResult]:
        """Run a batch sequentially, sorted by (selectivity, seed) so
        consecutive requests share a warm device graph.

        Args:
            reqs: any mix of count / enumeration / cursor requests.

        Returns:
            Results in the *original* request order (the warm-graph
            sort is internal).

        Each request still runs to completion before the next starts —
        no cross-request fairness.  Prefer :meth:`execute_many` for
        plan-grouped throughput, :meth:`execute_concurrent` for
        fairness under mixed light/heavy load.
        """
        # group by (selectivity, seed) so the device graph stays warm
        order = sorted(range(len(reqs)),
                       key=lambda i: (reqs[i].selectivity or 0,
                                      reqs[i].seed))
        results: list[QueryResult | None] = [None] * len(reqs)
        for i in order:
            results[i] = self.execute(reqs[i])
        return results  # type: ignore

    def execute_many(self, reqs: list[QueryRequest]) -> list[QueryResult]:
        """Plan-grouped batched execution (throughput-optimized).

        Requests are planned first (warming the plan cache), then grouped
        by (plan, graph) and executed group-by-group: consecutive
        executions of the same plan run back to back, and the device
        graph stays warm within a group.  Enumeration requests
        (``limit=``) plan with ``output='rows'`` and group the same way;
        cursor continuations already hold their machinery and run
        directly.

        Args:
            reqs: the batch; order of the returned results matches it.

        Returns:
            One :class:`QueryResult` per request; ``latency_s`` matches
            :meth:`execute` semantics (planning share + execution).

        Like :meth:`execute_batch` this optimizes *throughput*, not
        fairness — a heavy group member still runs to completion.  See
        :meth:`execute_concurrent` for quantum-sliced fairness.
        """
        prepared = []   # (index, plan, cached, gdb, plan_s)
        results: list[QueryResult | None] = [None] * len(reqs)
        for i, req in enumerate(reqs):
            if req.cursor is not None:
                results[i] = self.execute(req)
                continue
            sel = req.selectivity or self.default_selectivity
            gdb = self._gdb_for(sel, req.seed)
            t0 = time.perf_counter()
            plan, cached = self._plan_for(
                req, gdb, output="rows" if req.wants_rows else "count")
            prepared.append((i, plan, cached, gdb,
                             time.perf_counter() - t0))
        # same-plan requests become adjacent; ties keep graph groups warm
        groups: dict[tuple, list] = {}
        for item in prepared:
            groups.setdefault((item[1], id(item[3])), []).append(item)
        for (_plan, _gid), items in groups.items():
            for i, plan, cached, gdb, plan_s in items:
                t0 = time.perf_counter()
                if reqs[i].wants_rows:
                    cur, label = self._open_cursor(plan, gdb, reqs[i])
                    results[i] = self._rows_result(
                        reqs[i], cur, label, plan, cached, None,
                        t0 - plan_s)
                    continue
                c, label, estats = self._execute_plan(plan, gdb, reqs[i])
                # latency_s matches execute(): planning share + execution
                results[i] = QueryResult(
                    reqs[i], c, label,
                    plan_s + time.perf_counter() - t0,
                    plan=plan, plan_cached=cached,
                    stats=self._result_stats(estats))
        return results  # type: ignore

    def execute_concurrent(self, reqs: list[QueryRequest],
                           quantum_rows: int = 8192,
                           policy: str = "quantum",
                           quotas: dict | None = None,
                           collect_rows: bool = True
                           ) -> list[QueryResult]:
        """Fairness-optimized concurrent execution (preemptive).

        Admits every request into a
        :class:`~repro_torch.serve.scheduler.QuantumScheduler` and round-robins
        quanta of ``quantum_rows`` expanded rows across them, so N small
        queries do not queue behind one heavy enumeration.  Per-tenant
        quotas (``req.tenant``) gate admission; a request rejected
        429-style comes back as a result with ``engine='rejected'`` and
        ``stats['status'] == 429`` instead of raising, so batch callers
        keep positional correspondence.

        Args:
            reqs: the concurrent batch (no ``cursor=`` continuations —
                those resume directly via :meth:`execute`).
            quantum_rows: the scheduling quantum, in expanded rows.
            policy: ``'quantum'`` (preemptive) or ``'fifo'`` (baseline).
            quotas: per-tenant ``{name: TenantQuota}`` overrides.
            collect_rows: buffer enumeration pages into results (False
                streams-and-discards, keeping memory bounded).

        Returns:
            Results in request order; scheduling stats (``quanta``,
            ``preemptions``, ``rows_expanded``, virtual clocks) ride in
            each ``QueryResult.stats``.
        """
        from .scheduler import AdmissionError, QuantumScheduler
        sched = QuantumScheduler(self, quantum_rows=quantum_rows,
                                 policy=policy, quotas=quotas)
        rejected: dict[int, QueryResult] = {}
        order: list[str] = []
        for i, req in enumerate(reqs):
            try:
                order.append(sched.submit(req, collect_rows=collect_rows))
            except AdmissionError as e:
                order.append("")
                rejected[i] = QueryResult(
                    req, 0, "rejected", 0.0,
                    stats={"status": e.status, "error": str(e)})
        sched.run()
        return [rejected[i] if tok == "" else sched.result(tok)
                for i, tok in enumerate(order)]
