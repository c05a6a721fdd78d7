"""Query tracing: a span tree keyed by the plan's GAO levels (a copy of
``repro.obs.trace``).

The paper's central claim — WCOJ engines win because per-level
intersection work tracks the *actual* intermediate cardinalities — is
exactly what a :class:`QueryTrace` records: per GAO level, the planner's
estimated frontier cardinality next to the observed one (plus the kernel
path taken, rows expanded, and wall time), and a timeline of execution
events (scheduler preempt/resume/restart, cross-shard exchanges, worker
spans).

Capture is deliberately cheap: every number a trace records is already
host-resident when it is recorded — frontier shapes between level
steps, engine ``stats`` dict counters, exchange meters — so tracing adds
**zero device dispatches** (asserted in ``tests/test_torch_obs.py``).  The
engines publish per-level observations into their own ``stats`` dicts
unconditionally (plain dict writes); a trace harvests them after the run
via :meth:`QueryTrace.record_engine`.  Cross-cutting components
(scheduler, dist drivers, pool) find the active trace through a
contextvar — :func:`current_trace` — so no signature threading is
needed, and a ``None`` answer costs one attribute read.

Export: :meth:`QueryTrace.to_jsonl` renders the trace as one JSON object
per line (header, level records, events, spans, summary) so benches and
CI can diff runs; :meth:`QueryTrace.from_jsonl` round-trips it.  The
line schema is documented in ``docs/OBSERVABILITY.md``.

Beside the per-request trace sits the **process span log**
(:class:`SpanLog`, :func:`span`): named host intervals inside the query
server, the scheduler and ``GraphDB`` on ``time.perf_counter_ns``'s
clock, the clock a device trace can be mapped onto.  It is off unless a
caller opens a log; a closed log costs each :func:`span` call one global
read.  Its records never enter a :class:`QueryTrace`.
"""
from __future__ import annotations

import contextlib
import contextvars
import json
import math
import threading
import time

#: JSONL schema version stamped into every trace header.
TRACE_SCHEMA_VERSION = 1

_ACTIVE: contextvars.ContextVar["QueryTrace | None"] = \
    contextvars.ContextVar("repro_torch_obs_active_trace", default=None)


def current_trace() -> "QueryTrace | None":
    """The trace active in this context, or None (tracing disabled)."""
    return _ACTIVE.get()


def qerror(est: float, obs: float) -> float:
    """The symmetric Q-error ``max(est/obs, obs/est)`` — 1.0 is a
    perfect estimate; both-zero counts as perfect; one-sided zero is
    ``inf`` (the estimate missed an empty/non-empty transition)."""
    est, obs = float(est), float(obs)
    if est <= 0.0 and obs <= 0.0:
        return 1.0
    if est <= 0.0 or obs <= 0.0:
        return math.inf
    return max(est / obs, obs / est)


class QueryTrace:
    """One query execution's observability record.

    Three record kinds accumulate, all timestamped relative to trace
    creation (``t`` seconds):

    * **levels** — one dict per GAO level (upserted, so a resumed run
      refines its earlier record): ``level``, ``var``, ``est_rows``,
      ``obs_rows``, ``q_error``, ``rows_expanded``, ``kernel`` (path
      rows by strategy: array/bitset tile-vs-bsearch), ``wall_s``;
    * **events** — point occurrences: ``preempt``, ``resume``,
      ``restart`` (registry eviction), ``exchange`` (cross-shard
      adjacency traffic), ``admission_rejected``, …;
    * **spans** — named durations (``begin_span``/``end`` or the
      :meth:`span` context manager): quanta, pool worker drains,
      plan/execute phases.

    ``meta`` carries query/gao/engine identification; ``summary`` the
    final count and totals.  :meth:`activate` installs the trace as the
    context's current trace for the duration of a ``with`` block.
    """

    enabled = True

    def __init__(self, query_name: str = "", gao: tuple[str, ...] = (),
                 engine: str = ""):
        self.meta = {"query": query_name, "gao": list(gao),
                     "engine": engine, "schema": TRACE_SCHEMA_VERSION}
        self.levels: dict[int, dict] = {}
        self.events: list[dict] = []
        self.spans: list[dict] = []
        self.summary: dict = {}
        self._t0 = time.perf_counter()

    # -- recording -----------------------------------------------------------
    def _now(self) -> float:
        return round(time.perf_counter() - self._t0, 6)

    def set_meta(self, **kw) -> None:
        self.meta.update(kw)

    def level(self, level: int, **attrs) -> dict:
        """Upsert the per-level record; recomputes ``q_error`` whenever
        both ``est_rows`` and ``obs_rows`` are known."""
        rec = self.levels.setdefault(int(level), {"level": int(level)})
        rec.update({k: v for k, v in attrs.items() if v is not None})
        if "est_rows" in rec and "obs_rows" in rec:
            rec["q_error"] = qerror(rec["est_rows"], rec["obs_rows"])
        return rec

    def event(self, name: str, **attrs) -> dict:
        rec = {"name": name, "t": self._now(), **attrs}
        self.events.append(rec)
        return rec

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """``with trace.span("quantum", job=...):`` — records the
        duration on exit (exceptions still close the span)."""
        t0 = time.perf_counter()
        rec = {"name": name, "t": self._now(), **attrs}
        try:
            yield rec
        finally:
            rec["dur_s"] = round(time.perf_counter() - t0, 6)
            self.spans.append(rec)

    def record_engine(self, stats: dict,
                      gao: tuple[str, ...] = (),
                      est_rows: tuple[float, ...] = ()) -> None:
        """Harvest an engine ``stats`` dict (the unified namespace —
        ``repro_torch.obs.schema``) into per-level records.

        ``stats['level_rows']`` maps GAO level -> observed frontier
        cardinality (the final level's entry is the output count on the
        counting path), ``level_wall_s`` / ``level_paths`` the per-level
        timings and kernel-path row tallies.  ``est_rows`` is the
        plan's ``level_est_rows`` annotation.
        """
        level_rows = stats.get("level_rows", {}) or {}
        walls = stats.get("level_wall_s", {}) or {}
        paths = stats.get("level_paths", {}) or {}
        n = max([len(gao), len(est_rows),
                 *(int(lv) + 1 for lv in level_rows)], default=0)
        for lv in range(n):
            self.level(
                lv,
                var=gao[lv] if lv < len(gao) else None,
                est_rows=(float(est_rows[lv]) if lv < len(est_rows)
                          else None),
                obs_rows=(int(level_rows[lv]) if lv in level_rows
                          else None),
                wall_s=walls.get(lv),
                kernel=paths.get(lv))

    def finish(self, count: int | None = None, **kw) -> None:
        self.summary.update({"wall_s": self._now(), **kw})
        if count is not None:
            self.summary["count"] = int(count)

    # -- context activation --------------------------------------------------
    @contextlib.contextmanager
    def activate(self):
        """Install as :func:`current_trace` for the block's duration."""
        token = _ACTIVE.set(self)
        try:
            yield self
        finally:
            _ACTIVE.reset(token)

    # -- derived views -------------------------------------------------------
    @property
    def max_q_error(self) -> float:
        qs = [rec["q_error"] for rec in self.levels.values()
              if "q_error" in rec]
        return max(qs) if qs else 1.0

    def events_named(self, name: str) -> list[dict]:
        return [e for e in self.events if e["name"] == name]

    # -- export --------------------------------------------------------------
    def to_dict(self) -> dict:
        return {"meta": dict(self.meta),
                "levels": [self.levels[lv] for lv in sorted(self.levels)],
                "events": list(self.events),
                "spans": list(self.spans),
                "summary": dict(self.summary)}

    def to_jsonl(self, path: str | None = None) -> str:
        """One JSON object per line: ``header``, ``level`` (GAO order),
        ``event`` / ``span`` (chronological), ``summary``.  Writes to
        ``path`` when given; returns the text either way."""
        def _clean(obj):
            if isinstance(obj, dict):
                return {str(k): _clean(v) for k, v in obj.items()}
            if isinstance(obj, (list, tuple)):
                return [_clean(v) for v in obj]
            if isinstance(obj, float):
                if math.isinf(obj):
                    return "inf" if obj > 0 else "-inf"
                if math.isnan(obj):
                    return "nan"
                return obj
            if hasattr(obj, "item"):      # numpy scalars
                return obj.item()
            return obj

        lines = [json.dumps({"kind": "header", **_clean(self.meta)})]
        for lv in sorted(self.levels):
            lines.append(json.dumps(
                {"kind": "level", **_clean(self.levels[lv])}))
        for e in self.events:
            lines.append(json.dumps({"kind": "event", **_clean(e)}))
        for s in self.spans:
            lines.append(json.dumps({"kind": "span", **_clean(s)}))
        lines.append(json.dumps({"kind": "summary",
                                 **_clean(self.summary)}))
        text = "\n".join(lines) + "\n"
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    @classmethod
    def from_jsonl(cls, text) -> "QueryTrace":
        """Rebuild a trace from :meth:`to_jsonl` output — the JSONL text
        itself or a path to it (timestamps and records preserved; the
        clock origin is not)."""
        import os
        if isinstance(text, os.PathLike):
            with open(text) as f:
                text = f.read()
        tr = cls()
        for line in text.splitlines():
            if not line.strip():
                continue
            rec = json.loads(line)
            kind = rec.pop("kind")
            if kind == "header":
                tr.meta = rec
            elif kind == "level":
                tr.levels[int(rec["level"])] = rec
            elif kind == "event":
                tr.events.append(rec)
            elif kind == "span":
                tr.spans.append(rec)
            elif kind == "summary":
                tr.summary = rec
        return tr


class NullTrace:
    """The disabled tracer: every recording method is a no-op and
    :attr:`enabled` is False, so call sites can skip building
    attributes.  ``NullTrace`` is never installed as the context's
    current trace — ``current_trace() is None`` is the normal
    disabled-path check — but code handed a trace object directly can
    take this instead of branching on None."""

    enabled = False

    def set_meta(self, **kw):
        pass

    def level(self, level, **attrs):
        return {}

    def event(self, name, **attrs):
        return {}

    @contextlib.contextmanager
    def span(self, name, **attrs):
        yield {}

    def record_engine(self, stats, gao=(), est_rows=()):
        pass

    def finish(self, count=None, **kw):
        pass

    @contextlib.contextmanager
    def activate(self):
        yield self


NULL_TRACE = NullTrace()


# ---------------------------------------------------------------------------
# the process span log
# ---------------------------------------------------------------------------

#: records a :class:`SpanLog` keeps; later spans are dropped and counted
SPAN_LOG_CAP = 1 << 20

#: the open log, or None (every :func:`span` is then the no-op)
_SPAN_LOG: "SpanLog | None" = None


class SpanRecord:
    """One span of the process log, and the context manager that times
    it.  ``start_ns``/``end_ns`` are ``time.perf_counter_ns`` readings
    (``end_ns`` is None while the span is open); ``parent`` is the
    ``id`` of the span open around it on the same thread; ``request``
    is the id given to it or, failing that, its parent's."""

    __slots__ = ("id", "name", "start_ns", "end_ns", "parent", "request",
                 "attrs", "_log")

    def __init__(self, log: "SpanLog", rid: int, name: str,
                 request: str | None, attrs: dict):
        self._log = log
        self.id = rid
        self.name = name
        self.request = request
        self.attrs = attrs
        self.parent: int | None = None
        self.start_ns = 0
        self.end_ns: int | None = None

    def __enter__(self) -> "SpanRecord":
        stack = self._log._stack()
        if stack:
            top = stack[-1]
            self.parent = top.id
            if self.request is None:
                self.request = top.request
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        self._log._stack().remove(self)

    def to_dict(self) -> dict:
        return {"id": self.id, "name": self.name, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "parent": self.parent,
                "request": self.request, "attrs": dict(self.attrs)}


#: what :func:`span` returns while no log is open (its ``with`` target
#: is None)
_NO_SPAN = contextlib.nullcontext()


class SpanLog:
    """The process span log: every :func:`span` entered while it is
    open, in memory, in the order they were entered.

    Opened and closed by its caller, once::

        log = SpanLog()
        with log.recording():
            server.execute(QueryRequest("3-path"))
        for rec in log.records:
            print(rec.name, rec.end_ns - rec.start_ns, rec.attrs)

    At most :data:`SPAN_LOG_CAP` records are kept; spans past it are not
    recorded and are counted in ``dropped``.  One log is open at a
    time."""

    def __init__(self):
        self.records: list[SpanRecord] = []
        self.dropped = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, name: str, request: str | None, attrs: dict):
        with self._lock:
            if len(self.records) >= SPAN_LOG_CAP:
                self.dropped += 1
                return _NO_SPAN
            rec = SpanRecord(self, len(self.records), name, request, attrs)
            self.records.append(rec)
        return rec

    @property
    def is_open(self) -> bool:
        return _SPAN_LOG is self

    def open(self) -> "SpanLog":
        global _SPAN_LOG
        if _SPAN_LOG is not None and _SPAN_LOG is not self:
            raise RuntimeError("another SpanLog is open")
        _SPAN_LOG = self
        return self

    def close(self) -> None:
        global _SPAN_LOG
        if _SPAN_LOG is self:
            _SPAN_LOG = None

    @contextlib.contextmanager
    def recording(self):
        """Open the log for the block's duration."""
        self.open()
        try:
            yield self
        finally:
            self.close()


def span(name: str, request: str | None = None, **attrs):
    """``with span("server.plan") as rec:`` — a span of the open
    :class:`SpanLog`, whose ``rec.attrs`` the block may add to; with no
    log open, the shared no-op (``rec`` is None) after one global
    read."""
    log = _SPAN_LOG
    if log is None:
        return _NO_SPAN
    return log._record(name, request, attrs)
