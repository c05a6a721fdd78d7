"""Observability of the port: query tracing, EXPLAIN ANALYZE, process
metrics and device profiles (the port of ``repro.obs``).

Five pieces (see ``docs/OBSERVABILITY.md`` for the full walkthrough):

* :class:`QueryTrace` / :func:`current_trace` — one query's span tree
  keyed by GAO levels: est-vs-observed frontier cardinality + Q-error
  per level, kernel paths, scheduler preempt/resume/restart events,
  cross-shard exchange traffic; JSONL export via ``to_jsonl``.
* :func:`explain_analyze` — run a query under a fresh trace and render
  the annotated plan tree.
* :class:`MetricsRegistry` / :func:`get_registry` — process-wide
  counters/gauges/histograms with labels, snapshotted by
  ``QueryServer.metrics()``.
* :class:`SpanLog` / :func:`span` — the process span log: named host
  spans inside the query server, the scheduler and ``GraphDB`` on
  ``time.perf_counter_ns``'s clock, recorded only while a caller holds
  a log open.
* :class:`DeviceProfile` / :func:`current_profile` — device-side
  resource accounting one layer below the trace: level-step dispatch
  counts, kernel-library builds, a per-kernel-family wall breakdown
  (``intersect`` / ``intersect_bitset`` / ``segment_outer``; CUDA
  events on the card), and the allocator's memory watermarks sampled at
  GAO level boundaries.

Tracing, metrics and profiling add no kernel launch and no
synchronisation (guarded by ``tests/test_torch_obs.py`` and the
``serve`` phase of ``chip_smoke.py``).  ``trace``, ``schema`` and
``metrics`` import no torch.
"""
from .explain import ExplainResult, explain_analyze
from .metrics import (Counter, DEFAULT_BUCKETS, Gauge, Histogram,
                      MetricsRegistry, get_registry)
from .profile import (DeviceProfile, KERNEL_FAMILIES, NULL_PROFILE,
                      NullProfile, PROFILE_SCHEMA_VERSION, current_profile)
from .schema import (ENGINE_REQUIRED_KEYS, ENGINE_STATS_SOURCE_KEYS,
                     normalize_engine_stats)
from .trace import (NULL_TRACE, SPAN_LOG_CAP, NullTrace, QueryTrace,
                    SpanLog, TRACE_SCHEMA_VERSION, current_trace, qerror,
                    span)

__all__ = [
    "Counter", "DEFAULT_BUCKETS", "DeviceProfile", "ENGINE_REQUIRED_KEYS",
    "ENGINE_STATS_SOURCE_KEYS",
    "ExplainResult", "Gauge", "Histogram", "KERNEL_FAMILIES",
    "MetricsRegistry", "NULL_PROFILE", "NULL_TRACE", "NullProfile",
    "NullTrace", "PROFILE_SCHEMA_VERSION", "QueryTrace", "SPAN_LOG_CAP",
    "SpanLog", "TRACE_SCHEMA_VERSION", "current_profile", "current_trace",
    "explain_analyze", "get_registry", "normalize_engine_stats", "qerror",
    "span",
]
