"""The unified ``QueryResult.stats`` engine namespace (a copy of
``repro.obs.schema``).

Each engine historically grew its own counter names (``ll_calls``,
``bitset_rows``, ``spmvs``, ``probes``, …).  Those raw names survive —
benches and tests key on them — but every engine path now *also* emits
one documented core schema, produced by :func:`normalize_engine_stats`
and carried under ``stats["engine"]`` in server results:

==================  =====================================================
key                 meaning
==================  =====================================================
``name``            the physical operator that ran ('vlftj', …)
``rows_expanded``   partial bindings fed into level expansion (the
                    quantum scheduler's work unit)
``frontier_peak``   largest materialized frontier (rows)
``kernel_dispatches``  device kernel launches (vlftj ``chunks``;
                    host-only engines report 0)
``jit_calls``       final-level calls (``ll_calls``)
``jit_compiles``    final-level compiles (``ll_compiles``; always 0 in
                    the port, which compiles nothing per shape)
``level_rows``      GAO level -> observed frontier cardinality (the
                    "obs" side of per-level Q-error)
``level_wall_s``    GAO level -> host wall seconds spent in the level
``level_paths``     GAO level -> kernel path row tallies
                    ({'bitset'|'tile'|'bsearch': rows})
``raw``             the engine's native counters, untouched
==================  =====================================================

``tests/test_torch_obs.py`` holds every engine path's dict equal to
the JAX package's; the full catalog (including the scheduler and
cursor groups) is ``docs/OBSERVABILITY.md``.
"""
from __future__ import annotations

#: every normalized engine-stats dict carries exactly these keys.
ENGINE_REQUIRED_KEYS = ("name", "rows_expanded", "frontier_peak",
                        "kernel_dispatches", "jit_calls", "jit_compiles",
                        "level_rows", "level_wall_s", "level_paths", "raw")

#: the schema keys an engine must *source* natively (everything else
#: has a total default in :func:`normalize_engine_stats`): without
#: ``rows_expanded`` the quantum scheduler cannot meter the engine, and
#: without ``level_rows`` per-level Q-error has no "obs" side.  The
#: ``engine-stats-keys`` lint pass (``tools/lint_repro.py``) requires
#: both in every engine's ``self.stats`` dict literal (in the JAX
#: package; the port's engines copy those literals).
ENGINE_STATS_SOURCE_KEYS = ("rows_expanded", "level_rows")


def normalize_engine_stats(name: str, stats: dict | None) -> dict:
    """Project an engine's native ``stats`` dict onto the unified schema.

    Total: every engine (including one with no native stats at all) maps
    to a dict with all :data:`ENGINE_REQUIRED_KEYS`; native counters
    survive under ``raw``.
    """
    raw = dict(stats or {})
    return {
        "name": name,
        "rows_expanded": int(raw.get("rows_expanded", 0)),
        "frontier_peak": int(raw.get("frontier_peak",
                                     raw.get("max_intermediate", 0))),
        "kernel_dispatches": int(raw.get("chunks", 0)),
        "jit_calls": int(raw.get("ll_calls", 0)),
        "jit_compiles": int(raw.get("ll_compiles", 0)),
        "level_rows": {int(k): int(v)
                       for k, v in (raw.get("level_rows") or {}).items()},
        "level_wall_s": {int(k): float(v)
                         for k, v in (raw.get("level_wall_s")
                                      or {}).items()},
        "level_paths": {int(k): dict(v)
                        for k, v in (raw.get("level_paths")
                                     or {}).items()},
        "raw": raw,
    }
