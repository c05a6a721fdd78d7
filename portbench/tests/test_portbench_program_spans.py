"""The readers of the program's spans (``warm_graph_build_s``,
``server_host_ms``) and the idle gaps named by them, on fabricated runs;
a traced CPU run of each cell reads its metric, and a ``--trace 0`` run
opens no span log."""
import sys
import time
import types

import pytest

from portbench import harness, program_spans
from portbench.measure import Run
from portbench.trace import Spans, Timeline
from portbench.traffic import Request

from conftest import ROOT, TINY

BENCH = harness.Bench(ROOT)
MS = 1_000_000
#: the window's opening and close, in ns, on the fabricated clock
OPEN, CLOSE = 1_000 * MS, 1_100 * MS


def rec(rid, name, start_ms, end_ms, parent=None, **attrs):
    return types.SimpleNamespace(id=rid, name=name, start_ns=start_ms * MS,
                                 end_ns=end_ms * MS, parent=parent,
                                 request=None, attrs=attrs)


def fake_run(requests=(), warm=(1,), items=(), timeline=None):
    spans = Spans()
    spans.items = list(items)
    return Run(cell={}, config={}, mix={}, seed=0, t_open=OPEN / 1e9,
               t_close=CLOSE / 1e9, setup_s=1.0, requests=list(requests),
               graph={}, warm_samples=list(warm), timeline=timeline,
               spans=spans)


def answered(sample, t_done_ms=1_050):
    return Request(0, "3-path", sample, t_due=OPEN / 1e9,
                   t_done=t_done_ms * MS / 1e9, count=1)


@pytest.fixture
def log(monkeypatch):
    """A log holding the records a test puts in it, which the readers
    open in place of the program's when they are loaded."""
    fake = types.SimpleNamespace(records=[], is_open=True,
                                 close=lambda: None)
    monkeypatch.setattr(program_spans, "_log", fake)
    monkeypatch.setattr(program_spans, "open_log", lambda: fake)
    return fake.records


def test_build_seconds_count_nested_spans_once(log):
    """A build inside the statistics span and a copy inside a build
    count once; a span before the opening not at all."""
    log += [rec(0, "graph.build", 990, 995, key="indices"),
            rec(1, "server.sample", 1_000, 1_010),
            rec(2, "server.stats", 1_010, 1_020),
            rec(3, "graph.build", 1_012, 1_018, parent=2, key="src_ids"),
            rec(4, "graph.build", 1_030, 1_050, key="indices"),
            rec(5, "graph.copy", 1_035, 1_045, parent=4),
            rec(6, "server.plan", 1_050, 1_060)]
    run = fake_run([answered(7), answered(8), answered(1)])
    read = BENCH.reader("warm_graph_build_s")
    assert read(run) == pytest.approx(0.040 / 2)


def test_build_seconds_end_at_the_last_reply(log):
    log += [rec(0, "graph.build", 1_040, 1_080, key="indices")]
    run = fake_run([answered(7, t_done_ms=1_060)])
    assert BENCH.reader("warm_graph_build_s")(run) == pytest.approx(0.020)


@pytest.mark.parametrize("case", ["no_spans", "no_fresh_sample", "no_log"])
def test_build_seconds_none_without_something_to_read(log, monkeypatch,
                                                      case):
    if case != "no_spans":
        log += [rec(0, "server.sample", 1_000, 1_010)]
    run = fake_run([answered(1 if case == "no_fresh_sample" else 7)])
    if case == "no_log":
        monkeypatch.setattr(program_spans, "_log", None)
    assert BENCH.reader("warm_graph_build_s")(run) is None


def test_host_ms_is_the_mean_submit_in_the_window(log):
    log += [rec(0, "sched.submit", 990, 1_001),          # before the opening
            rec(1, "sched.submit", 1_000, 1_002),
            rec(2, "server.plan", 1_000, 1_001, parent=1),
            rec(3, "sched.submit", 1_050, 1_054),
            rec(4, "sched.quantum", 1_054, 1_070),
            rec(5, "sched.submit", 1_100, 1_101)]        # after the close
    assert BENCH.reader("server_host_ms")(fake_run()) == pytest.approx(3.0)


def test_host_ms_none_without_a_submit(log):
    log += [rec(0, "sched.quantum", 1_000, 1_010)]
    assert BENCH.reader("server_host_ms")(fake_run()) is None


def _gap_run(log):
    """Device busy at 1000-1010, 1030-1040, 1060-1070, 1090-1100 ms:
    gaps 1010-1030 (a submit sampling), 1040-1060 (a step copying),
    1070-1090 (a step with no program span in the gap) and none in a
    harness span at all."""
    tl = Timeline(t_open=OPEN, t_close=CLOSE, t_end=CLOSE, aligned=True,
                  events=[("k", a * MS, (a + 10) * MS)
                          for a in (1_000, 1_030, 1_060, 1_090)])
    items = [("submit:2-comb", 1_005 * MS, 1_035 * MS),
             ("step:4-path", 1_038 * MS, 1_062 * MS),
             ("step:1-tree", 1_065 * MS, 1_085 * MS)]
    log += [rec(0, "sched.submit", 1_006, 1_034),
            rec(1, "server.sample", 1_008, 1_028, parent=0),
            rec(2, "sched.quantum", 1_039, 1_061),
            rec(3, "server.execute", 1_039, 1_061, parent=2),
            rec(4, "graph.build", 1_041, 1_059, parent=3, key="indices"),
            rec(5, "graph.copy", 1_045, 1_058, parent=4),
            rec(6, "sched.quantum", 1_066, 1_072)]
    return fake_run(items=items, timeline=tl)


def test_gaps_are_named_by_the_innermost_program_span(log):
    run = _gap_run(log)
    BENCH.reader("server_host_ms")(run)
    gaps = dict(run.timeline.idle_gaps(run.spans))
    assert gaps == {"submit:2-comb>server.sample": 0.020,
                    "step:4-path>graph.copy:indices": 0.020,
                    "step:1-tree": 0.020}


def test_gap_labels_keep_the_harness_prefix_and_are_made_once(log):
    run = _gap_run(log)
    program_spans.take(run)
    once = list(run.spans.items)
    program_spans.take(run)
    assert run.spans.items == once
    labels = [x[0] for x in once]
    assert {lab.split(">")[0] for lab in labels} == {
        "submit:2-comb", "step:4-path", "step:1-tree"}
    assert all(lab.count(">") <= 1 for lab in labels)
    # the pieces tile each harness span
    for label, s, e in _gap_run([]).spans.items:
        mine = [x for x in once if x[0].split(">")[0] == label]
        assert mine[0][1] == s and mine[-1][2] == e
        assert all(a[2] == b[1] for a, b in zip(mine, mine[1:]))


def test_a_log_left_open_by_a_failed_run_is_closed_by_the_next(
        monkeypatch):
    from repro_torch.obs import SpanLog
    monkeypatch.setattr(program_spans, "_log", None)
    left = program_spans.open_log()
    try:
        fresh = program_spans.open_log()
        assert fresh is not left and fresh.is_open and not left.is_open
        fresh.close()
        with SpanLog().recording() as other:
            assert other.is_open
    finally:
        program_spans._log.close()


def test_a_program_without_the_span_log_gives_nothing(monkeypatch):
    monkeypatch.setattr(program_spans, "_log", None)
    monkeypatch.setitem(sys.modules, "repro_torch.obs",
                        types.ModuleType("repro_torch.obs"))
    assert program_spans.open_log() is None
    run = fake_run([answered(7)], items=[("step:x", OPEN, CLOSE)])
    assert program_spans.take(run) == []
    assert BENCH.reader("warm_graph_build_s")(run) is None
    assert BENCH.reader("server_host_ms")(run) is None
    assert run.spans.items == [("step:x", OPEN, CLOSE)]


@pytest.mark.parametrize("workload,metric", [
    ("livejournal.sessions.c16", "warm_graph_build_s"),
    ("livejournal.acyclic.c16", "server_host_ms")])
def test_a_traced_run_reads_its_program_span_metric(workload, metric):
    from repro_torch.obs import span
    result, checks = harness.run_cell(
        BENCH, workload, 2**33 + 9, 1.0, True, time.perf_counter(),
        device="cpu", config_override=TINY["soc-livejournal1"])
    assert result["correct"], checks
    assert result["metrics"][metric]["value"] > 0
    assert span("probe") is span("probe")  # the no-op: no log left open


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      BENCH.spec["workloads"]])
def test_an_untraced_run_opens_no_span_log(workload, monkeypatch):
    from repro_torch.obs import SpanLog
    opened = []
    real = SpanLog.open
    monkeypatch.setattr(SpanLog, "open",
                        lambda self: opened.append(self) or real(self))
    result, _ = harness.run_cell(
        BENCH, workload, 2**33 + 9, 1.0, False, time.perf_counter(),
        device="cpu", config_override=TINY["soc-livejournal1"])
    assert result["correct"] and not opened
