"""The port's process span log (``repro_torch.obs.SpanLog``/``span``) on
the CPU: off by default, the spans of a scheduled round and of
``QueryServer.execute`` nested by ``parent`` and carrying their request,
no kernel dispatch added while the log is open, and the cap."""
import threading

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.graphs import powerlaw_cluster
from repro_torch.kernels import build
from repro_torch.obs import SpanLog, span, trace
from repro_torch.serve import QuantumScheduler, QueryRequest, QueryServer

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def csr():
    return powerlaw_cluster(n=200, m_per_node=3, seed=1)


def _req(seed=3, **kw):
    return QueryRequest("3-path", selectivity=4, seed=seed,
                        engine="yannakakis", **kw)


def _by_name(records, name):
    return [r for r in records if r.name == name]


def _no_log_open():
    """``span`` gives the shared no-op, as it does only with no log open."""
    return span("probe") is span("probe")


def _parent(records, rec):
    return None if rec.parent is None else records[rec.parent]


# ---------------------------------------------------------------------------
# off by default
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args,attrs", [
    (("server.plan",), {}),
    (("sched.submit",), {"request": "sched-1", "tenant": "a"}),
    (("graph.build",), {"key": "indices"})])
def test_the_log_is_off_by_default(args, attrs):
    assert _no_log_open()
    noop = span(*args, **attrs)
    assert noop is span("another")
    with noop as rec:
        assert rec is None


def test_a_log_not_opened_records_nothing(csr):
    log = SpanLog()
    QueryServer(csr, device="cpu").execute(_req())
    assert log.records == [] and log.dropped == 0
    with log.recording():
        assert log.is_open and not _no_log_open()
    assert not log.is_open and _no_log_open()


# ---------------------------------------------------------------------------
# a scheduled round
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rounds(csr):
    """Two scheduled requests on one sample, the first a fresh one:
    (records, first token, second token)."""
    sched = QuantumScheduler(QueryServer(csr, device="cpu"))
    log = SpanLog()
    with log.recording():
        first = sched.submit(_req())
        assert sched.step()
        split = len(log.records)
        second = sched.submit(_req())
        assert sched.step()
    assert sched.result(first).count == sched.result(second).count
    assert all(r.end_ns is not None for r in log.records)
    return log.records, split, first, second


@pytest.mark.parametrize("child,parent", [
    ("server.sample", "sched.submit"), ("server.stats", "sched.submit"),
    ("server.plan", "sched.submit"), ("server.verify", "sched.submit"),
    ("server.execute", "sched.quantum"), ("graph.build", "server.execute"),
    ("graph.copy", "graph.build")])
def test_a_fresh_round_nests_by_parent(rounds, child, parent):
    records, split, first, _ = rounds
    kids = _by_name(records[:split], child)
    assert kids
    for rec in kids:
        up = _parent(records, rec)
        assert up.name == parent
        assert up.start_ns <= rec.start_ns <= rec.end_ns <= up.end_ns
        assert rec.request == first


def test_a_fresh_round_has_its_attributes(rounds):
    records, split, first, _ = rounds
    fresh = records[:split]
    (sub,) = _by_name(fresh, "sched.submit")
    assert sub.parent is None and sub.request == first
    assert sub.attrs == {"tenant": "default", "query": "3-path"}
    (quantum,) = _by_name(fresh, "sched.quantum")
    assert quantum.parent is None and quantum.attrs["quantum"] == 1
    assert quantum.attrs["waited_ms"] >= 0
    (sample,) = _by_name(fresh, "server.sample")
    assert sample.attrs == {"selectivity": 4, "seed": 3, "edges": "built"}
    (plan,) = _by_name(fresh, "server.plan")
    assert plan.attrs == {"hit": False}
    (execute,) = _by_name(fresh, "server.execute")
    assert execute.attrs["engine"] == "yannakakis"
    assert execute.attrs["spmvs"] > 0
    builds = _by_name(fresh, "graph.build")
    assert {"indices", "src_ids"} <= {b.attrs["key"] for b in builds}
    for b in builds:
        assert b.attrs["bytes"] > 0


def test_a_second_request_on_the_sample_builds_nothing(rounds):
    records, split, _, second = rounds
    again = records[split:]
    names = [r.name for r in again]
    assert "server.sample" not in names and "server.stats" not in names
    assert "graph.build" not in names and "graph.copy" not in names
    (plan,) = _by_name(again, "server.plan")
    assert plan.attrs == {"hit": True}
    assert {r.request for r in again} == {second}


@pytest.fixture(scope="module")
def two_samples(csr):
    """Scheduled rounds on two fresh samples of one server: (records,
    where the second round starts, the second's token)."""
    sched = QuantumScheduler(QueryServer(csr, device="cpu"))
    log = SpanLog()
    with log.recording():
        sched.submit(_req(seed=3))
        assert sched.step()
        split = len(log.records)
        second = sched.submit(_req(seed=5))
        assert sched.step()
    return log.records, split, second


def test_a_second_fresh_sample_builds_only_its_bitmaps(two_samples):
    records, split, second = two_samples
    assert {"indices", "src_ids"} <= {
        b.attrs["key"] for b in _by_name(records[:split], "graph.build")}
    again = records[split:]
    (sample,) = _by_name(again, "server.sample")
    assert sample.attrs == {"selectivity": 4, "seed": 5, "edges": "shared"}
    assert sample.request == second
    builds = _by_name(again, "graph.build")
    assert sorted(b.attrs["key"] for b in builds) == ["bitmap:v1",
                                                      "bitmap:v2"]
    for b in builds:
        assert b.attrs["bytes"] == 200           # a bool a node
        assert _parent(records, b).name == "server.execute"
        assert b.request == second
    assert len(_by_name(again, "graph.copy")) == 2


def test_rows_on_a_fresh_sample_build_only_bitmaps(csr):
    """A page's backward pass restricts the sample's warm graph to the
    active values: the derived graph shares the server's edge tensors
    too, so a second sample's page builds bitmaps alone."""
    server = QueryServer(csr, device="cpu")
    keys = []
    for seed in (3, 5):
        log = SpanLog()
        with log.recording():
            res = server.execute(_req(seed=seed, limit=10))
        assert res.rows.shape == (10, 4)
        keys.append({r.attrs["key"] for r in _by_name(log.records,
                                                      "graph.build")})
    assert {"indptr", "indices", "src_ids"} <= keys[0]
    assert keys[1] and all(k.startswith("bitmap:") for k in keys[1])
    assert "bitmap:__act_a" in keys[1]


def test_the_scheduler_looks_a_result_up_by_its_token(csr):
    sched = QuantumScheduler(QueryServer(csr, device="cpu"))
    token = sched.submit(_req())
    assert sched.result(token) is None
    sched.run()
    assert sched.result(token) is sched._jobs[-1].result
    assert sched.result("sched-99") is None


def test_latency_is_on_the_monotonic_clock(csr, monkeypatch):
    """A wall clock stepped back does not make a latency negative."""
    import time
    clock = [1e9]

    def stepped_back():
        clock[0] -= 1000.0
        return clock[0]
    monkeypatch.setattr(time, "time", stepped_back)
    server = QueryServer(csr, device="cpu")
    sched = QuantumScheduler(server)
    sched.submit(_req())
    (res,) = sched.run()
    assert 0 <= res.latency_s < 60
    assert 0 <= server.execute(_req(seed=4)).latency_s < 60


# ---------------------------------------------------------------------------
# the execute path
# ---------------------------------------------------------------------------

def test_execute_spans_carry_the_request_id(csr):
    server = QueryServer(csr, device="cpu")
    log = SpanLog()
    with log.recording():
        server.execute(_req())
        server.execute(_req(seed=4))
    roots = [r for r in log.records if r.parent is None]
    assert [(r.name, r.request) for r in roots] == [
        ("server.request", "req-1"), ("server.request", "req-2")]
    for rec in log.records:
        root = rec
        while root.parent is not None:
            root = _parent(log.records, root)
        assert rec.request == root.request
    assert {"server.sample", "server.plan", "server.verify",
            "server.execute", "graph.build", "graph.copy"} <= {
        r.name for r in log.records}


# ---------------------------------------------------------------------------
# no dispatch, threads, the cap
# ---------------------------------------------------------------------------

class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        key = str(func)
        self.ops[key] = self.ops.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("shape,engine", [("3-path", "yannakakis"),
                                          ("4-cycle", "vlftj")])
def test_the_open_log_adds_no_dispatch(csr, shape, engine):
    """With the log open, the same tensor operations, kernel launches,
    engine meters and count as with it closed, on a fresh server each."""
    runs = []
    for on in (False, True):
        build.reset_launches()
        log = SpanLog()
        req = QueryRequest(shape, selectivity=4, seed=3, engine=engine)
        with _CountOps() as ops:
            if on:
                with log.recording():
                    res = QueryServer(csr, device="cpu").execute(req)
            else:
                res = QueryServer(csr, device="cpu").execute(req)
        runs.append((res.count, ops.ops, dict(build.LAUNCHES),
                     res.stats["engine"]["kernel_dispatches"],
                     res.stats["engine"]["raw"].get("spmvs")))
        assert bool(log.records) == on
    assert runs[0] == runs[1]


def test_spans_of_another_thread_have_no_parent_here():
    log = SpanLog()
    seen = {}

    def work():
        with span("worker") as rec:
            seen["worker"] = rec

    with log.recording():
        with span("main", request="req-7"):
            t = threading.Thread(target=work)
            t.start()
            t.join()
            with span("child") as child:
                pass
    assert seen["worker"].parent is None and seen["worker"].request is None
    assert child.parent == 0 and child.request == "req-7"


def test_an_exception_closes_its_span():
    log = SpanLog()
    with log.recording():
        with pytest.raises(KeyError):
            with span("outer"):
                with span("inner"):
                    raise KeyError("x")
        with span("after") as after:
            pass
    assert all(r.end_ns is not None for r in log.records)
    assert after.parent is None


def test_one_log_is_open_at_a_time():
    with SpanLog().recording():
        with pytest.raises(RuntimeError):
            SpanLog().open()
    assert _no_log_open()


@pytest.mark.parametrize("cap,n", [(0, 3), (3, 3), (3, 5), (10, 4)])
def test_the_cap_counts_dropped_records(cap, n, monkeypatch):
    monkeypatch.setattr(trace, "SPAN_LOG_CAP", cap)
    log = SpanLog()
    with log.recording():
        for i in range(n):
            with span(f"s{i}") as rec:
                with span("inner") as inner:
                    pass
            assert (rec is None) == (i * 2 >= cap)
            assert (inner is None) == (i * 2 + 1 >= cap)
    assert len(log.records) == min(cap, 2 * n)
    assert log.dropped == max(0, 2 * n - cap)
    assert [r.id for r in log.records] == list(range(len(log.records)))
    assert [r.to_dict()["name"] for r in log.records] == [
        r.name for r in log.records]
