"""Each cell's harness path on the CPU at a tiny size (the look for a
card is the CLI's alone), with the timed path sound and with it broken
underneath; and a cell added by data files alone."""
import json
import shutil
import time

import pytest
import torch

from portbench import harness, measure

from conftest import ROOT, TINY, bench_with

BENCH = harness.Bench(ROOT)
CELLS = [w["name"] for w in BENCH.spec["workloads"]]


def run(workload, bench=BENCH, seconds=1.0, seed=2**33 + 5, trace=False):
    config = bench.cell(workload)["config"]
    return harness.run_cell(bench, workload, seed, seconds, trace,
                            time.perf_counter(), device="cpu",
                            config_override=TINY[config])


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_and_is_correct(workload):
    result, checks = run(workload)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    want = {m["name"] for m in BENCH.metrics(workload, False)}
    assert set(result["metrics"]) == want
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert checks["wrong_counts"]["value"] == 0
    assert checks["count_log2_peak"]["value"] < 62


def _answer_plus_one(monkeypatch):
    from repro_torch.core import yannakakis
    real_count = yannakakis.CountingYannakakis.count
    monkeypatch.setattr(yannakakis.CountingYannakakis, "count",
                        lambda self: real_count(self) + 1)


def _half_left_out(monkeypatch):
    from repro_torch.core import yannakakis
    real_spmv = yannakakis._spmv

    def spmv(indices, src_ids, c, n):
        half = indices.shape[0] // 2
        return real_spmv(indices[:half], src_ids[:half], c, n)
    monkeypatch.setattr(yannakakis, "_spmv", spmv)


@pytest.mark.parametrize("fault", [_answer_plus_one, _half_left_out],
                         ids=["answer_altered", "half_left_out"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    result, checks = run(workload)
    assert not result["correct"]
    assert checks["wrong_counts"]["value"] > 0


def test_the_result_line(capsys):
    result, checks = run("livejournal.acyclic.c16")
    assert harness.finish(result, checks) == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    tail = out.err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])


def test_the_session_cell_brings_a_fresh_sample_each_session(monkeypatch):
    """Every round of a client is one new sample that set-up did not
    warm, and the reader of the warm graphs' bytes divides by them."""
    runs = []
    real = measure.Run.__init__

    def keep(self, *a, **kw):
        real(self, *a, **kw)
        runs.append(self)
    monkeypatch.setattr(measure.Run, "__init__", keep)
    result, checks = run("livejournal.sessions.c16")
    assert result["correct"], checks
    (r,) = runs
    shapes = len(r.mix["shapes"])
    for c in range(r.mix["clients"]):
        mine = [q.sample_seed for q in r.requests if q.client == c]
        for k in range(0, len(mine) - shapes + 1, shapes):
            assert len(set(mine[k:k + shapes])) == 1
        assert not set(mine) & set(r.warm_samples)
    fresh = measure.fresh_samples(r)
    assert len(fresh) >= r.mix["clients"]
    read = BENCH.reader("warm_graph_mb")
    assert read(r) is None                      # no card: nothing to read
    r.memory = {"open": 10**9, "end": 10**9 + len(fresh) * 7 * 10**8}
    assert read(r) == pytest.approx(700.0)


@pytest.mark.parametrize("name,file", [
    ("device_idle_share.acyclic", "device_idle_share.py"),
    ("device_idle_share.sessions", "device_idle_share.py"),
    ("acyclic_qps.sessions", "acyclic_qps.py"),
    ("acyclic_qps", "acyclic_qps.py")])
def test_split_names_share_their_quantitys_reader(name, file):
    assert BENCH.reader(name).__code__.co_filename == \
        str(ROOT / "portbench" / "metrics" / file)


def test_a_cell_added_by_data_files_alone(tmp_path):
    """A new mix and a new cell need new files and a new workloads entry,
    and no edit of a file the benchmark has."""
    before = {p.relative_to(ROOT / "portbench"): p.read_bytes()
              for p in (ROOT / "portbench").rglob("*")
              if p.is_file() and "tests" not in p.parts
              and "__pycache__" not in p.parts}
    bench = bench_with(tmp_path, {
        "workloads": [{"name": "livejournal.dummy.c2",
                       "config": "soc-livejournal1", "traffic": "dummy.c2",
                       "chips": 1, "why": "test"}]})
    (tmp_path / "portbench" / "mixes" / "dummy.c2.json").write_text(
        json.dumps({"shapes": ["3-path", "1-tree"], "selectivity": 4,
                    "samples": "pool", "pool_size": 2, "clients": 2,
                    "engine": "auto"}))
    result, checks = run("livejournal.dummy.c2", bench)
    assert result["correct"], checks
    assert set(result["metrics"]) == {"setup_s"}
    after = {p.relative_to(tmp_path / "portbench"): p.read_bytes()
             for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    assert {k: v for k, v in after.items() if k in before} == before


def test_unknown_names_are_refused():
    with pytest.raises(harness.SpecError):
        BENCH.cell("no.such.cell")
    with pytest.raises(harness.SpecError):
        BENCH.mix("no-such-mix")
    with pytest.raises(harness.SpecError):
        BENCH.reader("no_such_metric")
    with pytest.raises(harness.SpecError):
        BENCH.reader("no_such_metric.acyclic")


def test_the_cli_refuses_without_a_card(monkeypatch, capsys):
    import importlib.util
    spec = importlib.util.spec_from_file_location("portbench_run",
                                                  ROOT / "portbench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = mod.main(["--workload", "livejournal.acyclic.c16", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_the_cli_refuses_without_the_program(tmp_path):
    import subprocess
    import sys
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "livejournal.acyclic.c16", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_runs_beside_the_program(workload):
    result, checks = harness.run_cell(
        BENCH, workload, 7, 1.0, False, time.perf_counter(),
        device="cpu", config_override=TINY["soc-livejournal1"], control=True)
    assert result["correct"]
    assert set(result["control"]) == {"float32"}
    assert set(result["control"]["float32"]) == set(checks)
