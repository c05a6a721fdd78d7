"""``BENCHMARK.json`` against the benchmark's contract, and every name
in it found in a file of its own."""
import json
import re

import pytest

from conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"]
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_the_check_fits_its_time_with_all_cells():
    per_run = SPEC["run_seconds"] + 60
    assert (2 + 14 * 24) * per_run + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    names = [c["name"] for c in SPEC["configs"]]
    assert len(set(names)) == len(names)
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["why"])
        assert TEXT.match(c["source"]) and c["name"] in used
        assert c["file"].startswith("portbench/")
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])


def test_workloads():
    names = [w["name"] for w in SPEC["workloads"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= 1
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
        assert (ROOT / "portbench" / "mixes" / f"{w['traffic']}.json").exists()


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC[kind]:
        keys = {"name", "unit", "better", "source"}
        keys |= {"bound"} if kind == "end_to_end" else {"layer", "moves"}
        assert set(m) - {"workloads"} == keys
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        reader = ROOT / "portbench" / "metrics"
        assert ((reader / f"{m['name']}.py").exists()
                or (reader / f"{m['name'].split('.')[0]}.py").exists())
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert m["moves"] in e2e and TEXT.match(m["layer"])
            # each cell it lists reports the metric it moves
            moved = next(x for x in SPEC["end_to_end"]
                         if x["name"] == m["moves"])
            assert set(m["workloads"]) <= set(moved.get("workloads", cells))


def test_every_cell_reports_setup_an_end_to_end_and_a_per_layer_metric():
    setup = next(m for m in SPEC["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup and setup["bound"] <= 0.25
    for w in SPEC["workloads"]:
        e2e = [m for m in SPEC["end_to_end"] if m["name"] != "setup_s"
               and w["name"] in m.get("workloads", [w["name"]])]
        layer = [m for m in SPEC["per_layer"]
                 if w["name"] in m.get("workloads", [w["name"]])]
        assert e2e and layer


def test_names_are_unique_across_metrics():
    names = [m["name"] for k in ("end_to_end", "per_layer")
             for m in SPEC[k]]
    assert len(set(names)) == len(names)


def test_files_are_named_from_names():
    for p in (ROOT / "portbench").rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel
