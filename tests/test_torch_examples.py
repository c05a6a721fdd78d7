"""The four ``examples/*_torch.py`` scripts, each run on the CPU in a
subprocess at a small size (``--device cpu``).

The quickstart's counts equal the JAX package's host oracle
(``lftj_ref``) on the same graph and samples; the server answers every
request, the quantum policy finishes the small requests sooner than
FIFO and the tenant quota refuses two submits; each training example,
run twice with one ``--ckpt``, resumes the second time from the first
run's last checkpoint and still meets its own check (a falling loss;
the triangle features lowering GatedGCN's loss).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro.core import GraphDB as JGraphDB
from repro.core import count as j_count
from repro.core import get_query as j_get_query
from repro.graphs import node_sample as j_node_sample
from repro.graphs import powerlaw_cluster as j_powerlaw_cluster

ROOT = Path(__file__).resolve().parents[1]
#: each script's time limit
SCRIPT_TIMEOUT_S = 240.0


def run(script: str, *args) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="2")
    got = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), "--device", "cpu",
         *map(str, args)], env=env, capture_output=True, text=True,
        timeout=SCRIPT_TIMEOUT_S)
    assert got.returncode == 0, got.stdout[-2000:] + got.stderr[-4000:]
    return got.stdout


def test_quickstart_counts_equal_the_jax_oracle():
    out = run("quickstart_torch.py", "--nodes", 300)
    got = dict(re.findall(r"^(\S+)\s+->\s+([\d,]+) matches", out, re.M))
    g = j_powerlaw_cluster(n=300, m_per_node=5, seed=0)
    gdb = JGraphDB(g, {"v1": j_node_sample(g.n_nodes, 10, seed=1),
                       "v2": j_node_sample(g.n_nodes, 10, seed=2)})
    want = {q: j_count(j_get_query(q), gdb, engine="lftj_ref")
            for q in ("3-clique", "4-clique", "3-path", "2-comb")}
    assert {q: int(c.replace(",", "")) for q, c in got.items()} == want
    assert f"pairwise 3-clique: {want['3-clique']} " in out


def test_serve_queries_answers_schedules_and_refuses():
    out = run("serve_queries_torch.py", "--nodes", 400, "--requests", 8)
    assert len(re.findall(r"sel=\s*\d+ ->\s+[\d,]+", out)) == 8
    p50 = {p: int(v.replace(",", "")) for p, v in re.findall(
        r"^\s+(fifo|quantum)\s*:.*p50=([\d,]+)", out, re.M)}
    assert p50["quantum"] < p50["fifo"], out
    assert out.count("HTTP 429") == 2
    assert out.count("admitted as") == 2


def _losses(out: str) -> list:
    return [float(x) for x in re.findall(r"loss ([\d.]+)", out)]


def test_train_lm_resumes_from_its_checkpoint(tmp_path):
    args = ("--steps", 6, "--layers", 1, "--d-model", 32, "--ckpt",
            tmp_path)
    first = run("train_lm_torch.py", *args)
    assert "resumed" not in first
    second = run("train_lm_torch.py", *args)
    assert "resumed from checkpoint at step 6" in second
    assert re.findall(r"^  step\s+(\d+)", second, re.M) == ["7", "12"]
    assert sorted(os.listdir(tmp_path)) == ["step-00000006",
                                            "step-00000012"]
    for out in (first, second):
        losses = _losses(out)
        assert losses[-1] < losses[0], out


def test_train_gnn_wcoj_features_resumes(tmp_path):
    args = ("--steps", 30, "--ckpt", tmp_path)
    first = run("train_gnn_wcoj_features_torch.py", *args)
    assert "resumed" not in first
    second = run("train_gnn_wcoj_features_torch.py", *args)
    for name in ("plain", "wcoj"):
        assert f"{name}: resumed from checkpoint at step 30" in second
        assert sorted(os.listdir(tmp_path / name)) == ["step-00000030",
                                                       "step-00000060"]
    for out in (first, second):
        assert "WCOJ structural features improve the GNN" in out
