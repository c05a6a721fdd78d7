"""The port's launchers against the JAX package.

``repro.launch.train`` cannot be imported (it imports
``repro.dist.elastic``, which the JAX package does not have), so the
port's ``build_trainer`` is held against what that launcher wires for
each family at ``--reduced``: the JAX pipelines' first batch for the same
seed and step (bitwise), and the JAX loss function of the family on the
same parameters (carried across from the JAX init for the same seed) and
the same batch, within 1e-5 (atol and rtol).  ``repro.launch.serve``
imports and runs: both launchers serve the same drawn requests on the
same graph, and every served count and engine label is equal.
"""
import ast
import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import repro  # noqa: F401  (x64, as the JAX package's own tests run)
from repro import data as jdata
from repro.configs import ARCHS as J_ARCHS
from repro.launch import serve as jserve
from repro.models import transformer as jtfm
from repro.models import xdeepfm as jxdf
from repro.models.gnn import data as jgnn_data

from repro_torch.convert import (gnn_params_from_numpy,
                                 transformer_params_from_numpy,
                                 xdeepfm_params_from_numpy)
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(atol=1e-5, rtol=1e-5)
SEED = 3
TRAINABLE = [a for a, arch in J_ARCHS.items() if arch.family != "wcoj"]


def _args(arch_id: str, *more: str):
    return ttrain.parse_args(["--arch", arch_id, "--reduced", "--steps",
                              "3", "--seed", str(SEED), "--device", "cpu",
                              *more])


def _jax_wiring(arch_id: str):
    """What ``repro.launch.train.build_trainer`` builds at ``--reduced``
    with ``--seed SEED``: the loss function, the parameters and the first
    batch (the LM parameters made under ``jax.jit``, which draws the same
    numbers in a fraction of the eager time)."""
    arch = J_ARCHS[arch_id]
    key = jax.random.PRNGKey(SEED)
    if arch.family == "lm":
        cfg = arch.reduced_cfg()
        return (lambda p, b: jtfm.loss_fn(p, b, cfg),
                jax.jit(jtfm.init_params, static_argnums=1)(key, cfg),
                jdata.lm_synthetic_batch(0, 8, 64, cfg.vocab_size,
                                         seed=SEED))
    if arch.family == "gnn":
        g = jgnn_data.random_graph_batch(256, 1024, 16, seed=SEED,
                                         coords=True, n_graphs=4)
        cfg = arch.make_cfg(16, 16)
        return (lambda p, b: arch.loss_fn(p, g, cfg),
                arch.init_fn(key, cfg), {"step": np.zeros(1)})
    cfg = arch.reduced_cfg()
    return (lambda p, b: jxdf.xdeepfm_loss(p, b, cfg),
            jxdf.init_xdeepfm(key, cfg),
            jdata.recsys_synthetic_batch(0, 256, cfg.n_sparse,
                                         cfg.vocab_per_field, seed=SEED))


def _port_params(arch_id: str, jp):
    np_tree = jax.tree.map(np.asarray, jp)
    family = J_ARCHS[arch_id].family
    if family == "lm":
        return transformer_params_from_numpy(
            np_tree, ttrain.ARCHS[arch_id].reduced_cfg(), device="cpu")
    if family == "gnn":
        return gnn_params_from_numpy(np_tree, device="cpu")
    return xdeepfm_params_from_numpy(np_tree, device="cpu")


@pytest.mark.parametrize("arch_id", TRAINABLE)
def test_build_trainer_wires_what_the_jax_launcher_wires(arch_id):
    trainer = ttrain.build_trainer(arch_id, _args(arch_id))
    jloss, jp, jbatch = _jax_wiring(arch_id)
    tbatch = trainer.get_batch(0)
    assert sorted(tbatch) == sorted(jbatch)
    for k in jbatch:
        assert tbatch[k].dtype == jbatch[k].dtype, k
        assert_array_equal(tbatch[k], jbatch[k], err_msg=k)
    assert trainer.device.type == "cpu"
    tp = _port_params(arch_id, jp)
    got = trainer.loss_fn(tp, {k: torch.as_tensor(v)
                               for k, v in tbatch.items()})
    want = jax.jit(jloss)(jp, jbatch)
    assert_allclose(float(got), float(want), **TOL)


@pytest.mark.parametrize("arch_id", ["stablelm-3b", "xdeepfm"])
def test_microbatches_reach_the_trainer(arch_id):
    """``--microbatches`` reaches the LM trainer, as in the JAX launcher,
    and (in the port only) the recsys trainer."""
    trainer = ttrain.build_trainer(arch_id,
                                   _args(arch_id, "--microbatches", "2"))
    assert trainer.microbatches == 2


def test_wcoj_is_refused_with_the_jax_launchers_message():
    """The message is the JAX launcher's f-string, read from its source
    and evaluated for ``wcoj``."""
    tree = ast.parse((ROOT / "src/repro/launch/train.py").read_text())
    raises = [n.exc for n in ast.walk(tree) if isinstance(n, ast.Raise)
              and isinstance(n.exc, ast.Call)
              and getattr(n.exc.func, "id", "") == "SystemExit"
              and isinstance(n.exc.args[0], ast.JoinedStr)]
    assert len(raises) == 1
    want = eval(compile(ast.Expression(raises[0].args[0]), "train.py",
                        "eval"),
                {"arch_id": "wcoj", "arch": J_ARCHS["wcoj"]})
    with pytest.raises(SystemExit) as e:
        ttrain.build_trainer("wcoj", _args("wcoj"))
    assert str(e.value) == want
    with pytest.raises(SystemExit) as e:
        ttrain.main(["--arch", "wcoj", "--device", "cpu"])
    assert str(e.value) == want


def test_jax_training_launcher_cannot_be_imported():
    """Why the port's launcher is held against the JAX functions it wires
    rather than the JAX ``main``: ``repro.launch.train`` imports
    ``repro.dist.elastic``, which does not exist."""
    with pytest.raises(ModuleNotFoundError, match="repro.dist.elastic"):
        import repro.launch.train  # noqa: F401


def test_train_main_runs_on_the_cpu(capsys):
    assert ttrain.main(["--arch", "xdeepfm", "--reduced", "--steps", "3",
                        "--log-every", "1", "--resume", "none",
                        "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "device=cpu (the host's CPU)"
    losses = [float(line.split()[3]) for line in out[1:]]
    assert len(losses) == 3 and all(np.isfinite(losses))


class _Recorded:
    """``QueryServer.execute_batch`` of a package, recording its requests
    and results."""

    def __init__(self, cls):
        self.calls = []
        real = cls.execute_batch
        calls = self.calls

        def execute_batch(server, reqs):
            results = real(server, reqs)
            calls.append((reqs, results))
            return results

        self.patch = execute_batch


def test_serve_launcher_serves_what_the_jax_launcher_serves(monkeypatch,
                                                            capsys):
    argv = ["--nodes", "400", "--requests", "12", "--seed", "1"]
    jrec, trec = _Recorded(jserve.QueryServer), _Recorded(
        tserve.QueryServer)
    monkeypatch.setattr(jserve.QueryServer, "execute_batch", jrec.patch)
    monkeypatch.setattr(tserve.QueryServer, "execute_batch", trec.patch)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    assert jserve.main() == 0
    assert tserve.main(argv + ["--device", "cpu"]) == 0
    (jreqs, jres), = jrec.calls
    (treqs, tres), = trec.calls
    fields = ("query_name", "selectivity", "seed", "engine", "limit",
              "cursor", "tenant")
    assert [tuple(getattr(r, f) for f in fields) for r in treqs] == \
        [tuple(getattr(r, f) for f in fields) for r in jreqs]
    assert [tuple(getattr(r, f) for f in fields)
            for r in tserve.draw_requests(12, 1)] == \
        [tuple(getattr(r, f) for f in fields) for r in jreqs]
    assert [(r.count, r.engine) for r in tres] == \
        [(r.count, r.engine) for r in jres]
    table = tserve.percentiles(tres)
    assert {e: row["n"] for e, row in table.items()} == {
        e: sum(r.engine == e for r in jres) for e in {r.engine for r in jres}}
    out = capsys.readouterr().out
    assert "12 requests" in out and "on cpu" in out


def test_percentiles_are_the_jax_launchers_order_statistics():
    @dataclasses.dataclass
    class R:
        engine: str
        latency_s: float

    res = [R("vlftj", s) for s in (0.3, 0.1, 0.2, 0.4)] + [R("hybrid", 1.0)]
    assert tserve.percentiles(res) == {
        "hybrid": dict(n=1, p50_ms=1000.0, p99_ms=1000.0),
        "vlftj": dict(n=4, p50_ms=300.0, p99_ms=400.0)}
