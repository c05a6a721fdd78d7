"""The data-parallel train steps of ``repro_torch.dist.compressed_step``
against the JAX package's, over gloo.

At one rank (a group in this process) the steps run beside the JAX
package's on a ``(1,)`` mesh from the same parameters and batches:
``make_dp_train_step`` and ``make_compressed_train_step`` for 3 steps
(loss, ``grad_norm``, ``lr``, the error-feedback residues and the
parameters), ``init_compressed_state`` and ``resize_compressed_state``,
and the 12-step loss curves of ``benchmarks/bench_dist.py``'s training
rows (``_train_rows``: 2 layers, d_model 64, float32, lr 1e-3) at 1e-4.
Four spawned ranks hold the data-parallel step to one process's step on
the whole batch, and the compressed run to the convergence criteria of
``tests/test_fault_tolerance.py``: its last loss below 0.8 times its
first, and within 0.35 times the first of the uncompressed run.
Parameters are compared at an absolute tolerance of 3 learning rates
(Adam turns a gradient element near zero into an update of about lr).
"""
import json
import os
import subprocess
import sys
import textwrap
import time
from datetime import timedelta
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from numpy.testing import assert_allclose

import repro  # noqa: F401  (x64, as the JAX package's own tests run)
from repro.dist import compressed_step as jcs
from repro.models import transformer as jt
from repro.train import optimizer as jopt

from repro_torch.convert import transformer_params_from_numpy
from repro_torch.dist import compressed_step as tcs
from repro_torch.models import transformer as tt
from repro_torch.train import optimizer as topt
from repro_torch.train.tree import flatten_with_paths, leaves

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 240
#: the training rows' model and optimizer (benchmarks/bench_dist.py)
CFG = dict(name="bench", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
           d_ff=128, vocab_size=256, remat=False)
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=50)
TOL = dict(atol=2e-4, rtol=2e-4)


def _batch(s: int):
    rng = np.random.default_rng(s)
    toks = rng.integers(0, 64, (16, 32), dtype=np.int32)
    return {"tokens": toks, "labels": (toks * 3 + 7) % 256}


def _tbatch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def gloo1(tmp_path_factory):
    store = tmp_path_factory.mktemp("gloo1") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1, timeout=timedelta(seconds=60))
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def models():
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **CFG)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **CFG)
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp


def _port_params(tcfg, jp):
    return transformer_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                         device="cpu")


def _tree_close(got, want, **tol):
    paths, gl = flatten_with_paths(got)
    for p, g, w in zip(paths, gl, jax.tree.leaves(want)):
        assert tuple(g.shape) == tuple(np.shape(w)), p
        assert_allclose(g.numpy(), np.asarray(w), err_msg=p, **tol)


def _residues_close(got, want):
    """Error-feedback residues within 1e-6 + 1e-4 |want|, but for a few
    elements (at most 0.1% of a leaf) whose int8 rounding flipped between
    the packages (``comp / scale`` within a float32 step of a half): those
    differ by one quantum, ``scale = max|comp| / 127``, at most twice the
    largest residue."""
    paths, gl = flatten_with_paths(got)
    for p, g, w in zip(paths, gl, jax.tree.leaves(want)):
        g, w = g.numpy(), np.asarray(w)
        off = np.abs(g - w) > 1e-6 + 1e-4 * np.abs(w)
        assert off.mean() <= 1e-3, (p, int(off.sum()))
        assert np.abs(g - w).max() <= 2.01 * np.abs(w).max(), p


@pytest.mark.parametrize("compressed", [False, True])
def test_steps_at_one_rank_match_jax(gloo1, models, compressed):
    jcfg, tcfg, jp = models
    mesh = jax.make_mesh((1,), ("data",))
    jlf = lambda p, b: jt.loss_fn(p, b, jcfg)
    tlf = lambda p, b: tt.loss_fn(p, b, tcfg)
    jo, to = jopt.OptimizerConfig(**OPT), topt.OptimizerConfig(**OPT)
    tp = _port_params(tcfg, jp)
    js, ts = jopt.init_opt_state(jp), topt.init_opt_state(tp)
    jerr = jcs.init_compressed_state(jp, mesh)
    terr = tcs.init_compressed_state(tp, gloo1)
    for e, w in zip(leaves(terr), jax.tree.leaves(jerr)):
        assert e.dtype == torch.float32 and tuple(e.shape) == w.shape
        assert not e.any()
    if compressed:
        jstep = jcs.make_compressed_train_step(jlf, jo, mesh)
        tstep = tcs.make_compressed_train_step(tlf, to, gloo1)
    else:
        jstep = jcs.make_dp_train_step(jlf, jo, mesh)
        tstep = tcs.make_dp_train_step(tlf, to, gloo1)
    for s in range(3):
        batch = _batch(s)
        if compressed:
            jp, js, jerr, jm = jstep(jp, js, jerr, batch)
            tp, ts, terr, tm = tstep(tp, ts, terr, _tbatch(batch))
            _residues_close(terr, jerr)
        else:
            jp, js, jm = jstep(jp, js, batch)
            tp, ts, tm = tstep(tp, ts, _tbatch(batch))
        for k in ("loss", "grad_norm"):
            assert_allclose(float(tm[k]), float(jm[k]), **TOL, err_msg=k)
        assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    _tree_close(tp, jp, atol=3 * OPT["lr"], rtol=0)


def test_resize_compressed_state_matches_jax():
    rng = np.random.default_rng(0)
    err = {"a": rng.standard_normal((3, 4, 5)).astype(np.float32),
           "b": {"c": rng.standard_normal((3, 7)).astype(np.float32)}}
    for n in (1, 2, 5):
        want = jcs.resize_compressed_state(jax.tree.map(jnp.asarray, err), n)
        got = tcs.resize_compressed_state(
            {"a": torch.from_numpy(err["a"]),
             "b": {"c": torch.from_numpy(err["b"]["c"])}}, n)
        _tree_close(got, want, atol=1e-7, rtol=1e-6)


def test_bench_dist_loss_curves_at_one_rank_match_jax(gloo1, models):
    """``_train_rows``' 12 quick steps, uncompressed then compressed, from
    the same initial weights in both packages: every step's loss at
    1e-4."""
    jcfg, tcfg, jp0 = models
    mesh = jax.make_mesh((1,), ("data",))
    jlf = lambda p, b: jt.loss_fn(p, b, jcfg)
    tlf = lambda p, b: tt.loss_fn(p, b, tcfg)
    jo, to = jopt.OptimizerConfig(**OPT), topt.OptimizerConfig(**OPT)
    for compressed in (False, True):
        jp, tp = jp0, _port_params(tcfg, jp0)
        js, ts = jopt.init_opt_state(jp), topt.init_opt_state(tp)
        jerr = jcs.init_compressed_state(jp, mesh)
        terr = tcs.init_compressed_state(tp, gloo1)
        jc = jcs.make_compressed_train_step(jlf, jo, mesh)
        ju = jcs.make_dp_train_step(jlf, jo, mesh)
        tc = tcs.make_compressed_train_step(tlf, to, gloo1)
        tu = tcs.make_dp_train_step(tlf, to, gloo1)
        jl, tl = [], []
        for s in range(12):
            batch = _batch(s)
            if compressed:
                jp, js, jerr, jm = jc(jp, js, jerr, batch)
                tp, ts, terr, tm = tc(tp, ts, terr, _tbatch(batch))
            else:
                jp, js, jm = ju(jp, js, batch)
                tp, ts, tm = tu(tp, ts, _tbatch(batch))
            jl.append(float(jm["loss"]))
            tl.append(float(tm["loss"]))
        assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
        assert tl[-1] < tl[0]


def test_dp_step_refuses_a_group_of_another_device(gloo1, models):
    _, tcfg, jp = models
    step = tcs.make_dp_train_step(lambda p, b: tt.loss_fn(p, b, tcfg),
                                  topt.OptimizerConfig(**OPT), gloo1)
    tp = _port_params(tcfg, jp)
    meta = {k: v.to("meta") for k, v in tp.items()}
    with pytest.raises(ValueError, match="process group"):
        step(meta, topt.init_opt_state(meta), _tbatch(_batch(0)))


RANK_SCRIPT = """
import json, sys
from datetime import timedelta
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world, timeout=timedelta(seconds=60))
from repro_torch.dist import (init_compressed_state,
                              make_compressed_train_step, make_dp_train_step)
from repro_torch.models.transformer import (TransformerConfig, init_params,
                                            loss_fn)
from repro_torch.train import OptimizerConfig, init_opt_state, make_train_step
from repro_torch.train.tree import leaves, tree_map
cfg = TransformerConfig(name="t", n_layers=2, d_model=64, n_heads=4,
                        n_kv_heads=2, d_ff=128, vocab_size=256,
                        dtype=torch.float32, remat=False)
lf = lambda p, b: loss_fn(p, b, cfg)
oc = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=30)
p0 = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

def batch(s):
    rng = np.random.default_rng(s)
    toks = rng.integers(0, 64, (16, 32), dtype=np.int32)
    return {"tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy((toks * 3 + 7) % 256)}

out = {}
# the DP step over the ranks against one process's step on the whole batch
p, q = tree_map(torch.clone, p0), tree_map(torch.clone, p0)
sp, sq = init_opt_state(p), init_opt_state(q)
dp, one = make_dp_train_step(lf, oc), make_train_step(lf, oc)
diff, loss_diff = 0.0, 0.0
for s in range(3):
    p, sp, mp = dp(p, sp, batch(s))
    q, sq, mq = one(q, sq, batch(s))
    loss_diff = max(loss_diff, abs(float(mp["loss"]) - float(mq["loss"])))
diff = max(float((a - b).abs().max()) for a, b in zip(leaves(p), leaves(q)))
out["dp_vs_one"] = diff
out["dp_vs_one_loss"] = loss_diff

def run(compressed):
    p = tree_map(torch.clone, p0)
    opt, err = init_opt_state(p), init_compressed_state(p)
    step_c = make_compressed_train_step(lf, oc)
    step_u = make_dp_train_step(lf, oc)
    losses = []
    for s in range(25):
        if compressed:
            p, opt, err, m = step_c(p, opt, err, batch(s))
        else:
            p, opt, m = step_u(p, opt, batch(s))
        losses.append(float(m["loss"]))
    return losses, p

lc, pc = run(True)
lu, _ = run(False)
out["compressed"], out["uncompressed"] = lc, lu
# every rank holds the same parameters after the compressed run
flat = torch.cat([t.reshape(-1) for t in leaves(pc)])
hi, lo = flat.clone(), flat.clone()
dist.all_reduce(hi, op=dist.ReduceOp.MAX)
dist.all_reduce(lo, op=dist.ReduceOp.MIN)
out["replicas_differ"] = float((hi - lo).abs().max())
dist.barrier()
dist.destroy_process_group()
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    store = tmp_path_factory.mktemp("gloo4") / "store"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(RANK_SCRIPT), str(r), "4",
         str(store)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(4)]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            assert p.returncode == 0, err[-4000:]
            line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
            assert line, out[-2000:] + err[-2000:]
            outs.append(json.loads(line[-1][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def test_dp_step_over_four_ranks_is_one_step_on_the_whole_batch(ranks4):
    """Each rank back-propagates a quarter of the batch; the mean of the
    four gradients is the gradient of the whole batch's mean loss, so
    three steps land where one process's three steps land (float32 sums
    in another order)."""
    for out in ranks4:
        assert out["dp_vs_one_loss"] <= 1e-5
        assert out["dp_vs_one"] <= 3 * OPT["lr"]
    # every rank holds the same parameters, so the same difference
    assert len({o["dp_vs_one"] for o in ranks4}) == 1


def test_compressed_training_over_four_ranks_converges(ranks4):
    """``tests/test_fault_tolerance.py``'s criteria, over four gloo ranks:
    the int8 compressed run learns (last loss < 0.8 x first) and stays
    within 0.35 x the first loss of the uncompressed data-parallel run;
    every rank holds the same parameters and the same curves."""
    lc, lu = ranks4[0]["compressed"], ranks4[0]["uncompressed"]
    assert lc[-1] < lc[0] * 0.8, lc
    assert abs(lc[-1] - lu[-1]) < 0.35 * lu[0], (lc[-1], lu[-1])
    for out in ranks4:
        assert out["compressed"] == lc and out["uncompressed"] == lu
        assert out["replicas_differ"] == 0.0
