"""LM training in the port against the JAX package on the same weights and
batches: the cross-entropy, ``loss_fn`` and its gradient, AdamW, the
train step and ``Trainer`` with checkpoints and resume.

The JAX package's float32 parameters (``init_params(PRNGKey(0), ...)`` of
the reduced configs) are carried across with
``convert.transformer_params_from_numpy``; batches are numpy arrays from
a seed.  Tolerances: 1e-6 for the cross-entropy and the optimizer
(float32 elementwise math in both packages, differing in rounding only),
2e-4 (atol and rtol) for losses, gradients and train-step metrics, the
transformer tests' ``TOL``.  Parameters after AdamW steps are compared at
an absolute tolerance of 3 learning rates: Adam turns a gradient element
near zero, where the two packages' float32 sums differ in sign or size,
into an update of about ``lr``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import repro  # noqa: F401  (x64, as the JAX package's own tests run)
from repro.configs.chatglm3_6b import ARCH as J_CHATGLM
from repro.configs.granite_moe_3b_a800m import ARCH as J_GRANITE
from repro.configs.moonshot_v1_16b_a3b import ARCH as J_MOONSHOT
from repro.configs.stablelm_3b import ARCH as J_STABLELM
from repro.layers.common import cross_entropy_from_logits as j_ce
from repro.models import transformer as jt
from repro.train import loop as jloop
from repro.train import optimizer as jopt

from repro_torch import configs as tconfigs
from repro_torch.convert import (opt_state_from_numpy,
                                 transformer_params_from_numpy)
from repro_torch.layers.common import cross_entropy_from_logits as t_ce
from repro_torch.models import transformer as tt
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt
from repro_torch.train.tree import flatten_with_paths, leaves, tree_map

torch.set_num_threads(1)

ARCHS = {"stablelm-3b": (J_STABLELM, tconfigs.STABLELM_3B),
         "chatglm3-6b": (J_CHATGLM, tconfigs.CHATGLM3_6B),
         "granite-moe-3b-a800m": (J_GRANITE, tconfigs.GRANITE_MOE_3B_A800M),
         "moonshot-v1-16b-a3b": (J_MOONSHOT, tconfigs.MOONSHOT_V1_16B_A3B)}
TOL = dict(atol=2e-4, rtol=2e-4)
B, S = 2, 32


def _cfgs(arch: str, **over):
    jarch, tcfg = ARCHS[arch]
    return (dataclasses.replace(jarch.reduced_cfg(), **over),
            dataclasses.replace(tconfigs.reduced_cfg(tcfg), **over))


@functools.lru_cache(maxsize=None)
def _jax_params(arch: str):
    jcfg, _ = _cfgs(arch)
    return jt.init_params(jax.random.PRNGKey(0), jcfg)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_params(arch: str, tcfg):
    return transformer_params_from_numpy(_np_tree(_jax_params(arch)), tcfg,
                                         device="cpu")


def _batch(seed: int, vocab: int = 512, b: int = B, s: int = S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s), dtype=np.int32)
    return {"tokens": toks, "labels": (toks * 3 + 7) % vocab}


def _tbatch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _assert_tree_close(got, want, **tol):
    paths, gl = flatten_with_paths(got)
    wl = jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for p, g, w in zip(paths, gl, wl):
        assert tuple(g.shape) == tuple(np.shape(w)), p
        assert_allclose(g.detach().float().numpy(),
                        np.asarray(w, np.float32), err_msg=p, **tol)


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

def test_cross_entropy_with_padded_vocab():
    """Logits over a vocab padded 500 -> 512 with the padding masked to
    -1e30, as ``_lm_logits`` leaves them; labels in range and, as the iota
    compare allows, out of it (they pick nothing)."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 512)).astype(np.float32) * 4
    logits[..., 500:] = -1e30
    labels = rng.integers(0, 500, (3, 7)).astype(np.int32)
    labels[0, 0], labels[1, 1] = 600, -3
    want = np.asarray(j_ce(jnp.asarray(logits), jnp.asarray(labels), 500))
    got = t_ce(torch.from_numpy(logits), torch.from_numpy(labels), 500)
    assert got.dtype == torch.float32
    assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(arch: str, chunk: int):
    jcfg, _ = _cfgs(arch, loss_seq_chunk=chunk)
    batch = _batch(1)
    return jax.value_and_grad(
        lambda p: jt.loss_fn(p, batch, jcfg))(_jax_params(arch))


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("chunk", [0, 8])
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradient_match_jax(arch, chunk, remat):
    """``loss_fn``'s value and the gradient of every parameter leaf against
    ``jax.value_and_grad(loss_fn)``: the LM head whole or in chunks of 8
    positions, each layer under ``torch.utils.checkpoint`` or not (JAX's
    value and gradient are the same with and without ``jax.checkpoint``)."""
    _, tcfg = _cfgs(arch, loss_seq_chunk=chunk, remat=remat)
    jloss, jgrads = _jax_value_and_grad(arch, chunk)
    params = _port_params(arch, tcfg)
    loss, grads = tloop.value_and_grad(
        lambda p, b: tt.loss_fn(p, b, tcfg), params, _tbatch(_batch(1)))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert_allclose(float(loss), float(jloss), **TOL)
    paths, _ = flatten_with_paths(params)
    for p, g, w in zip(paths, grads, jax.tree.leaves(jgrads)):
        assert_allclose(g.numpy(), np.asarray(w), err_msg=p, **TOL)


def test_remat_recomputes_each_layer_in_the_backward(monkeypatch):
    """With ``remat`` every layer runs twice per backward (forward and
    recompute), once without; under ``torch.no_grad`` once either way."""
    _, tcfg = _cfgs("stablelm-3b", remat=True)
    params = _port_params("stablelm-3b", tcfg)
    calls = []
    real = tt._layer
    monkeypatch.setattr(tt, "_layer", lambda *a: calls.append(1) or real(*a))
    batch = _tbatch(_batch(2))
    for cfg, want in ((tcfg, 2 * tcfg.n_layers),
                      (dataclasses.replace(tcfg, remat=False),
                       tcfg.n_layers)):
        calls.clear()
        tloop.value_and_grad(lambda p, b: tt.loss_fn(p, b, cfg), params,
                             batch)
        assert len(calls) == want
    calls.clear()
    with torch.no_grad():
        tt.loss_fn(params, batch, tcfg)
    assert len(calls) == tcfg.n_layers


def test_loss_chunk_must_divide_the_sequence():
    _, tcfg = _cfgs("stablelm-3b", loss_seq_chunk=12)
    params = _port_params("stablelm-3b", tcfg)
    with pytest.raises(ValueError, match="multiple"):
        tt.loss_fn(params, _tbatch(_batch(0)), tcfg)


def test_layer_slices_take_one_unbind_per_stack():
    """The layers' parameters are views of the stacks, and the gradient
    of a stack is one tensor (no per-layer zero stacks)."""
    _, tcfg = _cfgs("granite-moe-3b-a800m")
    params = _port_params("granite-moe-3b-a800m", tcfg)
    layers = tt._layer_stack(params)
    assert len(layers) == tcfg.n_layers
    assert layers[1]["wq"].data_ptr() == params["wq"][1].data_ptr()
    assert torch.equal(layers[1]["moe"]["w_up"], params["moe"]["w_up"][1])


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

OPT = dict(lr=1e-3, warmup_steps=3, total_steps=20)


def _random_tree(seed: int, scale: float = 1.0):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)
    return {"w": f(5, 7), "b": f(7), "nested": {"z": f(3, 4, 2),
                                                 "a": f(6)}}


@pytest.mark.parametrize("step", [0, 1, 2, 3, 4, 10, 19, 20, 25])
def test_lr_schedule_matches_jax(step):
    for over in (OPT, dict(OPT, warmup_steps=0), {}):
        tcfg, jcfg = topt.OptimizerConfig(**over), jopt.OptimizerConfig(**over)
        for s in (step, torch.tensor(step, dtype=torch.int32)):
            got = topt.lr_at(s, tcfg)
            assert got.dtype == torch.float32
            assert_allclose(float(got), float(jopt.lr_at(
                jnp.asarray(step, jnp.int32), jcfg)), rtol=1e-6)


def test_global_norm_sums_leaves_in_jax_order():
    tree = _random_tree(0)
    want = float(jopt.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = topt.global_norm(tree_map(torch.from_numpy, tree))
    assert_allclose(float(got), want, rtol=1e-6)
    assert [p for p in flatten_with_paths(tree)[0]] == [
        "b", "nested/a", "nested/z", "w"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [1e-2, 10.0])
def test_adamw_update_matches_jax(dtype, grad_scale):
    """Three AdamW steps on a tree of ``dtype`` parameters: the moments,
    the step, ``grad_norm`` and ``lr`` at 1e-6, the parameters within one
    rounding of their dtype; clipping is on for the large gradients."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    p_np = _random_tree(1, 0.02)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p_np)
    tp = tree_map(lambda a: torch.from_numpy(a).to(tdt), p_np)
    jcfg, tcfg = jopt.OptimizerConfig(**OPT), topt.OptimizerConfig(**OPT)
    js, ts = jopt.init_opt_state(jp), topt.init_opt_state(tp)
    assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
    for i in range(3):
        g_np = _random_tree(10 + i, grad_scale)
        jp, js, jm = jopt.adamw_update(jp, g_np, js, jcfg)
        tp, ts, tm = topt.adamw_update(
            tp, tree_map(torch.from_numpy, g_np), ts, tcfg)
        for k in ("grad_norm", "lr"):
            assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        for key in ("m", "v"):
            _assert_tree_close(ts[key], js[key], rtol=1e-6, atol=1e-12)
        ulp = 2.0 ** -7 if dtype == "bfloat16" else 1e-6
        _assert_tree_close(tp, jp, rtol=ulp, atol=1e-9)
        for leaf in leaves(tp):
            assert leaf.dtype == tdt


def test_adamw_updates_in_place():
    """The port's divergence: parameters and moments are updated in place
    (the JAX package returns new arrays), in pieces of at most
    ``PIECE`` elements; ``step`` is a new tensor."""
    tp = tree_map(torch.from_numpy, _random_tree(2))
    state = topt.init_opt_state(tp)
    ptrs = [t.data_ptr() for t in leaves(tp) + leaves(state["m"])]
    step0 = state["step"]
    tp2, state2, _ = topt.adamw_update(
        tp, tree_map(torch.from_numpy, _random_tree(3)), state,
        topt.OptimizerConfig())
    assert [t.data_ptr() for t in leaves(tp2) + leaves(state2["m"])] == ptrs
    assert int(step0) == 0 and int(state2["step"]) == 1


# ---------------------------------------------------------------------------
# the train step and the Trainer
# ---------------------------------------------------------------------------

def _history_close(got: list, want: list):
    assert [h["step"] for h in got] == [h["step"] for h in want]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("loss", "grad_norm"):
            assert_allclose(g[k], w[k], **TOL, err_msg=k)
        assert_allclose(g["lr"], w["lr"], rtol=1e-6)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(microbatches):
    """Three steps of ``make_train_step`` (microbatches 1 and 2) of reduced
    stablelm-3b: loss, ``grad_norm`` and ``lr`` each step, and the
    parameters after them."""
    jcfg, tcfg = _cfgs("stablelm-3b", remat=False)
    oc = dict(OPT)
    jstep = jax.jit(jloop.make_train_step(
        lambda p, b: jt.loss_fn(p, b, jcfg), jopt.OptimizerConfig(**oc),
        microbatches))
    tstep = tloop.make_train_step(lambda p, b: tt.loss_fn(p, b, tcfg),
                                  topt.OptimizerConfig(**oc), microbatches)
    jp = _jax_params("stablelm-3b")
    js = jopt.init_opt_state(jp)
    tp = _port_params("stablelm-3b", tcfg)
    ts = topt.init_opt_state(tp)
    for i in range(3):
        batch = _batch(20 + i, b=4)
        jp, js, jm = jstep(jp, js, batch)
        tp, ts, tm = tstep(tp, ts, _tbatch(batch))
        for k in ("loss", "grad_norm"):
            assert_allclose(float(tm[k]), float(jm[k]), **TOL, err_msg=k)
        assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    _assert_tree_close(tp, jp, atol=3 * OPT["lr"], rtol=0)
    _assert_tree_close(ts["m"], js["m"], **TOL)


def test_trainer_with_checkpoint_and_resume_matches_jax(tmp_path):
    """``Trainer.run``: 2 steps with a checkpoint at step 2, then a fresh
    ``Trainer`` with ``resume="auto"`` takes steps 3 and 4; both packages
    write their own checkpoints.  The histories (without ``wall``) and
    the final parameters against the JAX package's; the port's restored
    state is bit-identical to what it saved."""
    jcfg, tcfg = _cfgs("chatglm3-6b", remat=True)
    oc = dict(OPT)
    get_batch = lambda step: _batch(100 + step, b=4)
    jlf = lambda p, b: jt.loss_fn(p, b, jcfg)
    tlf = lambda p, b: tt.loss_fn(p, b, tcfg)

    def jax_trainer():
        return jloop.Trainer(jlf, _jax_params("chatglm3-6b"),
                             jopt.OptimizerConfig(**oc), get_batch,
                             ckpt_dir=str(tmp_path / "jax"), ckpt_every=2,
                             microbatches=2)

    def port_trainer():
        return tloop.Trainer(tlf, _port_params("chatglm3-6b", tcfg),
                             topt.OptimizerConfig(**oc), get_batch,
                             ckpt_dir=str(tmp_path / "port"), ckpt_every=2,
                             microbatches=2, device="cpu")

    jh = jax_trainer().run(2, log_every=1)
    t1 = port_trainer()
    th = t1.run(2, log_every=1)
    saved = {"params": t1.params, "opt": t1.opt_state}
    saved = tree_map(lambda t: t.clone(), saved)
    j2 = jax_trainer()
    jh2 = j2.run(2, log_every=1)
    t2 = port_trainer()
    assert t2.maybe_resume() == 2
    for a, b in zip(leaves({"params": t2.params, "opt": t2.opt_state}),
                    leaves(saved)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    t2 = port_trainer()
    th2 = t2.run(2, log_every=1)
    for hist in (jh, jh2, th, th2):
        for h in hist:
            assert h.pop("wall") >= 0
    assert [h["step"] for h in th2] == [3, 4]
    _history_close(th, jh)
    _history_close(th2, jh2)
    _assert_tree_close(t2.params, j2.params, atol=3 * OPT["lr"], rtol=0)
    assert int(t2.opt_state["step"]) == int(j2.opt_state["step"]) == 4


def test_opt_state_carries_across_from_jax():
    """``convert.opt_state_from_numpy`` takes the JAX package's optimizer
    state (after one step) as the parameters already carry across."""
    jcfg, tcfg = _cfgs("granite-moe-3b-a800m")
    jp = _jax_params("granite-moe-3b-a800m")
    jstep = jax.jit(jloop.make_train_step(
        lambda p, b: jt.loss_fn(p, b, jcfg), jopt.OptimizerConfig(**OPT)))
    _, js, _ = jstep(jp, jopt.init_opt_state(jp), _batch(7))
    ts = opt_state_from_numpy(_np_tree(js), tcfg, device="cpu")
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 1
    for key in ("m", "v"):
        for leaf in leaves(ts[key]):
            assert leaf.dtype == torch.float32
        _assert_tree_close(ts[key], js[key], rtol=0, atol=0)


def test_adamw_takes_a_transposed_gradient():
    """A tied embedding's gradient reaches the optimizer as a transposed
    view on the card (the LM head's product differentiates ``embed.T``);
    the update reads it as the contiguous tensor it equals."""
    rng = np.random.default_rng(4)
    p = {"embed": torch.from_numpy(rng.standard_normal((6, 4)).astype(
        np.float32))}
    g = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32))
    q = tree_map(torch.clone, p)
    cfg = topt.OptimizerConfig()
    topt.adamw_update(p, {"embed": g.T}, topt.init_opt_state(p), cfg)
    topt.adamw_update(q, {"embed": g.T.contiguous()},
                      topt.init_opt_state(q), cfg)
    assert not g.T.is_contiguous() and torch.equal(p["embed"], q["embed"])
