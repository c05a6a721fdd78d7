"""The gradient of a gather at ids outside the table, against ``jax.grad``.

JAX reads ``x[ids]`` with a negative id wrapped once and every id then
clamped into the table; its transpose, a scatter-add, adds each row's
cotangent at the wrapped id and drops an id outside ``[-n, n)``.  The
port's ``models.gnn.data.gather`` (the four GNNs' edge gathers and
xDeepFM's table reads) and the transformer's ``_embed`` follow it.  The
JAX package's float32 parameters are carried across with ``convert``;
tolerances: the gather 1e-6 (one addition of a cotangent per id), the
LM's ``embed`` gradient the LM parity tests' 2e-4, xDeepFM's table
gradients 1e-4 of each leaf's largest |want|, as its tests hold them.
A bf16 table's gradient is summed in float32 and rounded once: a row read
by thousands of tokens keeps 2^-7 of its float32 gradient.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import repro  # noqa: F401  (x64, as the JAX package's own tests run)
from repro.configs import ARCHS as J_ARCHS
from repro.models import transformer as jt
from repro.models import xdeepfm as jxdf

from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.convert import (transformer_params_from_numpy,
                                 xdeepfm_params_from_numpy)
from repro_torch.models import transformer as tt
from repro_torch.models import xdeepfm as txdf
from repro_torch.models.gnn.data import gather
from repro_torch.train.loop import value_and_grad
from repro_torch.train.tree import flatten_with_paths

torch.set_num_threads(1)

ID_CASES = {
    "inside": [0, 4, 2, -1, -5, 3, 3],
    "at the ends": [5, -6, 4, -5, 0, -1],
    "past both ends": [7, -7, 5, -6, -1, 4, 2, 12, -13, 100, -100],
    "random": np.random.default_rng(0).integers(-15, 15, 40).tolist(),
}


@pytest.mark.parametrize("case", list(ID_CASES))
def test_gather_gradient_matches_jax(case):
    """A (5, 3) table read at the case's ids, the rows weighted by a
    random cotangent: the forward and the table's gradient."""
    ids = np.asarray(ID_CASES[case], np.int64)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 3)).astype(np.float32)
    w = rng.standard_normal((ids.size, 3)).astype(np.float32)
    want = np.asarray(jax.grad(
        lambda t: (t[jnp.asarray(ids)] * w).sum())(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_(True)
    out = gather(tx, torch.from_numpy(ids))
    assert_allclose(out.detach().numpy(), x[np.clip(
        np.where(ids < 0, ids + 5, ids), 0, 4)], rtol=0, atol=0)
    (out * torch.from_numpy(w)).sum().backward()
    assert_allclose(tx.grad.numpy(), want, rtol=1e-6, atol=1e-6)


def test_lm_embed_gradient_drops_tokens_outside_the_table():
    """Reduced stablelm-3b (tied embedding, padded vocab V = 512) with
    tokens V + 5 and -V - 9 among in-range ones: the loss and every
    gradient leaf, ``embed`` among them."""
    jcfg = J_ARCHS["stablelm-3b"].reduced_cfg()
    tcfg = T_ARCHS["stablelm-3b"].reduced_cfg()
    v = tcfg.padded_vocab
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tp = transformer_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                       device="cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 500, (2, 16), dtype=np.int32)
    toks[0, 3], toks[1, 7], toks[1, 0] = v + 5, -v - 9, -1
    batch = {"tokens": toks, "labels": (toks % 500).astype(np.int32)}
    jl, jg = jax.value_and_grad(lambda p: jt.loss_fn(p, batch, jcfg))(jp)
    tl, tg = value_and_grad(
        lambda p, b: tt.loss_fn(p, b, tcfg), tp,
        {k: torch.from_numpy(a) for k, a in batch.items()})
    assert_allclose(float(tl), float(jl), atol=2e-4, rtol=2e-4)
    paths = flatten_with_paths(tp)[0]
    for path, g, w in zip(paths, tg, jax.tree.leaves(jg)):
        assert_allclose(g.numpy(), np.asarray(w), atol=2e-4, rtol=2e-4,
                        err_msg=path)
    assert "embed" in paths


def test_xdeepfm_table_gradients_drop_ids_past_the_table():
    """The reduced config (39 fields of 1,000 rows) with ids past the
    whole table at both ends among in-range ones: ``embed`` and
    ``linear``, and every other leaf."""
    jarch, tarch = J_ARCHS["xdeepfm"], T_ARCHS["xdeepfm"]
    jcfg, tcfg = jarch.reduced_cfg(), tarch.reduced_cfg()
    jp = jxdf.init_xdeepfm(jax.random.PRNGKey(3), jcfg)
    tp = xdeepfm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 1000, (32, 39)).astype(np.int32)
    past = rng.random(ids.shape) < 0.2
    ids[past] = rng.choice([80_000, 39_500, -80_000, -39_600],
                           int(past.sum()))
    batch = {"ids": ids, "labels": (rng.random(32) < 0.3).astype(np.int32)}
    _, jg = jax.value_and_grad(lambda p: jxdf.xdeepfm_loss(p, batch,
                                                           jcfg))(jp)
    _, tg = value_and_grad(
        lambda p, b: txdf.xdeepfm_loss(p, b, tcfg), tp,
        {k: torch.from_numpy(a) for k, a in batch.items()})
    paths = flatten_with_paths(tp)[0]
    assert {"embed", "linear"} <= set(paths)
    for path, g, w in zip(paths, tg, jax.tree.leaves(jg)):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-4 * scale, f"{path}: {err} > 1e-4 x {scale}"


@pytest.mark.parametrize("path", ["gather", "_embed"])
def test_bf16_gradient_of_a_repeated_row_is_summed_in_float32(path):
    """4,096 reads of one row of a bf16 table and a few of the others:
    the gradient within 2^-7 of the float32 one (the largest |grad|),
    where a bf16 sum, one rounding an add, stalls once the row's sum
    outgrows its cotangents."""
    rng = np.random.default_rng(7)
    ids = np.concatenate([np.full(4096, 3), rng.integers(0, 16, 256)])
    ids = torch.from_numpy(rng.permutation(ids))
    table = torch.from_numpy(
        rng.standard_normal((16, 8)).astype(np.float32)).to(torch.bfloat16)
    cot = torch.from_numpy(
        rng.standard_normal((len(ids), 8)).astype(np.float32))
    cfg = T_ARCHS["stablelm-3b"].reduced_cfg()

    def grad(tab):
        tab = tab.detach().requires_grad_()
        if path == "gather":
            rows = gather(tab, ids)
        else:
            rows = tt._embed({"embed": tab}, ids[None],
                             dataclasses.replace(cfg, dtype=tab.dtype))[0]
        return torch.autograd.grad((rows.float() * cot).sum(), tab)[0]

    want = grad(table.float())
    got = grad(table)
    assert got.dtype == torch.bfloat16
    err = float((got.float() - want).abs().max() / want.abs().max())
    assert err <= 2.0 ** -7, err
