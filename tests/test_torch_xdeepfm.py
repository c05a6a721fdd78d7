"""xDeepFM in the port against the JAX package on the same numpy inputs
and the same parameters (``convert.xdeepfm_params_from_numpy``), at the
reduced config of ``RecsysArch.reduced_cfg`` (39 fields × 10 dims, 1000
rows a field, CIN (16, 16), MLP (32, 32)).

Tolerances: gathers and bag sums of one row bitwise; logits and scores
1e-5 (atol and rtol); the loss and each gradient leaf 1e-4 of its
largest |want|; one AdamW step's parameters 1e-6 (atol; an update moves
them by about the learning rate, 1e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import repro  # noqa: F401  (x64, as the JAX package's own tests run)
from repro.models import xdeepfm as jxdf
from repro.train import loop as jloop
from repro.train import optimizer as jopt

from repro_torch.convert import xdeepfm_params_from_numpy
from repro_torch.models import xdeepfm as txdf
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt
from repro_torch.train.tree import flatten_with_paths

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = 1e-4
CFG = dict(n_sparse=39, embed_dim=10, vocab_per_field=1000,
           cin_layers=(16, 16), mlp_dims=(32, 32))
JCFG, TCFG = jxdf.XDeepFMConfig(**CFG), txdf.XDeepFMConfig(**CFG)


@pytest.fixture(scope="module")
def params():
    jp = jxdf.init_xdeepfm(jax.random.PRNGKey(3), JCFG)
    return jp, xdeepfm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu")


def _ids(seed: int, b: int = 64, lo: int = 0, hi: int = 1000):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, (b, CFG["n_sparse"])).astype(np.int32)


def _batch(seed: int, b: int = 64):
    rng = np.random.default_rng(seed + 1000)
    return {"ids": _ids(seed, b),
            "labels": (rng.random(b) < 0.25).astype(np.int32)}


def _assert_leaves_close(got, want, tol: float, what: str):
    paths, g = flatten_with_paths(got)
    w = jax.tree.leaves(want)
    assert len(g) == len(w), what
    for path, a, b in zip(paths, g, w):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, f"{what} {path}"
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a.detach().numpy() - b).max())
        assert err <= tol * scale, f"{what} {path}: {err} > {tol} × {scale}"


def test_params_carry_across(params):
    """Every leaf of the JAX tree arrives float32, of its shape and bits;
    the port's own init has the same names, shapes and dtypes."""
    jp, tp = params
    _assert_leaves_close(tp, jp, 0.0, "params")
    own = txdf.init_xdeepfm(TCFG, torch.Generator().manual_seed(0),
                            device="cpu")
    leaves = flatten_with_paths(own)[1]
    assert len(leaves) == len(jax.tree.leaves(jp))
    for a, b in zip(leaves, jax.tree.leaves(jp)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    with pytest.raises(ValueError, match="names"):
        xdeepfm_params_from_numpy({"embed": np.zeros((2, 2))}, device="cpu")


@pytest.mark.parametrize("seed,b", [(0, 64), (1, 7), (2, 1)])
def test_forward_matches_jax(params, seed, b):
    jp, tp = params
    ids = _ids(seed, b)
    want = np.asarray(jxdf.xdeepfm_forward(jp, jnp.asarray(ids), JCFG))
    got = txdf.xdeepfm_forward(tp, torch.from_numpy(ids), TCFG)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b,)
    assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("what", ["past the field", "negative",
                                  "past the table", "wrapped past 0"])
def test_out_of_range_ids_read_as_jax(params, what):
    """Ids outside [0, vocab): one at or past ``vocab_per_field`` reads
    the next field's rows (the field offsets), a negative one wraps once
    over the whole table, and what is still outside clamps."""
    jp, tp = params
    lo, hi = {"past the field": (1000, 3000), "negative": (-999, 0),
              "past the table": (39_000, 10 ** 8),
              "wrapped past 0": (-10 ** 8, -39_000)}[what]
    ids = _ids(11, 16, lo, hi)
    want = np.asarray(jxdf.xdeepfm_forward(jp, jnp.asarray(ids), JCFG))
    got = txdf.xdeepfm_forward(tp, torch.from_numpy(ids), TCFG)
    assert_allclose(got.numpy(), want, **TOL)
    cand = np.concatenate([np.arange(-5, 5), [38_999, 39_000, 10 ** 7,
                                              -39_000, -39_001, -10 ** 7]]
                          ).astype(np.int32)
    want = np.asarray(jxdf.retrieval_scores(jp, jnp.asarray(ids[:1]),
                                            jnp.asarray(cand), JCFG))
    got = txdf.retrieval_scores(tp, torch.from_numpy(ids[:1]),
                                torch.from_numpy(cand), TCFG)
    assert_allclose(got.numpy(), want, **TOL)


def test_gather_wraps_once_then_clamps():
    """On a 6-row table, ids [7, -1, -9] read rows [5, 5, 0]."""
    table = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    got = txdf.embedding_bag(table, torch.tensor([7, -1, -9]))
    assert_array_equal(got.numpy(), table.numpy()[[5, 5, 0]])


@pytest.mark.parametrize("offsets", [
    [0, 2, 4, 4],            # an empty bag at the end
    [0, 2, 2, 4],            # an empty bag in the middle
    [0, 0, 1, 1, 4, 4, 4],   # empty bags at the start, middle and end
    [0, 4],                  # one bag
    [0, 1, 2, 3, 4],         # one id a bag
    [0, -3, 4],              # a negative boundary wraps once
    [0, 9, 4],               # a boundary past T is dropped
    [0, -9, 2, 4],           # a negative one past -T is dropped
], ids=lambda o: str(o))
def test_embedding_bag_multi_hot_matches_jax(offsets):
    rng = np.random.default_rng(5)
    table = rng.standard_normal((6, 3)).astype(np.float32)
    ids = np.array([0, 3, 7, -1], np.int32)
    off = np.array(offsets, np.int32)
    want = np.asarray(jxdf.embedding_bag(jnp.asarray(table),
                                         jnp.asarray(ids), jnp.asarray(off)))
    got = txdf.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                             torch.from_numpy(off))
    assert tuple(got.shape) == want.shape == (len(offsets) - 1, 3)
    assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_embedding_bag_empty_bags_are_zero_rows():
    """Offsets [0, 2, 4, 4] over a (4, 2) table of rows [1, 2] ... [7, 8]
    give [[4, 6], [12, 14], [0, 0]]: the trailing bag is empty."""
    table = torch.arange(1, 9, dtype=torch.float32).reshape(4, 2)
    ids = torch.arange(4)
    got = txdf.embedding_bag(table, ids, torch.tensor([0, 2, 4, 4]))
    assert_array_equal(got.numpy(), [[4, 6], [12, 14], [0, 0]])
    got = txdf.embedding_bag(table, ids, torch.tensor([0, 2, 2, 4]))
    assert_array_equal(got.numpy(), [[4, 6], [0, 0], [12, 14]])


def test_embedding_bag_one_hot_matches_jax(params):
    jp, tp = params
    ids = _ids(7, 9) + np.arange(39, dtype=np.int32) * 1000
    want = np.asarray(jxdf.embedding_bag(jp["embed"], jnp.asarray(ids)))
    got = txdf.embedding_bag(tp["embed"], torch.from_numpy(ids))
    assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_gradients_match_jax(params, seed):
    jp, tp = params
    batch = _batch(seed)
    want, jg = jax.value_and_grad(
        lambda p: jxdf.xdeepfm_loss(p, jax.tree.map(jnp.asarray, batch),
                                    JCFG))(jp)
    got, tg = tloop.value_and_grad(
        lambda p, b: txdf.xdeepfm_loss(p, b, TCFG), tp,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(got) - float(want)) <= GRAD_TOL * abs(float(want))
    _assert_leaves_close(tg, jax.tree.leaves(jg), GRAD_TOL, "grad")
    # the table's gradient is dense: rows no id reads are 0, not absent
    embed = tg[flatten_with_paths(tp)[0].index("embed")]
    assert embed.layout == torch.strided
    assert tuple(embed.shape) == (39_000, 10)


def test_loss_splits_a_tie_as_jax():
    """A logit of exactly 0 (every weight 0): ``torch.maximum`` gives the
    tie half the gradient, as ``jnp.maximum`` does."""
    cfg = dict(CFG, vocab_per_field=4)
    jcfg, tcfg = jxdf.XDeepFMConfig(**cfg), txdf.XDeepFMConfig(**cfg)
    jp = jax.tree.map(jnp.zeros_like,
                      jxdf.init_xdeepfm(jax.random.PRNGKey(0), jcfg))
    jp["out_mlp"] = jnp.ones_like(jp["out_mlp"])
    tp = xdeepfm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    batch = {"ids": np.zeros((4, 39), np.int32),
             "labels": np.array([0, 1, 0, 1], np.int32)}
    _, jg = jax.value_and_grad(lambda p: jxdf.xdeepfm_loss(
        p, jax.tree.map(jnp.asarray, batch), jcfg))(jp)
    _, tg = tloop.value_and_grad(
        lambda p, b: txdf.xdeepfm_loss(p, b, tcfg), tp, batch)
    _assert_leaves_close(tg, jax.tree.leaves(jg), 1e-6, "grad at a tie")


@pytest.mark.parametrize("n", [100, 1000])
def test_retrieval_scores_match_jax(params, n):
    jp, tp = params
    q = _ids(3, 1)
    cand = np.random.default_rng(n).integers(0, 39_000, n).astype(np.int32)
    want = np.asarray(jxdf.retrieval_scores(jp, jnp.asarray(q),
                                            jnp.asarray(cand), JCFG))
    got = txdf.retrieval_scores(tp, torch.from_numpy(q),
                                torch.from_numpy(cand), TCFG)
    assert tuple(got.shape) == (n,)
    assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_adamw_step_matches_jax(params, microbatches):
    """One step of each package's ``make_train_step`` from the same
    parameters: loss, gradient norm and the updated parameters (every
    row of the table moves: the gradient is dense and AdamW decays it)."""
    jp, _ = params
    tp = xdeepfm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    oc = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = _batch(4)
    jstep = jax.jit(jloop.make_train_step(
        lambda p, b: jxdf.xdeepfm_loss(p, b, JCFG),
        jopt.OptimizerConfig(**oc), microbatches))
    tstep = tloop.make_train_step(
        lambda p, b: txdf.xdeepfm_loss(p, b, TCFG),
        topt.OptimizerConfig(**oc), microbatches)
    jp2, _, jm = jstep(jp, jopt.init_opt_state(jp),
                       jax.tree.map(jnp.asarray, batch))
    before = tp["embed"].clone()
    tp2, _, tm = tstep(tp, topt.init_opt_state(tp),
                       {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "grad_norm"):
        assert_allclose(float(tm[k]), float(jm[k]), **TOL, err_msg=k)
    paths, got = flatten_with_paths(tp2)
    for path, a, b in zip(paths, got, jax.tree.leaves(jp2)):
        assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0,
                        err_msg=path)
    assert bool((tp2["embed"] != before).all())
