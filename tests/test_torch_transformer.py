"""The port's dense transformer against the JAX package on the same
weights: configs, layers, and the serving slice (prefill, decode_step,
forward) for reduced stablelm-3b and chatglm3-6b.

The JAX package's float32 parameters (``init_params(PRNGKey(0), ...)``)
are carried across with ``convert.transformer_params_from_numpy``, and
the same prompt runs through both packages.  Tolerance: atol = rtol =
2e-4 on logits, caches and hidden states, the JAX package's own
decode-vs-forward tolerance (``tests/test_models_and_equivariance.py``);
greedy ids must be equal.  Layers: 1e-6 (float32 elementwise math in
both packages, differing only in rounding).
"""
import dataclasses

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
from repro.layers import common as jl
from repro.models import transformer as jt

from repro_torch import configs as tconfigs
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.layers import common as tl
from repro_torch.models import transformer as tt

torch.set_num_threads(1)

ARCHS = {"stablelm-3b": (J_STABLELM, tconfigs.STABLELM_3B),
         "chatglm3-6b": (J_CHATGLM, tconfigs.CHATGLM3_6B)}
#: the MoE configs, whose fields and counts are held here and whose
#: layers and serving slice ``tests/test_torch_moe.py`` holds
MOE_ARCHS = {"granite-moe-3b-a800m": (J_GRANITE,
                                      tconfigs.GRANITE_MOE_3B_A800M),
             "moonshot-v1-16b-a3b": (J_MOONSHOT,
                                     tconfigs.MOONSHOT_V1_16B_A3B)}
TOL = dict(atol=2e-4, rtol=2e-4)


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) \
        else jnp.dtype(dt).name


@pytest.mark.parametrize("arch", sorted(ARCHS) + sorted(MOE_ARCHS))
@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_match(arch, reduced):
    jarch, tcfg = {**ARCHS, **MOE_ARCHS}[arch]
    jcfg = jarch.reduced_cfg() if reduced else jarch.cfg
    if reduced:
        tcfg = tconfigs.reduced_cfg(tcfg)
    jf = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    tf = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}
    assert set(jf) == set(tf)
    for name, jv in jf.items():
        if name == "dtype":
            assert _dtype_name(tf[name]) == _dtype_name(jv)
        elif name == "moe" and jv is not None:
            assert dataclasses.asdict(tf[name]) == dataclasses.asdict(jv)
        else:
            assert tf[name] == jv, name
    for prop in ("n_params", "n_active_params", "padded_vocab", "head_dim"):
        assert getattr(tcfg, prop) == getattr(jcfg, prop), prop


def test_full_size_counts():
    """chatglm3-6b: 6.24 B parameters, GQA group 16; stablelm-3b's
    vocab pads 50304 -> 50432; granite-moe-3b-a800m: 3.30 B parameters
    (0.88 B active), heads of 64 in GQA groups of 3; moonshot-v1-16b-a3b:
    28.55 B (4.47 B active), heads of 128."""
    g = tconfigs.CHATGLM3_6B
    assert g.n_params == 6_243_454_976 and g.n_heads // g.n_kv_heads == 16
    assert tconfigs.STABLELM_3B.padded_vocab == 50432
    gr, mo = tconfigs.GRANITE_MOE_3B_A800M, tconfigs.MOONSHOT_V1_16B_A3B
    assert (gr.n_params, gr.n_active_params) == (3_298_793_472, 882_874_368)
    assert gr.head_dim == 64 and gr.n_heads // gr.n_kv_heads == 3
    assert (mo.n_params, mo.n_active_params) == (28_552_923_136,
                                                 4_469_229_568)
    assert mo.head_dim == 128 and mo.padded_vocab == 163840
    for arch, (jarch, tcfg) in MOE_ARCHS.items():
        assert tcfg.n_params == jarch.cfg.n_params, arch
        assert tcfg.n_active_params == jarch.cfg.n_active_params, arch
        red = tconfigs.reduced_cfg(tcfg)
        assert red.n_params == jarch.reduced_cfg().n_params, arch
        assert (red.moe.n_experts, red.moe.d_ff_expert) == (8, 64)


# --- layers --------------------------------------------------------------

def _x(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match(kind):
    x, s = _x(0, (2, 5, 64), 3.0) + 1.5, _x(1, (64,))
    jfn = jl.make_norm(kind)
    tfn = tl.make_norm(kind)
    want = jfn(jnp.asarray(x), {"scale": jnp.asarray(s)})
    got = tfn(torch.from_numpy(x), {"scale": torch.from_numpy(s)})
    assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    # bf16 in, bf16 out, f32 math inside
    xb = torch.from_numpy(x).bfloat16()
    got_b = tfn(xb, {"scale": torch.from_numpy(s)})
    want_b = jfn(jnp.asarray(x, jnp.bfloat16), {"scale": jnp.asarray(s)})
    assert got_b.dtype == torch.bfloat16
    assert_allclose(got_b.float().numpy(), np.asarray(want_b, np.float32),
                    atol=2e-2, rtol=2e-2)


def test_layernorm_bias_matches():
    x, s, b = _x(2, (3, 32)), _x(3, (32,)), _x(4, (32,))
    want = jl.layernorm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    got = tl.layernorm(torch.from_numpy(x), torch.from_numpy(s),
                       torch.from_numpy(b))
    assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("rot_frac", [1.0, 0.5, 0.25, 0.3])
@pytest.mark.parametrize("d_head", [16, 128])
def test_apply_rope_matches(rot_frac, d_head):
    """Interleaved pairs (dims 2i, 2i+1) on the leading
    int(d_head * rot_frac) dims, rounded down to even."""
    x = _x(5, (2, 7, 3, d_head))
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), rot_frac)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), rot_frac)
    assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("kind", ["gelu", "silu", "relu"])
def test_act_fn_matches(kind):
    x = _x(6, (100,), 4.0)
    assert_allclose(tl.act_fn(kind)(torch.from_numpy(x)).numpy(),
                    np.asarray(jl.act_fn(kind)(jnp.asarray(x))),
                    atol=1e-6, rtol=1e-6)


def test_rope_frequencies_match():
    assert_allclose(tl.rope_frequencies(32, 500_000.0).numpy(),
                    np.asarray(jl.rope_frequencies(32, 500_000.0)),
                    rtol=1e-6)


def test_normal_init_takes_a_generator():
    g = torch.Generator().manual_seed(3)
    a = tl.normal_init(g, (4, 5), stddev=0.5, dtype=torch.bfloat16)
    b = tl.normal_init(torch.Generator().manual_seed(3), (4, 5), stddev=0.5,
                       dtype=torch.bfloat16)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)


# --- the serving slice ---------------------------------------------------

def _pair(arch: str, n_layers: int, **over):
    jarch, tcfg = ARCHS[arch]
    jcfg = dataclasses.replace(jarch.reduced_cfg(), n_layers=n_layers, **over)
    tcfg = dataclasses.replace(tconfigs.reduced_cfg(tcfg), n_layers=n_layers,
                               **over)
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tp = transformer_params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


CASES = [(a, n, {}) for a in sorted(ARCHS) for n in (2, 3)] + [
    ("chatglm3-6b", 3, {"vocab_size": 250}),
    ("stablelm-3b", 2, {"vocab_size": 250})]


@pytest.mark.parametrize("arch,n_layers,over", CASES,
                         ids=[f"{a}-L{n}{'-v250' if o else ''}"
                              for a, n, o in CASES])
def test_serving_slice_matches_jax(arch, n_layers, over):
    """prefill logits and caches, four greedy decode steps, and forward
    hidden states, both packages on the same weights and prompt."""
    jcfg, tcfg, jp, tp = _pair(arch, n_layers, **over)
    assert tcfg.padded_vocab == jcfg.padded_vocab
    toks = np.random.default_rng(7).integers(
        0, tcfg.vocab_size, (2, 12)).astype(np.int32)
    ml = 32
    jcache, jlog = jt.prefill(jp, jnp.asarray(toks), jcfg, max_len=ml)
    tcache, tlog = tt.prefill(tp, torch.from_numpy(toks), tcfg, max_len=ml)
    assert tlog.shape == (2, 1, tcfg.padded_vocab)
    assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for key in ("k", "v"):
        assert tcache[key].shape == jcache[key].shape
        assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]), **TOL)
    assert tcache["len"] == int(jcache["len"]) == 12
    jn = jnp.argmax(jlog, -1).astype(jnp.int32)
    tn = tlog.argmax(-1)
    for _ in range(4):
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        jlog, jcache = jt.decode_step(jp, jcache, jn, jcfg)
        tlog, tcache = tt.decode_step(tp, tcache, tn, tcfg)
        assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        jn = jnp.argmax(jlog, -1).astype(jnp.int32)
        tn = tlog.argmax(-1)
        assert int(tn.max()) < tcfg.vocab_size     # padded ids are masked
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    for key in ("k", "v"):
        assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]), **TOL)
    assert tcache["len"] == int(jcache["len"]) == 16
    jx, jaux = jt.forward(jp, jnp.asarray(toks), jcfg)
    tx, taux = tt.forward(tp, torch.from_numpy(toks), tcfg)
    assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    assert float(taux) == float(jaux) == 0.0


def test_decode_matches_full_forward():
    """The port against itself, as the JAX package's
    ``test_decode_matches_full_forward`` runs: greedy decode logits equal
    the last-position logits of ``forward`` over the concatenated
    stream."""
    cfg = tt.TransformerConfig(name="t", n_layers=3, d_model=64, n_heads=4,
                               n_kv_heads=2, d_ff=128, vocab_size=256,
                               dtype=torch.float32, remat=False,
                               max_cache_len=48)
    p = tt.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 12)))
    cache, _ = tt.prefill(p, toks, cfg, max_len=48)
    nxt = toks[:, :1]
    outs = []
    for _ in range(4):
        lg, cache = tt.decode_step(p, cache, nxt, cfg)
        outs.append(lg)
        nxt = lg.argmax(-1)
    stream = torch.cat([toks, toks[:, :1]], dim=1)
    for i in range(3):
        x, _ = tt.forward(p, stream, cfg)
        full = tt._lm_logits(x[:, -1:, :], p, cfg)
        assert_allclose(outs[i].numpy(), full.numpy(), **TOL)
        stream = torch.cat([stream, full.argmax(-1)], dim=1)


def test_out_of_range_token_ids_clamp_like_jax():
    """``params["embed"][tokens]`` clamps in JAX (7 -> 4, -7 -> 0 on a
    table of 5; -1 -> 4); PyTorch would raise.  The port clamps the same
    way, in forward, prefill and decode."""
    assert np.asarray(jnp.arange(5)[jnp.asarray([7, -7, -1])]).tolist() == \
        [4, 0, 4]
    jcfg, tcfg, jp, tp = _pair("chatglm3-6b", 2)
    v = tcfg.padded_vocab
    toks = np.array([[3, v + 5, -v - 9, -1, 7, v - 1]], np.int32)
    jx, _ = jt.forward(jp, jnp.asarray(toks), jcfg)
    tx, _ = tt.forward(tp, torch.from_numpy(toks), tcfg)
    assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    jcache, _ = jt.prefill(jp, jnp.asarray(toks), jcfg, max_len=8)
    tcache, _ = tt.prefill(tp, torch.from_numpy(toks), tcfg, max_len=8)
    step = np.array([[v + 100]], np.int32)
    jlog, _ = jt.decode_step(jp, jcache, jnp.asarray(step), jcfg)
    tlog, _ = tt.decode_step(tp, tcache, torch.from_numpy(step), tcfg)
    assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)


def test_decode_write_position_clamps_like_jax():
    """``jax.lax.dynamic_update_slice`` clamps its start: with the cache
    full (len >= max_len) the token's K/V overwrite slot max_len - 1
    (writing at 6 into length 4 writes slot 3).  The port does the
    same."""
    got = jax.lax.dynamic_update_slice_in_dim(jnp.zeros(4), jnp.ones(1), 6,
                                              axis=0)
    assert np.asarray(got).tolist() == [0, 0, 0, 1]
    jcfg, tcfg, jp, tp = _pair("stablelm-3b", 2)
    toks = np.random.default_rng(2).integers(0, 512, (2, 6)).astype(np.int32)
    jcache, jlog = jt.prefill(jp, jnp.asarray(toks), jcfg, max_len=6)
    tcache, tlog = tt.prefill(tp, torch.from_numpy(toks), tcfg, max_len=6)
    for _ in range(3):   # len 6, 7, 8 against a 6-slot cache
        jn = jnp.argmax(jlog, -1).astype(jnp.int32)
        jlog, jcache = jt.decode_step(jp, jcache, jn, jcfg)
        tlog, tcache = tt.decode_step(tp, tcache, tlog.argmax(-1), tcfg)
        assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]), **TOL)
    assert tcache["len"] == int(jcache["len"]) == 9


def test_prefill_longer_than_cache_raises():
    _, tcfg, _, tp = _pair("chatglm3-6b", 2)
    with pytest.raises(ValueError, match="max_len"):
        tt.prefill(tp, torch.zeros((1, 9), dtype=torch.int64), tcfg,
                   max_len=8)


def test_params_from_numpy_keeps_bf16_and_checks_shapes():
    jarch, tcfg = ARCHS["chatglm3-6b"]
    jcfg = dataclasses.replace(jarch.reduced_cfg(), dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tconfigs.reduced_cfg(tcfg),
                               dtype=torch.bfloat16)
    jp = {k: np.asarray(v) for k, v in
          jt.init_params(jax.random.PRNGKey(0), jcfg).items()}
    tp = transformer_params_from_numpy(jp, tcfg, device="cpu")
    assert tp["wq"].dtype == torch.bfloat16 and tp["ln1"].dtype == \
        torch.float32
    np.testing.assert_array_equal(tp["wq"].float().numpy(),
                                  jp["wq"].astype(np.float32))
    assert {k: tuple(v.shape) for k, v in tp.items()} == tt.param_shapes(tcfg)
    bad = dict(jp, wq=jp["wq"][:, :, :8])
    with pytest.raises(ValueError, match="wq"):
        transformer_params_from_numpy(bad, tcfg, device="cpu")
