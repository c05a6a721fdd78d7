"""The port's Mixture-of-Experts layer (``repro_torch.layers.moe``) and the
transformer's MoE branches against the JAX package's, on the same numpy
inputs: ``_dispatch_compute`` (routing, positions, capacity drops, the
aux loss and the output), ``_moe_ffn_local``, ``forward``, ``prefill``
and ``decode_step`` of reduced granite-moe-3b-a800m and
moonshot-v1-16b-a3b, and ``moe_ffn`` over ``torch.distributed`` (gloo):
one rank in this process against the JAX function on a (1, 1) mesh,
four spawned ranks in ``ep`` and ``tp`` mode against the JAX package's
local path, and a 2 x 2 data x model layout.

Parameters are seeded numpy (or the JAX package's float32
``init_params``) carried across with
``convert.transformer_params_from_numpy``.  Tolerance: atol = rtol =
2e-4 on every float (the JAX package's own decode-vs-forward and
shard-map-vs-local tolerance); routing choices, positions, the capacity
mask, buffer slots, dropped counts and greedy ids must be equal.
"""
import dataclasses
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
from repro.configs.granite_moe_3b_a800m import ARCH as J_GRANITE
from repro.configs.moonshot_v1_16b_a3b import ARCH as J_MOONSHOT
from repro.layers import moe as jmoe
from repro.models import transformer as jt

from repro_torch import configs as tconfigs
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.layers import moe as tmoe
from repro_torch.models import transformer as tt

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(atol=2e-4, rtol=2e-4)
ARCHS = {"granite-moe-3b-a800m": (J_GRANITE, tconfigs.GRANITE_MOE_3B_A800M),
         "moonshot-v1-16b-a3b": (J_MOONSHOT, tconfigs.MOONSHOT_V1_16B_A3B)}
#: how long a spawned rank may take, start-up and teardown included
RANK_TIMEOUT_S = 120


def _np_tree(p: dict) -> dict:
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in p.items()}


def _moe_arrays(seed: int, d: int, cfg, n_layers: int = 1) -> dict:
    """Stacked MoE parameters as float32 numpy arrays, normal(0, 0.02) as
    the initializers draw them."""
    rng = np.random.default_rng(seed)
    return {name: (rng.standard_normal(shape) * 0.02).astype(np.float32)
            for name, shape in tmoe.moe_param_shapes(d, cfg,
                                                     n_layers).items()}


def _j_cfg(cfg):
    return jmoe.MoEConfig(**dataclasses.asdict(cfg))


# --- routing and dispatch --------------------------------------------------

def _j_slots(x, router, k, n_total, e_off, e_loc, capacity):
    """The JAX package's routing and slot arithmetic
    (``repro.layers.moe._dispatch_compute``, its lines from the router
    logits to the buffer slots), with JAX's own ``top_k``, stable
    ``argsort`` and ``searchsorted``."""
    logits = x.astype(jnp.float32) @ router.astype(jnp.float32)
    gate_vals, idx = jax.lax.top_k(logits, k)
    gates = jax.nn.softmax(gate_vals, axis=-1)
    t = x.shape[0]
    eflat = idx.reshape(-1)
    tflat = jnp.repeat(jnp.arange(t, dtype=jnp.int32), k)
    order = jnp.argsort(eflat, stable=True)
    se, st, sg = eflat[order], tflat[order], gates.reshape(-1)[order]
    starts = jnp.searchsorted(se, jnp.arange(n_total, dtype=se.dtype))
    pos = jnp.arange(t * k, dtype=jnp.int32) - starts[se].astype(jnp.int32)
    local = (se >= e_off) & (se < e_off + e_loc) & (pos < capacity)
    slot_e = jnp.where(local, se - e_off, 0).astype(jnp.int32)
    slot_c = jnp.where(local, pos, 0).astype(jnp.int32)
    return dict(idx=idx, st=st, sg=sg, pos=pos, local=local, slot_e=slot_e,
                slot_c=slot_c)


def _t_slots(x, router, k, n_total, e_off, e_loc, capacity):
    """The port's routing and slots; ``pos``, each sorted pick's place in
    its expert's group, from numpy on the port's picks, and the port's
    buffer slot held to it wherever the pick is kept."""
    _, idx, gate_vals = tmoe.route(x, router, k)
    st, sg, local, slot_e, slot_c = tmoe._slots(
        idx, torch.softmax(gate_vals, dim=-1), n_total_experts=n_total,
        e_off=e_off, e_loc=e_loc, capacity=capacity)
    se = np.sort(idx.numpy().reshape(-1), kind="stable")
    pos = np.arange(se.size) - np.searchsorted(se, se, side="left")
    kept = local.numpy()
    np.testing.assert_array_equal(slot_c.numpy()[kept], pos[kept])
    np.testing.assert_array_equal(kept, ((se >= e_off) & (se < e_off + e_loc)
                                         & (pos < capacity)))
    return dict(idx=idx, st=st, sg=sg, pos=torch.from_numpy(pos),
                local=local, slot_e=slot_e, slot_c=slot_c)


def _hold_slots(got: dict, want: dict) -> None:
    for key in ("idx", "st", "pos", "local", "slot_e", "slot_c"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    assert_allclose(got["sg"].numpy(), np.asarray(want["sg"]), **TOL)


def _dropped(slots: dict, e_off: int, e_loc: int) -> int:
    """Picks of this rank's experts that the capacity drops."""
    se = np.sort(np.asarray(slots["idx"]).reshape(-1), kind="stable")
    mine = (se >= e_off) & (se < e_off + e_loc)
    return int((mine & ~np.asarray(slots["local"])).sum())


DISPATCH = [(cf, e_loc, e_off, shared)
            for cf in (0.5, 1.25, 8.0)
            for e_loc, e_off in ((8, 0), (4, 0), (4, 4))
            for shared in (0, 1)]


@pytest.mark.parametrize(
    "cf,e_loc,e_off,shared", DISPATCH,
    ids=[f"cf{c}-E{e}@{o}-sh{s}" for c, e, o, s in DISPATCH])
def test_dispatch_compute_matches_reference(cf, e_loc, e_off, shared):
    """``_dispatch_compute`` on one rank's experts ``[e_off, e_off +
    E_loc)`` of 8 (the ``ep`` offsets, and every expert), at capacity
    factors that drop many picks (0.5), some (1.25) and none (8.0):
    the same picks, positions, capacity mask, slots and drops as the JAX
    package, and its output and aux loss within 2e-4."""
    cfg = tmoe.MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                         capacity_factor=cf, n_shared_experts=shared)
    p = _moe_arrays(3, 64, cfg)
    x = np.random.default_rng(4).standard_normal((48, 64)).astype(np.float32)
    w = {k: p[k][0][e_off:e_off + e_loc] for k in ("w_gate", "w_up",
                                                   "w_down")}
    router = p["router"][0]
    cap = tmoe.capacity_of(cfg, x.shape[0])
    assert cap == int(cf * 48 * 2 / 8) + 1
    want_out, want_aux = jmoe._dispatch_compute(
        jnp.asarray(x), jnp.asarray(router), *(jnp.asarray(w[k]) for k in
                                               ("w_gate", "w_up", "w_down")),
        cfg=_j_cfg(cfg), e_off=e_off, n_total_experts=8, act="silu",
        capacity=cap)
    got_out, got_aux = tmoe._dispatch_compute(
        torch.from_numpy(x), torch.from_numpy(router),
        *(torch.from_numpy(w[k]) for k in ("w_gate", "w_up", "w_down")),
        cfg=cfg, e_off=e_off, n_total_experts=8, act="silu", capacity=cap)
    assert got_out.dtype == torch.float32 and got_out.shape == (48, 64)
    assert_allclose(got_out.numpy(), np.asarray(want_out), **TOL)
    assert_allclose(float(got_aux), float(want_aux), **TOL)
    want = _j_slots(jnp.asarray(x), jnp.asarray(router), 2, 8, e_off, e_loc,
                    cap)
    got = _t_slots(torch.from_numpy(x), torch.from_numpy(router), 2, 8,
                   e_off, e_loc, cap)
    _hold_slots(got, want)
    drops = _dropped(got, e_off, e_loc)
    assert drops == _dropped(want, e_off, e_loc)
    if cf == 8.0:
        assert drops == 0
    elif cf == 0.5 and e_loc == 8:
        assert drops > 0


@pytest.mark.parametrize("k", [1, 2, 6])
def test_exact_ties_route_like_jax(k):
    """An all-zero router ties every expert: ``jax.lax.top_k`` picks
    experts 0..k-1 for every token, the lower index first, and so must
    the port; the gates are uniform, expert 0 overflows its capacity,
    and the drops, output and aux loss equal the JAX package's."""
    cfg = tmoe.MoEConfig(n_experts=8, top_k=k, d_ff_expert=16)
    p = _moe_arrays(5, 32, cfg)
    p["router"][:] = 0.0
    x = np.random.default_rng(6).standard_normal((20, 32)).astype(np.float32)
    cap = tmoe.capacity_of(cfg, 20)
    want = _j_slots(jnp.asarray(x), jnp.asarray(p["router"][0]), k, 8, 0, 8,
                    cap)
    got = _t_slots(torch.from_numpy(x), torch.from_numpy(p["router"][0]), k,
                   8, 0, 8, cap)
    assert np.asarray(want["idx"]).tolist() == [list(range(k))] * 20
    _hold_slots(got, want)
    assert _dropped(got, 0, 8) == _dropped(want, 0, 8) == k * (20 - cap)
    args = [p[n][0] for n in ("router", "w_gate", "w_up", "w_down")]
    want_out, want_aux = jmoe._dispatch_compute(
        jnp.asarray(x), *map(jnp.asarray, args), cfg=_j_cfg(cfg), e_off=0,
        n_total_experts=8, act="silu", capacity=cap)
    got_out, got_aux = tmoe._dispatch_compute(
        torch.from_numpy(x), *map(torch.from_numpy, args), cfg=cfg, e_off=0,
        n_total_experts=8, act="silu", capacity=cap)
    assert_allclose(got_out.numpy(), np.asarray(want_out), **TOL)
    assert_allclose(float(got_aux), float(want_aux), **TOL)


def test_route_breaks_ties_to_the_lower_expert():
    """Ties among some experts only, and ties across the k-th place: the
    picks are ``jax.lax.top_k``'s, highest first, lower index first."""
    logits = np.array([[1.0, 3.0, 3.0, 0.5, 3.0, 1.0],
                       [2.0, 2.0, 2.0, 2.0, 2.0, 2.0],
                       [0.0, -1.0, 5.0, 5.0, -1.0, 0.0]], np.float32)
    x = np.eye(3, dtype=np.float32)
    for k in (1, 2, 3, 4):
        _, want = jax.lax.top_k(jnp.asarray(logits), k)
        _, idx, vals = tmoe.route(torch.from_numpy(x),
                                  torch.from_numpy(logits), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
        assert torch.equal(vals, torch.from_numpy(logits).gather(1, idx))


def test_capacity_at_decode_drops_like_jax():
    """At decode ``T = B``: the full configs' capacities at batch 4 (2 for
    granite, 1 for moonshot) and at the 4 x 2048 prompt; at the reduced
    configs' batch of 2 the capacity is 1, so a token whose pick another
    token took first is dropped in both packages."""
    g = tconfigs.GRANITE_MOE_3B_A800M.moe
    m = tconfigs.MOONSHOT_V1_16B_A3B.moe
    assert tmoe.capacity_of(g, 4) == 2 and tmoe.capacity_of(m, 4) == 1
    assert tmoe.capacity_of(g, 8192) == 2049
    assert tmoe.capacity_of(m, 8192) == 961
    for arch in ARCHS:
        red = tconfigs.reduced_cfg(ARCHS[arch][1]).moe
        assert tmoe.capacity_of(red, 2) == 1


# --- the transformer's MoE branches ---------------------------------------

def _pair(arch: str, **over):
    jarch, tcfg = ARCHS[arch]
    jcfg = dataclasses.replace(jarch.reduced_cfg(), **over)
    tcfg = dataclasses.replace(tconfigs.reduced_cfg(tcfg), **over)
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tp = transformer_params_from_numpy(_np_tree(jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_ffn_local_matches_reference(arch, cf):
    """The transformer's one-device MoE FFN (routed experts, then the
    shared ones for moonshot) on one layer's parameters."""
    jcfg, tcfg, jp, tp = _pair(arch)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=cf))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=cf))
    x = np.random.default_rng(8).standard_normal((2, 12, 64)).astype(
        np.float32)
    jlp = {k: v[1] for k, v in jp["moe"].items()}
    tlp = {k: v[1] for k, v in tp["moe"].items()}
    jy, jaux = jt._moe_ffn_local(jnp.asarray(x), jlp, jcfg)
    ty, taux = tt._moe_ffn_local(torch.from_numpy(x), tlp, tcfg)
    assert ty.dtype == torch.float32 and ty.shape == (2, 12, 64)
    assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert_allclose(float(taux), float(jaux), **TOL)


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("n_layers", [2, 3])
def test_moe_serving_slice_matches_jax(arch, n_layers):
    """prefill logits and caches, four greedy decode steps at batch 2
    (capacity 1: tokens drop at every step, in both packages), and
    forward's hidden states and mean aux loss, both packages on the same
    weights and prompt."""
    jcfg, tcfg, jp, tp = _pair(arch, n_layers=n_layers)
    toks = np.random.default_rng(7).integers(
        0, tcfg.vocab_size, (2, 12)).astype(np.int32)
    ml = 32
    jcache, jlog = jt.prefill(jp, jnp.asarray(toks), jcfg, max_len=ml)
    tcache, tlog = tt.prefill(tp, torch.from_numpy(toks), tcfg, max_len=ml)
    assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for key in ("k", "v"):
        assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]), **TOL)
    jn = jnp.argmax(jlog, -1).astype(jnp.int32)
    tn = tlog.argmax(-1)
    for _ in range(4):
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        jlog, jcache = jt.decode_step(jp, jcache, jn, jcfg)
        tlog, tcache = tt.decode_step(tp, tcache, tn, tcfg)
        assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        jn = jnp.argmax(jlog, -1).astype(jnp.int32)
        tn = tlog.argmax(-1)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    for key in ("k", "v"):
        assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]), **TOL)
    assert tcache["len"] == int(jcache["len"]) == 16
    jx, jaux = jt.forward(jp, jnp.asarray(toks), jcfg)
    tx, taux = tt.forward(tp, torch.from_numpy(toks), tcfg)
    assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    assert float(jaux) > 0
    assert_allclose(float(taux), float(jaux), **TOL)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_moe_decode_matches_forward_where_nothing_drops(arch):
    """The port against itself, as the JAX package compares MoE routes:
    at ``capacity_factor = n_experts / top_k`` no token can drop, so the
    greedy decode logits equal the last-position logits of ``forward``
    over the concatenated stream."""
    _, tcfg, _, _ = _pair(arch)
    moe = tcfg.moe
    tcfg = dataclasses.replace(tcfg, n_layers=3, moe=dataclasses.replace(
        moe, capacity_factor=moe.n_experts / moe.top_k))
    p = tt.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, 512, (2, 12)))
    cache, _ = tt.prefill(p, toks, tcfg, max_len=48)
    nxt, outs = toks[:, :1], []
    for _ in range(4):
        lg, cache = tt.decode_step(p, cache, nxt, tcfg)
        outs.append(lg)
        nxt = lg.argmax(-1)
    stream = torch.cat([toks, toks[:, :1]], dim=1)
    for i in range(3):
        x, _ = tt.forward(p, stream, tcfg)
        full = tt._lm_logits(x[:, -1:, :], p, tcfg)
        assert_allclose(outs[i].numpy(), full.numpy(), **TOL)
        stream = torch.cat([stream, full.argmax(-1)], dim=1)


def test_init_params_draws_moe_stacks_layer_by_layer():
    """The nested ``moe`` dict: every stacked tensor in ``cfg.dtype`` but
    the float32 router, with the JAX package's names and shapes; each
    layer of a stack is drawn on its own, so one seed gives the same
    first layer whatever the depth."""
    cfg = dataclasses.replace(tconfigs.reduced_cfg(
        tconfigs.MOONSHOT_V1_16B_A3B), dtype=torch.bfloat16)
    p = tt.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    shapes = tt.param_shapes(cfg)
    assert set(p) == set(shapes) and "w_gate" not in p
    assert {k: tuple(v.shape) for k, v in p["moe"].items()} == shapes["moe"]
    assert p["moe"]["router"].dtype == torch.float32
    assert all(v.dtype == torch.bfloat16 for k, v in p["moe"].items()
               if k != "router")
    stack = tmoe.init_moe_params(torch.Generator().manual_seed(9), 64,
                                 cfg.moe, 3, dtype=torch.bfloat16,
                                 device="cpu")
    one = tmoe.init_moe_params(torch.Generator().manual_seed(9), 64,
                               cfg.moe, 1, dtype=torch.bfloat16,
                               device="cpu")
    assert torch.equal(stack["router"][0], one["router"][0])
    assert float(stack["w_gate"].float().std()) == pytest.approx(0.02,
                                                                 rel=0.1)


def test_params_from_numpy_checks_the_nested_moe_dict():
    """Both levels' names and shapes are checked; bf16 experts stay bf16
    and the router float32."""
    jarch, tcfg = ARCHS["granite-moe-3b-a800m"]
    jcfg = dataclasses.replace(jarch.reduced_cfg(), dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tconfigs.reduced_cfg(tcfg),
                               dtype=torch.bfloat16)
    jp = _np_tree(jt.init_params(jax.random.PRNGKey(0), jcfg))
    tp = transformer_params_from_numpy(jp, tcfg, device="cpu")
    assert tp["moe"]["router"].dtype == torch.float32
    assert tp["moe"]["w_gate"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["moe"]["w_up"].float().numpy(),
                                  jp["moe"]["w_up"].astype(np.float32))
    bf_router = dict(jp, moe=dict(
        jp["moe"], router=jp["moe"]["router"].astype(jp["moe"]["w_up"].dtype)))
    assert transformer_params_from_numpy(
        bf_router, tcfg, device="cpu")["moe"]["router"].dtype == torch.float32
    bad = dict(jp, moe=dict(jp["moe"], w_down=jp["moe"]["w_down"][:, :, :8]))
    with pytest.raises(ValueError, match="moe/w_down"):
        transformer_params_from_numpy(bad, tcfg, device="cpu")
    missing = dict(jp, moe={k: v for k, v in jp["moe"].items()
                            if k != "router"})
    with pytest.raises(ValueError, match="moe/"):
        transformer_params_from_numpy(missing, tcfg, device="cpu")
    flat = {k: v for k, v in jp.items() if k != "moe"}
    with pytest.raises(ValueError, match="names"):
        transformer_params_from_numpy(flat, tcfg, device="cpu")


def test_param_specs_and_shards():
    """``moe_param_specs`` are the JAX package's ``PartitionSpec``s entry
    for entry; ``shard_moe_params`` cuts each ``model`` axis into equal
    blocks and keeps the router whole."""
    for mode in ("ep", "tp"):
        for shared in (0, 2):
            for fsdp in (False, True):
                cfg = tmoe.MoEConfig(8, 2, 64, shard_mode=mode,
                                     n_shared_experts=shared)
                want = jmoe.moe_param_specs(_j_cfg(cfg), fsdp)
                got = tmoe.moe_param_specs(cfg, fsdp)
                assert got.keys() == want.keys()
                for k in got:
                    assert got[k] == tuple(want[k]), (mode, k)
    cfg = tmoe.MoEConfig(8, 2, 64, shard_mode="ep", n_shared_experts=1)
    p = {k: torch.from_numpy(v) for k, v in
         _moe_arrays(0, 32, cfg, n_layers=2).items()}
    sh = tmoe.shard_moe_params(p, cfg, 3, 4)
    assert torch.equal(sh["w_gate"], p["w_gate"][:, 6:8])
    assert torch.equal(sh["sh_down"], p["sh_down"][:, 48:64])
    assert sh["router"] is p["router"]
    tp_cfg = dataclasses.replace(cfg, shard_mode="tp")
    sh = tmoe.shard_moe_params(p, tp_cfg, 1, 4)
    assert torch.equal(sh["w_down"], p["w_down"][:, :, 16:32])
    assert torch.equal(sh["w_up"], p["w_up"][..., 16:32])
    with pytest.raises(ValueError, match="split"):
        tmoe.shard_moe_params(p, cfg, 0, 3)


# --- moe_ffn over a process group -----------------------------------------

@pytest.fixture(scope="module")
def gloo1(tmp_path_factory):
    store = tmp_path_factory.mktemp("moe_gloo1") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1, timeout=timedelta(seconds=60))
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mode,shared", [("ep", 2), ("tp", 0), ("ep", 0)])
def test_moe_ffn_one_rank_matches_jax_moe_ffn(gloo1, mode, shared):
    """One gloo rank against the JAX function on a (1, 1) data x model
    mesh, at the default capacity factor (so picks drop): the same output
    and aux loss, and the same as the port's ``_moe_ffn_local``."""
    cfg = tmoe.MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                         shard_mode=mode, n_shared_experts=shared)
    p = {k: v[0] for k, v in _moe_arrays(1, 64, cfg).items()}
    x = np.random.default_rng(2).standard_normal((4, 8, 64)).astype(
        np.float32)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jy, jaux = jmoe.moe_ffn(jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                             p.items()}, _j_cfg(cfg), mesh,
                            dtype=jnp.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    ty, taux = tmoe.moe_ffn(torch.from_numpy(x), tp, cfg, gloo1,
                            dtype=torch.float32)
    assert ty.shape == (4, 8, 64) and ty.dtype == torch.float32
    assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert_allclose(float(taux), float(jaux), **TOL)

    class Cfg:
        moe, act, dtype = cfg, "silu", torch.float32
    ly, laux = tt._moe_ffn_local(torch.from_numpy(x), tp, Cfg)
    assert_allclose(ty.numpy(), ly.numpy(), **TOL)
    assert float(taux) == float(laux)
    bf, _ = tmoe.moe_ffn(torch.from_numpy(x), tp, cfg, gloo1,
                         dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16


def test_moe_ffn_refuses_wrong_shards_and_backends(gloo1, monkeypatch):
    cfg = tmoe.MoEConfig(n_experts=8, top_k=2, d_ff_expert=32)
    p = {k: torch.from_numpy(v[0]) for k, v in
         _moe_arrays(1, 16, cfg).items()}
    x = torch.zeros(1, 4, 16)
    half = dict(p, w_gate=p["w_gate"][:4])
    with pytest.raises(ValueError, match="experts"):
        tmoe.moe_ffn(x, half, cfg, gloo1)
    tcfg = dataclasses.replace(cfg, shard_mode="tp")
    with pytest.raises(ValueError, match="columns"):
        tmoe.moe_ffn(x, dict(p, w_gate=p["w_gate"][..., :16]), tcfg, gloo1)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    with pytest.raises(ValueError, match="gloo"):
        tmoe.moe_ffn(x, p, cfg, gloo1)


RANK_SCRIPT = """
import json, sys
from datetime import timedelta
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + tmp + "/store",
                        rank=rank, world_size=world,
                        timeout=timedelta(seconds=60))
from repro_torch.layers.moe import MoEConfig, moe_ffn, shard_moe_params
cases = json.load(open(tmp + "/cases.json"))
# the 2 x 2 layout: rank = data * 2 + model; every rank makes every
# group, in one order
model_groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
data_groups = [dist.new_group([0, 2]), dist.new_group([1, 3])]
out = {}
for name, case in cases.items():
    cfg = MoEConfig(**case["cfg"])
    arrays = np.load(tmp + "/" + name + ".npz")
    params = {k[2:]: torch.from_numpy(arrays[k]) for k in arrays.files
              if k.startswith("p_")}
    x = torch.from_numpy(arrays["x"])
    if case["layout"] == "model4":
        group, data_group, m_rank, m_world = None, None, rank, world
    else:
        d_idx, m_rank, m_world = rank // 2, rank % 2, 2
        group, data_group = model_groups[d_idx], data_groups[m_rank]
        x = x.chunk(2, dim=0)[d_idx]
    lp = {k: v[0] for k, v in
          shard_moe_params(params, cfg, m_rank, m_world).items()}
    y, aux = moe_ffn(x, lp, cfg, group, dtype=torch.float32,
                     data_group=data_group)
    np.save(tmp + "/" + name + "_y%d.npy" % rank, y.numpy())
    out[name] = float(aux)
dist.barrier()
dist.destroy_process_group()
print("RESULT " + json.dumps(out))
"""

#: the spawned cases: ep (8 experts / 4 ranks, one shared expert) and tp
#: (d_ff_expert 64 / 4) over a model group of four at the default
#: capacity factor (picks drop), then both over the 2 x 2 data x model
#: layout at a factor where nothing drops
RANK_CASES = {
    "ep4": dict(cfg=dict(n_experts=8, top_k=2, d_ff_expert=64,
                         shard_mode="ep", n_shared_experts=1),
                layout="model4"),
    "tp4": dict(cfg=dict(n_experts=8, top_k=2, d_ff_expert=64,
                         shard_mode="tp"), layout="model4"),
    "ep2x2": dict(cfg=dict(n_experts=8, top_k=2, d_ff_expert=32,
                           shard_mode="ep", capacity_factor=8.0,
                           n_shared_experts=1), layout="2x2"),
    "tp2x2": dict(cfg=dict(n_experts=8, top_k=2, d_ff_expert=32,
                           shard_mode="tp", capacity_factor=8.0),
                  layout="2x2"),
}


def _spawn_ranks(world: int, tmp: Path) -> list[dict]:
    """Run ``RANK_SCRIPT`` as ``world`` spawned processes; each joins
    within ``RANK_TIMEOUT_S`` or the test fails (no hang)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(RANK_SCRIPT), str(r),
         str(world), str(tmp)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
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


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    """Inputs written for the spawned ranks, their results, and the JAX
    package's local path on the same inputs."""
    tmp = tmp_path_factory.mktemp("moe4")
    (tmp / "cases.json").write_text(json.dumps(RANK_CASES))
    inputs = {}
    for i, (name, case) in enumerate(RANK_CASES.items()):
        cfg = tmoe.MoEConfig(**case["cfg"])
        p = _moe_arrays(10 + i, 64, cfg)
        x = np.random.default_rng(20 + i).standard_normal(
            (8, 16, 64)).astype(np.float32)
        np.savez(tmp / f"{name}.npz", x=x,
                 **{f"p_{k}": v for k, v in p.items()})
        inputs[name] = (cfg, p, x)
    auxs = _spawn_ranks(4, tmp)
    ys = {name: [np.load(tmp / f"{name}_y{r}.npy") for r in range(4)]
          for name in RANK_CASES}
    return inputs, auxs, ys


def _j_local(cfg, p, x):
    class Cfg:
        moe, act, dtype = _j_cfg(cfg), "silu", jnp.float32
    lp = {k: jnp.asarray(v[0]) for k, v in p.items()}
    return jt._moe_ffn_local(jnp.asarray(x), lp, Cfg)


@pytest.mark.parametrize("name", ["ep4", "tp4"])
def test_four_ranks_model_group_matches_reference(ranks4, name):
    """Four ranks of one model group (every rank has every token): each
    rank's output and aux loss equal the JAX package's one-device path
    at the config's own capacity factor, where picks drop."""
    inputs, auxs, ys = ranks4
    cfg, p, x = inputs[name]
    jy, jaux = _j_local(cfg, p, x)
    for r in range(4):
        assert_allclose(ys[name][r], np.asarray(jy), **TOL)
        assert_allclose(auxs[r][name], float(jaux), **TOL)


@pytest.mark.parametrize("name", ["ep2x2", "tp2x2"])
def test_two_by_two_layout_matches_reference(ranks4, name):
    """A 2 x 2 data x model layout at a factor where nothing drops: each
    data rank's half of the batch equals the JAX package's one-device
    output on the whole batch (as ``test_moe_shard_map_matches_local``
    holds the JAX function), and the aux loss is the mean of the two
    halves' (averaged over the model and then the data ranks)."""
    inputs, auxs, ys = ranks4
    cfg, p, x = inputs[name]
    jy, _ = _j_local(cfg, p, x)
    halves = np.split(np.asarray(jy), 2, axis=0)
    want_aux = np.mean([float(_j_local(cfg, p, h)[1])
                        for h in np.split(x, 2, axis=0)])
    for r in range(4):
        assert_allclose(ys[name][r], halves[r // 2], **TOL)
        assert_allclose(auxs[r][name], want_aux, **TOL)
