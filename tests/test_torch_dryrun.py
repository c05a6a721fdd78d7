"""The dry-run cells of the port against the JAX package's.

Every (arch × shape) cell of the 11 architectures, the §Perf variants
included, is built on a 1×1 mesh in both packages and compared in kind,
skip reason, model FLOPs (a relative 1e-12), the abstract arguments'
(shape, dtype) leaves in JAX's order, the in/out sharding specs (as
tuples), the donated arguments and ``n_scan``; the KV cache's specs are
compared on a 16×16 mesh.  Then cells of the reduced configs at small
shapes run their functions on the same numpy inputs in both packages:
the LM train, prefill and decode cells within the LM parity tests' 2e-4
(parameters after an AdamW step within 3 of that step's learning rates,
as ``test_torch_train.py`` holds them), GatedGCN's train cell within the
GNN tests' 1e-5 (``grad_norm`` 1e-4), xDeepFM's within its tests' 1e-4
of the largest |want|, and the WCOJ cells' counts exactly (int64).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from numpy.testing import assert_allclose, assert_array_equal

import repro  # noqa: F401  (x64, as the JAX package's own tests run)
from repro.configs import ARCHS as J_ARCHS
from repro.configs import common as jcommon
from repro.configs.wcoj import WCOJArch as JWCOJArch
from repro.graphs import powerlaw_cluster
from repro.models import transformer as jt
from repro.models import xdeepfm as jxdf
from repro.models.gnn import gatedgcn as jgcn
from repro.train import optimizer as jopt

from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import common as tcommon
from repro_torch.configs.wcoj import WCOJArch as TWCOJArch
from repro_torch.convert import (gnn_params_from_numpy,
                                 transformer_params_from_numpy,
                                 xdeepfm_params_from_numpy)
from repro_torch.launch.mesh import Mesh, make_mesh, make_production_mesh
from repro_torch.models import transformer as tt
from repro_torch.train import optimizer as topt
from repro_torch.train.tree import flatten_with_paths, leaves

torch.set_num_threads(1)

LM_ARCHS = ["stablelm-3b", "chatglm3-6b", "command-r-plus-104b",
            "moonshot-v1-16b-a3b", "granite-moe-3b-a800m"]
GNN_ARCHS = ["gatedgcn", "egnn", "pna", "mace"]
LM_TOL = dict(atol=2e-4, rtol=2e-4)
GNN_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = 1e-4


def _meshes():
    return (jax.make_mesh((1, 1), ("data", "model")),
            make_mesh((1, 1), ("data", "model")))


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def _arg_leaves(cell, port: bool) -> list:
    flat = leaves(cell.args) if port else jax.tree.leaves(cell.args)
    return [(tuple(x.shape), _dtype_name(x.dtype)) for x in flat]


def _spec_leaves(tree, port: bool) -> list:
    flat = leaves(tree) if port else jax.tree.leaves(tree)
    return [tuple(s.spec) for s in flat]


# ---------------------------------------------------------------------------
# every cell, abstractly
# ---------------------------------------------------------------------------

def test_mesh_records_match_jax_meshes():
    jm = jax.make_mesh((1, 1), ("data", "model"))
    tm = make_mesh((1, 1), ("data", "model"))
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.shape == dict(jm.shape) and tm.size == jm.size
    single, multi = (make_production_mesh(),
                     make_production_mesh(multi_pod=True))
    assert (single.shape, single.size) == ({"data": 16, "model": 16}, 256)
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.size == 512 and list(multi.shape) == list(multi.axis_names)
    with pytest.raises(ValueError, match="axis names"):
        Mesh(("data",), (1, 2))


@pytest.mark.parametrize("arch_id", list(J_ARCHS))
def test_cells_match_jax(arch_id):
    """Every shape of ``arch_id``, the §Perf variants included."""
    jmesh, tmesh = _meshes()
    jarch, tarch = J_ARCHS[arch_id], T_ARCHS[arch_id]
    assert list(tarch.shapes) == list(jarch.shapes)
    for shape in jarch.shapes:
        jc, tc = jarch.cell(shape, jmesh), tarch.cell(shape, tmesh)
        what = f"{arch_id} x {shape}"
        assert (tc.arch, tc.shape_name, tc.kind) == (
            jc.arch, jc.shape_name, jc.kind), what
        assert tc.skip == jc.skip, what
        if jc.skip:
            assert tc.fn is None and tc.args == ()
            continue
        assert tc.note == jc.note, what
        assert_allclose(tc.model_flops, jc.model_flops, rtol=1e-12,
                        err_msg=what)
        assert tc.model_flops > 0
        assert _arg_leaves(tc, True) == _arg_leaves(jc, False), what
        for side in ("in_shardings", "out_shardings"):
            assert (_spec_leaves(getattr(tc, side), True)
                    == _spec_leaves(getattr(jc, side), False)), (what, side)
        assert tuple(tc.donate) == tuple(jc.donate), what
        assert tc.n_scan == jc.n_scan, what


def test_cell_counts_match_jax():
    """35 runnable LM, GNN and recsys cells and the five full-attention
    ``long_500k`` skips, 40 in all (the §Perf variants, which carry a
    ``base`` key, left out), as ``tests/test_arch_configs.py`` counts."""
    _, tmesh = _meshes()
    runnable, skipped = 0, 0
    for arch_id in LM_ARCHS + GNN_ARCHS + ["xdeepfm"]:
        arch = T_ARCHS[arch_id]
        for shape_name, sh in arch.shapes.items():
            if "base" in sh:
                continue
            if arch.cell(shape_name, tmesh).skip:
                skipped += 1
            else:
                runnable += 1
    assert (runnable, skipped) == (35, 5)


class _StandIn:
    """What ``repro.models.transformer.cache_specs`` reads of a mesh."""

    def __init__(self, mesh: Mesh):
        self.axis_names = mesh.axis_names
        self.shape = mesh.shape


@pytest.mark.parametrize("multi_pod", [False, True])
def test_cache_and_param_specs_match_jax_on_production_meshes(multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    for arch_id in LM_ARCHS:
        jcfg, tcfg = J_ARCHS[arch_id].cfg, T_ARCHS[arch_id].cfg
        want = jt.cache_specs(jcfg, _StandIn(mesh))
        got = tcommon.named(mesh, tt.cache_specs(tcfg, mesh))
        assert {k: tuple(v) for k, v in want.items()} == {
            k: v.spec for k, v in got.items()}, arch_id
        want = jax.tree.leaves(jt.param_specs(jcfg),
                               is_leaf=lambda x: isinstance(x, P))
        assert [tuple(p) for p in want] == _specs_in_order(
            tt.param_specs(tcfg)), arch_id
    assert tt.cache_specs(T_ARCHS["stablelm-3b"].cfg, None)["k"] == (
        None, (), None, "model", None)


def _specs_in_order(specs) -> list:
    """The specs of a dict tree in JAX's (sorted-key) order; a spec is a
    tuple, which ``train.tree`` would walk into."""
    out = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        else:
            out.append(tuple(node))

    walk(specs)
    return out


def test_named_and_sds():
    mesh = make_mesh((1, 1), ("data", "model"))
    assert tcommon.named(None, ("model", None)) is None
    got = tcommon.named(mesh, {"a": (("data",), None), "b": [(), ("model",)],
                               "c": ((("data",),), ())})
    # entries normalized as PartitionSpec normalizes them
    assert got["a"] == tcommon.NamedSharding(mesh, ("data", None))
    assert [s.spec for s in got["b"]] == [(), ("model",)]
    assert [s.spec for s in got["c"]] == [("data",), ()]
    assert tcommon.named(mesh, ((), ("pod", "data"))).spec == (
        None, ("pod", "data"))
    with pytest.raises(TypeError, match="not a spec"):
        tcommon.named(mesh, {"a": 3})
    a = tcommon.sds(np.array([2, 3]), torch.bfloat16)
    assert a.shape == (2, 3) and a.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# reduced cells, run on the same inputs in both packages
# ---------------------------------------------------------------------------

LM_SHAPES = {"train_4k": dict(kind="train", seq=16, batch=4),
             "prefill_32k": dict(kind="prefill", seq=16, batch=2),
             "decode_32k": dict(kind="decode", seq=32, batch=2)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_close(got, want, what: str, **tol):
    paths, gl = flatten_with_paths(got)
    wl = jax.tree.leaves(want)
    assert len(gl) == len(wl), what
    for p, g, w in zip(paths, gl, wl):
        assert tuple(g.shape) == tuple(np.shape(w)), (what, p)
        assert_allclose(g.detach().float().numpy(),
                        np.asarray(w, np.float32), err_msg=f"{what} {p}",
                        **tol)


def _same_abstract(cell, args):
    """The reduced cell's abstract arguments are the inputs' shapes and
    dtypes."""
    got = [(tuple(t.shape), _dtype_name(t.dtype)) for t in leaves(args)]
    assert got == _arg_leaves(cell, True)


def _lm_cells(arch_id: str, shape: str):
    jarch, tarch = J_ARCHS[arch_id], T_ARCHS[arch_id]
    jcfg, tcfg = jarch.reduced_cfg(), tarch.reduced_cfg()
    _, tmesh = _meshes()
    j = jcommon.LMArch(arch_id, jcfg, microbatches=jarch.microbatches,
                       shapes=dict(LM_SHAPES))
    t = tcommon.LMArch(arch_id, tcfg, microbatches=tarch.microbatches,
                       shapes=dict(LM_SHAPES))
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tp = transformer_params_from_numpy(_np(jp), tcfg, device="cpu")
    # the JAX step constrains its activations' sharding, which a mesh of
    # Auto axes allows outside the dry run's ``with mesh``
    auto = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    return j.cell(shape, auto), t.cell(shape, tmesh), jp, tp, tcfg


@pytest.mark.parametrize("arch_id", ["stablelm-3b", "moonshot-v1-16b-a3b"])
def test_lm_train_cell_runs_as_jax(arch_id):
    jc, tc, jp, tp, _ = _lm_cells(arch_id, "train_4k")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (4, 16), dtype=np.int32)
    batch = {"tokens": toks, "labels": (toks * 3 + 7) % 512}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    ts = topt.init_opt_state(tp)
    _same_abstract(tc, (tp, ts, tbatch))
    jp2, js2, jm = jax.jit(jc.fn)(jp, jopt.init_opt_state(jp), batch)
    tp2, ts2, tm = tc.fn(tp, ts, tbatch)
    for k in ("loss", "grad_norm"):
        assert_allclose(float(tm[k]), float(jm[k]), **LM_TOL, err_msg=k)
    assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    _assert_tree_close(tp2, jp2, "params", atol=3 * float(jm["lr"]), rtol=0)
    _assert_tree_close(ts2["m"], js2["m"], "m", **LM_TOL)


@pytest.mark.parametrize("arch_id", ["stablelm-3b", "moonshot-v1-16b-a3b"])
def test_lm_prefill_and_decode_cells_run_as_jax(arch_id):
    jc, tc, jp, tp, tcfg = _lm_cells(arch_id, "prefill_32k")
    toks = np.random.default_rng(1).integers(0, 512, (2, 16),
                                             dtype=np.int32)
    _same_abstract(tc, (tp, torch.from_numpy(toks)))
    jcache, jlog = jax.jit(jc.fn)(jp, toks)
    tcache, tlog = tc.fn(tp, torch.from_numpy(toks))
    assert_allclose(tlog.numpy(), np.asarray(jlog), **LM_TOL)
    for k in ("k", "v"):
        assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]), **LM_TOL)
    assert int(tcache["len"]) == int(jcache["len"]) == 16

    jc, tc, _, _, _ = _lm_cells(arch_id, "decode_32k")
    rng = np.random.default_rng(2)
    shape = (tcfg.n_layers, 2, tcfg.n_kv_heads, 32, tcfg.head_dim)
    kv = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    step = rng.integers(0, 512, (2, 1), dtype=np.int32)
    # a 0-d length, as the cell's abstract argument has it
    tcache = {"k": torch.from_numpy(kv[0].copy()),
              "v": torch.from_numpy(kv[1].copy()),
              "len": torch.tensor(20, dtype=torch.int32)}
    _same_abstract(tc, (tp, tcache, torch.from_numpy(step)))
    jlog, jcache = jax.jit(jc.fn)(
        jp, {"k": kv[0], "v": kv[1], "len": jnp.int32(20)}, step)
    tlog, tcache = tc.fn(tp, tcache, torch.from_numpy(step))
    assert_allclose(tlog.numpy(), np.asarray(jlog), **LM_TOL)
    for k in ("k", "v"):
        assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]), **LM_TOL)
    assert int(tcache["len"]) == int(jcache["len"]) == 21


@pytest.mark.parametrize("length", [-3, 0, 20, 40])
def test_decode_step_takes_an_int_or_a_0d_length_as_jax(length):
    """``decode_step`` with the cache length as a Python int (serving)
    and as a 0-d tensor (the decode cell) gives JAX's logits and cache,
    the write slot clamped into a cache of 32 (-3 wraps to 29, 40 clamps
    to 31)."""
    _, _, jp, tp, tcfg = _lm_cells("stablelm-3b", "decode_32k")
    jcfg = J_ARCHS["stablelm-3b"].reduced_cfg()
    rng = np.random.default_rng(3)
    shape = (tcfg.n_layers, 2, tcfg.n_kv_heads, 32, tcfg.head_dim)
    kv = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    step = rng.integers(0, 512, (2, 1), dtype=np.int32)
    jlog, jcache = jt.decode_step(
        jp, {"k": kv[0], "v": kv[1], "len": jnp.int32(length)}, step, jcfg)
    for n in (length, torch.tensor(length, dtype=torch.int32)):
        cache = {"k": torch.from_numpy(kv[0].copy()),
                 "v": torch.from_numpy(kv[1].copy()), "len": n}
        tlog, tcache = tt.decode_step(tp, cache, torch.from_numpy(step),
                                      tcfg)
        assert_allclose(tlog.numpy(), np.asarray(jlog), **LM_TOL)
        for k in ("k", "v"):
            assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]),
                            **LM_TOL)
        assert int(tcache["len"]) == int(jcache["len"]) == length + 1


def test_gnn_train_cell_runs_as_jax():
    """GatedGCN (16 layers, width 70) on 64 nodes, 256 directed edges
    padded to 512 as ``_batch_abs`` pads them."""
    shapes = {"full_graph_sm": dict(kind="train", n_nodes=64, n_edges=128,
                                    d_feat=16)}
    jarch = dataclasses.replace(J_ARCHS["gatedgcn"], shapes=shapes)
    tarch = dataclasses.replace(T_ARCHS["gatedgcn"], shapes=shapes)
    jmesh, tmesh = _meshes()
    jc, tc = (jarch.cell("full_graph_sm", jmesh),
              tarch.cell("full_graph_sm", tmesh))
    rng = np.random.default_rng(3)
    batch = {"src": rng.integers(0, 64, 512).astype(np.int32),
             "dst": rng.integers(0, 64, 512).astype(np.int32),
             "node_feat": rng.standard_normal((64, 16)).astype(np.float32),
             "labels": rng.integers(0, 16, 64).astype(np.int32)}
    jp = jgcn.init_gatedgcn(jax.random.PRNGKey(0), jarch.make_cfg(16, 16))
    tp = gnn_params_from_numpy(_np(jp), device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    ts = topt.init_opt_state(tp)
    _same_abstract(tc, (tp, ts, tbatch))
    jp2, _, jm = jax.jit(jc.fn)(jp, jopt.init_opt_state(jp), batch)
    tp2, _, tm = tc.fn(tp, ts, tbatch)
    assert_allclose(float(tm["loss"]), float(jm["loss"]), **GNN_TOL)
    assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                    rtol=GRAD_TOL)
    _assert_tree_close(tp2, jp2, "params", atol=3 * float(jm["lr"]), rtol=0)


def test_recsys_train_cell_runs_as_jax():
    """xDeepFM's reduced config on 64 rows."""
    shapes = {"train_batch": dict(kind="train", batch=64)}
    jarch, tarch = J_ARCHS["xdeepfm"], T_ARCHS["xdeepfm"]
    j = dataclasses.replace(jarch, cfg=jarch.reduced_cfg(), shapes=shapes)
    t = dataclasses.replace(tarch, cfg=tarch.reduced_cfg(), shapes=shapes)
    jmesh, tmesh = _meshes()
    jc, tc = j.cell("train_batch", jmesh), t.cell("train_batch", tmesh)
    rng = np.random.default_rng(4)
    batch = {"ids": rng.integers(0, 1000, (64, 39)).astype(np.int32),
             "labels": (rng.random(64) < 0.25).astype(np.int32)}
    jp = jxdf.init_xdeepfm(jax.random.PRNGKey(3), j.cfg)
    tp = xdeepfm_params_from_numpy(_np(jp), device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    ts = topt.init_opt_state(tp)
    _same_abstract(tc, (tp, ts, tbatch))
    jp2, _, jm = jax.jit(jc.fn)(jp, jopt.init_opt_state(jp), batch)
    tp2, _, tm = tc.fn(tp, ts, tbatch)
    for k in ("loss", "grad_norm"):
        assert abs(float(tm[k]) - float(jm[k])) <= GRAD_TOL * abs(
            float(jm[k])), k
    _assert_tree_close(tp2, jp2, "params", atol=3 * float(jm["lr"]), rtol=0)


WCOJ_SHAPES = {
    "join": dict(kind="join", frontier=1024, width=64, n_bound=2,
                 n_probe=1),
    "tile_bucketed": dict(kind="join", frontier=1024, width=64, n_bound=3,
                          n_probe=2, variant="tile_bucketed",
                          tile_frac=0.9375, check_width=64),
    "rotate2l": dict(kind="join", frontier=1024, width=64, n_bound=3,
                     n_probe=2, variant="rotate2l", stride=8),
    "spmv": dict(kind="spmv"),
}


@pytest.mark.parametrize("shape", list(WCOJ_SHAPES))
def test_wcoj_cells_count_as_jax(shape):
    """The level step and the segment sum on ``powerlaw_cluster(300, 4)``
    (random frontier rows and multiplicities; the spmv's source ids reach
    past both ends, where the segment sum drops them), exactly."""
    g = powerlaw_cluster(300, 4, seed=0)
    n, m = g.n_nodes, g.indices.shape[0]
    sh = {shape: dict(WCOJ_SHAPES[shape], n_nodes=n, n_edges=m)}
    jmesh, tmesh = _meshes()
    jc = JWCOJArch(shapes=sh).cell(shape, jmesh)
    tc = TWCOJArch(shapes=sh).cell(shape, tmesh)
    rng = np.random.default_rng(5)
    if shape == "spmv":
        e = -(-m // 512) * 512
        args = (rng.integers(0, n, e).astype(np.int32),
                rng.integers(-3, n + 3, e).astype(np.int32),
                rng.integers(0, 1000, n).astype(np.int64))
    else:
        sh = sh[shape]
        args = (g.indptr.astype(np.int32), g.indices.astype(np.int32),
                rng.integers(0, n, (1024, sh["n_bound"])).astype(np.int32),
                rng.integers(1, 5, 1024).astype(np.int64))
        if shape == "rotate2l":
            args += (g.indices[::8][:m // 8].astype(np.int32),)
    targs = tuple(torch.from_numpy(a) for a in args)
    _same_abstract(tc, targs)
    want = np.asarray(jc.fn(*(jnp.asarray(a) for a in args)))
    got = tc.fn(*targs)
    assert got.dtype == torch.int64
    assert_array_equal(got.numpy(), want)
    if shape != "spmv":
        assert int(got) > 0
