"""The per-chip programs on the production meshes against the JAX package.

(1) Every runnable cell of the 11 architectures on the 16×16 and 2×16×16
meshes: each argument's local shard shape and dtype in the port
(``NamedSharding.shard_shape``) equal JAX's ``shard_shape`` of the same
cell built on an ``AbstractMesh``; kind, skip reason and model FLOPs
equal.  (2) A hand-computed case: a column-parallel and a row-parallel
product of one chip's (16, 4096) bf16 rows on 16×16 cost exactly
180,355,072 bf16 FLOPs and one 131,072-byte all-reduce.  (3) Against
XLA, in a subprocess with 8 host devices: the per-chip argument bytes of
a reduced dense-LM train cell and the reduced xDeepFM train cell on a
(2, 4) mesh equal ``memory_analysis().argument_size_in_bytes``; the
collective bytes of both are printed beside each other.  (4) On a real
2×2 mesh of four spawned gloo processes (a ``file://`` store under
``tmp_path``): the reduced dense LM's and an MoE LM's loss (rtol 1e-5)
and gradients (within 1e-5 of the largest), xDeepFM's loss and
gradients alike, and one WCOJ join step's count (exactly) equal the same
functions run unsharded (the MoE aux loss as the mesh defines it, the
mean of the data shards' aux losses, each shard's run unsharded); so do
those of the card's attention route (the flash custom ops under their
sharding rules, the kernels' plain versions standing in).  (5)
``mesh=None`` leaves the LM's values unchanged.  (6) The card's
float32-result product and the search and tile-mask custom ops run on
DTensors under their sharding rules (fake tensors: the CPU has no such
kernels).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro  # noqa: F401  (x64, as the JAX package's own tests run)
from repro.configs import ARCHS as J_ARCHS

from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs.common import Cell, named, sds
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (make_mesh, make_production_mesh,
                                     release_fake_world)
from repro_torch.models import transformer as tt
from repro_torch.train.tree import leaves

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
#: each spawned rank's time limit
RANK_TIMEOUT_S = 240.0
#: the forced-device subprocess' time limit
XLA_TIMEOUT_S = 240.0
#: (3): the most the port's per-chip FLOPs may be over XLA's (on the
#: reduced LM cell 0.89 with each chip projecting its own KV heads, 1.27
#: with every chip projecting all of them; xDeepFM 0.29: XLA repeats a
#: data shard's whole CIN on each of the model axis' 4 chips)
XLA_FLOPS_MAX = 1.1


@pytest.fixture(scope="module", autouse=True)
def _no_group_left():
    """The fake process group the per-chip programs make is gone after
    the module, so later tests may make groups of their own."""
    yield
    release_fake_world()


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


# ---------------------------------------------------------------------------
# (1) per-chip shapes of every cell
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch_id", list(J_ARCHS))
def test_local_shapes_match_jax(arch_id, multi):
    jmesh = (AbstractMesh((2, 16, 16), ("pod", "data", "model")) if multi
             else AbstractMesh((16, 16), ("data", "model")))
    tmesh = make_production_mesh(multi_pod=multi)
    jarch, tarch = J_ARCHS[arch_id], T_ARCHS[arch_id]
    runnable = 0
    for shape in jarch.shapes:
        jc, tc = jarch.cell(shape, jmesh), tarch.cell(shape, tmesh)
        what = f"{arch_id} x {shape}"
        assert (tc.kind, tc.skip) == (jc.kind, jc.skip), what
        if jc.skip:
            continue
        runnable += 1
        assert tc.model_flops == pytest.approx(jc.model_flops, rel=1e-12)
        jargs, jsh = jax.tree.leaves(jc.args), jax.tree.leaves(
            jc.in_shardings)
        targs, tsh = leaves(tc.args), leaves(tc.in_shardings)
        assert len(jargs) == len(jsh) == len(targs) == len(tsh), what
        for ja, js, ta, ts in zip(jargs, jsh, targs, tsh):
            assert ts.shard_shape(ta.shape) == tuple(
                js.shard_shape(ja.shape)), (what, ta.shape, ts.spec)
            assert _dtype_name(ta.dtype) == _dtype_name(ja.dtype), what
    assert runnable > 0


def test_shard_shape_refuses_what_does_not_divide():
    sh = named(make_production_mesh(), ("model", None))
    assert sh.shard_shape((32, 5)) == (2, 5)
    with pytest.raises(ValueError, match="divide"):
        sh.shard_shape((24, 5))


# ---------------------------------------------------------------------------
# (2) the hand-computed case
# ---------------------------------------------------------------------------

def test_two_products_cost_what_one_chip_does():
    """(16, 4096) bf16 per chip (256 rows over data) times a (4096, 11008)
    column-parallel weight times an (11008, 4096) row-parallel one, laid
    out rows-over-data and whole over model: 2 * 16 * 4096 * 688 FLOPs
    twice, and the row-parallel partial sum reduced by one all-reduce of
    16 * 4096 bf16."""
    mesh = make_production_mesh()
    cell = Cell("hand", "two products", "forward",
                lambda x, w1, w2: (x @ w1) @ w2,
                (sds((256, 4096), torch.bfloat16),
                 sds((4096, 11008), torch.bfloat16),
                 sds((11008, 4096), torch.bfloat16)),
                in_shardings=named(mesh, (("data", None), (None, "model"),
                                          ("model", None))),
                out_shardings=named(mesh, ("data", None)))
    rec = dryrun.measure(cell, mesh)
    assert rec["cost"]["flops_by_dtype"]["bf16"] == 180_355_072
    assert 2 * 2 * 16 * 4096 * 688 == 180_355_072
    assert rec["coll"]["n_all-reduce"] == 1
    assert rec["coll"]["all-reduce"] == 16 * 4096 * 2 == 131_072
    assert all(rec["coll"][f"n_{k}"] == 0 for k in
               ("all-gather", "reduce-scatter", "all-to-all"))
    assert rec["memory"]["argument_bytes"] == 2 * (16 * 4096 + 4096 * 688
                                                   + 688 * 4096)
    assert rec["roofline"]["chips"] == 256


def test_wide_product_runs_on_dtensors():
    """``layers.common._WideProduct`` (the card's bf16 product with a
    float32 result, ``aten.mm.dtype``/``bmm.dtype``) on DTensors, forward
    and backward, under the rules ``layers.sharding`` registers (fake
    tensors: the CPU has no ``mm.dtype`` kernel)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.configs.common import place
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.layers.common import _WideProduct
    mesh = make_mesh((2, 2), ("data", "model"))
    dm = device_mesh(mesh, "cpu")
    fake = FakeTensorMode()
    for a_spec, b_spec, a_shape, b_shape, want in (
            (("data", None), (None, "model"), (8, 6), (6, 4),
             (Shard(0), Shard(1))),
            ((None, "model"), ("model", None), (8, 6), (6, 4),
             (Replicate(), Partial())),
            (("data", None, None), ("data", None, "model"), (4, 8, 6),
             (4, 6, 10), (Shard(0), Shard(2)))):
        sh = named(mesh, (a_spec, b_spec))
        with fake:
            a, b = (place(torch.empty(s.shard_shape(shape),
                                      dtype=torch.bfloat16), s, dm, shape)
                    .requires_grad_()
                    for s, shape in zip(sh, (a_shape, b_shape)))
            out = _WideProduct.apply(a, b)
            assert out.dtype == torch.float32 and tuple(out.placements) == \
                want
            ga, gb = torch.autograd.grad(out.sum(), (a, b))
            assert ga.dtype == gb.dtype == torch.bfloat16
            assert (ga.shape, gb.shape) == (a.shape, b.shape)


def test_kernel_ops_run_on_each_chips_rows():
    """The search and tile-mask custom ops on DTensors (fake tensors: no
    card): the values whole, the rows split, the results split as the
    rows; values that arrive split are gathered whole first."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.configs.common import place
    from repro_torch.kernels import custom
    from repro_torch.launch.mesh import device_mesh
    mesh = make_mesh((2, 2), ("data", "model"))
    dm = device_mesh(mesh, "cpu")
    rows = named(mesh, ("data", None))
    fake = FakeTensorMode()

    def lay(shape, sh, dtype=torch.int32):
        local = shape if sh is None else sh.shard_shape(shape)
        with fake:
            return place(torch.empty(local, dtype=dtype), sh, dm, shape)

    values = lay((64,), named(mesh, ("model",)))
    summary = lay((4,), None)
    lo, hi = lay((16, 1), rows), lay((16, 1), rows)
    cand = lay((16, 8), rows)
    with fake:
        for out in (custom.searchsorted_segments(values, lo, hi, cand, 7),
                    custom.searchsorted_segments_2level(
                        values, summary, lo, hi, cand, 16, 3, 5),
                    (custom.tile_member_mask(values, lo, hi, cand, 8,
                                             None),),
                    (custom.tile_member_mask(
                        values, lo, hi, cand, 8, lay((16,), named(
                            mesh, ("data",)))),)):
            for t in out:
                assert tuple(t.placements) == (Shard(0), Replicate())
                assert tuple(t.shape) == (16, 8)


# ---------------------------------------------------------------------------
# (3) against XLA on 8 host devices
# ---------------------------------------------------------------------------

#: the reduced cells of (3): the dense LM at 8 x 32 tokens, xDeepFM at 64
#: rows, both on a (2, 4) data x model mesh.  The same process also runs
#: (4)'s JAX references: the reduced dense LM's, an MoE LM's and
#: xDeepFM's loss and gradients on a (2, 2) mesh of four of the devices,
#: from seeded parameters and batches, all pickled to ``sys.argv[1]`` for
#: the port's ranks
XLA_SCRIPT = """
import dataclasses, json, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import numpy as np
import repro
from jax.sharding import PartitionSpec as P
from repro.configs import ARCHS
from repro.configs.common import named
from repro.launch.roofline import collective_bytes
from repro.models import transformer as jt
from repro.models import xdeepfm as jx
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}
for name, cell in _cells(ARCHS, mesh).items():
    with mesh:
        comp = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                       out_shardings=cell.out_shardings).lower(
            *cell.args).compile()
    out[name] = {"argument_bytes":
                 comp.memory_analysis().argument_size_in_bytes,
                 "flops": comp.cost_analysis()["flops"],
                 "coll": collective_bytes(comp.as_text())}

mesh4 = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                          ("data", "model"))
rng = np.random.default_rng(0)


def reference(loss, params, specs, batch, bspecs):
    f = jax.jit(jax.value_and_grad(loss),
                in_shardings=(named(mesh4, specs), named(mesh4, bspecs)))
    with mesh4:
        value, grads = f(params, batch)
    return {"params": jax.tree.map(np.asarray, params), "batch": batch,
            "loss": float(value),
            "grads": [np.asarray(g) for g in jax.tree.leaves(grads)]}


refs = {}
for arch_id in ("stablelm-3b", "granite-moe-3b-a800m"):
    cfg = ARCHS[arch_id].reduced_cfg()
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    toks = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    refs[arch_id] = reference(
        lambda p, b, cfg=cfg: jt.loss_fn(p, b, cfg, mesh4),
        jt.init_params(jax.random.PRNGKey(0), cfg), jt.param_specs(cfg),
        {"tokens": toks, "labels": np.roll(toks, 1, 1)},
        {"tokens": P("data", None), "labels": P("data", None)})
xcfg = ARCHS["xdeepfm"].reduced_cfg()
xp = jx.init_xdeepfm(jax.random.PRNGKey(0), xcfg)
xspecs = jax.tree.map(lambda _: P(), xp)
xspecs["embed"] = xspecs["linear"] = P("model", None)
refs["xdeepfm"] = reference(
    lambda p, b: jx.xdeepfm_loss(p, b, xcfg), xp, xspecs,
    {"ids": rng.integers(0, xcfg.vocab_per_field,
                         (8, xcfg.n_sparse)).astype(np.int32),
     "labels": rng.integers(0, 2, (8,)).astype(np.int32)},
    {"ids": P("data", None), "labels": P("data")})
with open(sys.argv[1], "wb") as f:
    pickle.dump(refs, f)
print("RESULT " + json.dumps(out))
"""

CELLS_SRC = """
def _cells(ARCHS, mesh):
    lm = ARCHS["stablelm-3b"]
    lm = dataclasses.replace(lm, cfg=lm.reduced_cfg(), opt_variants={},
                             shapes={"train_4k": dict(kind="train", seq=32,
                                                      batch=8)})
    xdf = ARCHS["xdeepfm"]
    xdf = dataclasses.replace(xdf, cfg=xdf.reduced_cfg(), shapes={
        "train_batch": dict(kind="train", batch=64)})
    return {"lm train": lm.cell("train_4k", mesh),
            "xdeepfm train": xdf.cell("train_batch", mesh)}
"""


def _cells(archs, mesh):
    scope = {"dataclasses": dataclasses}
    exec(CELLS_SRC, scope)
    return scope["_cells"](archs, mesh)


@pytest.fixture(scope="module")
def xla(tmp_path_factory):
    """XLA_SCRIPT's per-chip numbers of (3), and the path of (4)'s pickled
    JAX references."""
    refs = tmp_path_factory.mktemp("xla") / "jax_refs.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    script = textwrap.dedent(CELLS_SRC) + textwrap.dedent(XLA_SCRIPT)
    got = subprocess.run([sys.executable, "-c", script, str(refs)], env=env,
                         capture_output=True, text=True,
                         timeout=XLA_TIMEOUT_S)
    assert got.returncode == 0, got.stderr[-4000:]
    line = [ln for ln in got.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):]), refs


def test_argument_bytes_match_xla(xla, capsys):
    """Per-chip argument bytes equal XLA's.  Per-chip FLOPs are the port's
    unfused count, which XLA's ``cost_analysis`` does not equal (it fuses
    and counts elementwise work its own way): they may be at most
    ``XLA_FLOPS_MAX`` times XLA's, which a program that repeats a
    model-parallel product's work on every chip of the model axis (4
    here) exceeds."""
    xla, _ = xla
    mesh = make_mesh((2, 4), ("data", "model"))
    for name, cell in _cells(T_ARCHS, mesh).items():
        rec = dryrun.measure(cell, mesh)
        assert rec["memory"]["argument_bytes"] == xla[name][
            "argument_bytes"], name
        flops = sum(rec["cost"]["flops_by_dtype"].values())
        assert flops <= XLA_FLOPS_MAX * xla[name]["flops"], (
            name, flops, xla[name]["flops"])
        with capsys.disabled():
            print(f"\n{name} (2, 4): per-chip FLOPs XLA "
                  f"{xla[name]['flops']:.6g} port {flops:.6g}; collective "
                  f"bytes per kind, XLA {xla[name]['coll']} port "
                  f"{rec['coll']}")


# ---------------------------------------------------------------------------
# (4) a real 2 x 2 mesh over four gloo processes
# ---------------------------------------------------------------------------

RANK_SCRIPT = """
import dataclasses, json, pickle, sys
from datetime import timedelta
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
with open(sys.argv[4], "rb") as f:
    jax_refs = pickle.load(f)
dist.init_process_group("gloo", init_method="file://" + tmp + "/store",
                        rank=rank, world_size=world,
                        timeout=timedelta(seconds=60))
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import distribute_tensor
from repro_torch.configs import ARCHS
from repro_torch.convert import (transformer_params_from_numpy,
                                 xdeepfm_params_from_numpy)
from repro_torch.core.vlftj import _expand_level
from repro_torch.graphs import powerlaw_cluster
from repro_torch.launch.mesh import make_mesh
from repro_torch.layers.sharding import on_mesh, placements
from repro_torch.models import transformer as tt
from repro_torch.models import xdeepfm as xdf
from repro_torch.train.loop import value_and_grad
from repro_torch.train.tree import leaves, tree_map

dm = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                mesh_dim_names=("data", "model"))
record = make_mesh((2, 2), ("data", "model"))


def spread(tree, specs):
    # every rank holds the whole tensor; each keeps its own shard
    if isinstance(tree, dict):
        return {k: spread(v, specs[k] if isinstance(specs, dict)
                          else specs) for k, v in tree.items()}
    if isinstance(tree, list):
        return [spread(v, s) for v, s in zip(tree, specs)]
    return distribute_tensor(tree, dm, placements(dm, specs),
                             src_data_rank=None)


def grad_err(grads, wgrads):
    top = max(float(w.abs().max()) for w in wgrads)
    return max(float((g - w).abs().max()) for g, w in zip(grads, wgrads)), top


def compare(name, loss_fn, params, specs, batch, bspecs, ref=None,
            jax_ref=None):
    # the mesh path against the same function unsharded, and against the
    # JAX package's mesh path on the same parameters and batch
    ref = ref or (lambda p, b: loss_fn(p, b, None))
    want, wgrads = value_and_grad(ref, params, batch)
    sp, sb = spread(params, specs), spread(batch, bspecs)
    with on_mesh(sp, sb):
        got, grads = value_and_grad(lambda p, b: loss_fn(p, b, dm), sp, sb)
        got = float(got.full_tensor())
        grads = [g.full_tensor() for g in grads]
    err, top = grad_err(grads, wgrads)
    out = {"loss": got, "want": float(want), "grad_err": err,
           "grad_max": top}
    if jax_ref is not None:
        jerr, jtop = grad_err(grads, [torch.from_numpy(g)
                                      for g in jax_ref["grads"]])
        out["jax"] = {"loss": got, "want": jax_ref["loss"],
                      "grad_err": jerr, "grad_max": jtop}
    return out


def jax_batch(ref):
    return {k: torch.from_numpy(v.astype(np.int64))
            for k, v in ref["batch"].items()}


def moe_ref(p, b, cfg):
    # the mesh path's aux loss is the mean of the data shards' (the JAX
    # package's pmean over data): the unsharded aux of each shard, averaged
    x, _ = tt.forward(p, b["tokens"], cfg)
    ce = tt._cross_entropy(tt._lm_logits(x, p, cfg), b["labels"], cfg, None)
    aux = torch.stack([tt.forward(p, t, cfg)[1]
                       for t in b["tokens"].chunk(2)]).mean()
    return (ce.mean() + 0.01 * aux).float()


out = {}
gen = torch.Generator().manual_seed(0)
for arch_id in ("stablelm-3b", "granite-moe-3b-a800m"):
    cfg = ARCHS[arch_id].reduced_cfg()
    ref = None
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
        ref = lambda p, b, cfg=cfg: moe_ref(p, b, cfg)
    jref = jax_refs[arch_id]
    params = transformer_params_from_numpy(jref["params"], cfg,
                                           device="cpu")
    out[arch_id] = compare(
        arch_id, lambda p, b, m: tt.loss_fn(p, b, cfg, mesh=m), params,
        tt.param_specs(cfg), jax_batch(jref),
        {"tokens": ("data", None), "labels": ("data", None)}, ref, jref)

xcfg = ARCHS["xdeepfm"].reduced_cfg()
jref = jax_refs["xdeepfm"]
xp = xdeepfm_params_from_numpy(jref["params"], device="cpu")
xspecs = tree_map(lambda _: (), xp)
xspecs["embed"] = xspecs["linear"] = ("model", None)
out["xdeepfm"] = compare(
    "xdeepfm", lambda p, b, m: xdf.xdeepfm_loss(p, b, xcfg), xp, xspecs,
    jax_batch(jref), {"ids": ("data", None), "labels": ("data",)},
    jax_ref=jref)

g = powerlaw_cluster(300, 5, seed=0)
indptr = torch.as_tensor(np.asarray(g.indptr), dtype=torch.int32)
indices = torch.as_tensor(np.asarray(g.indices), dtype=torch.int32)
pick = torch.randint(0, indices.shape[0], (64,), generator=gen)
src = torch.searchsorted(indptr[1:].long(), pick, right=True)
frontier = torch.stack([src.to(torch.int32), indices[pick]], dim=1)
mult = torch.ones(64, dtype=torch.int64)
cell = ARCHS["wcoj"].cell("triangle_frontier", record)
args = [spread(t, s.spec) for t, s in zip(
    (indptr, indices, frontier, mult), cell.in_shardings)]
with on_mesh(args):
    got = int(cell.fn(*args).full_tensor())
want = int(_expand_level(
    indptr, indices, (), frontier, mult, torch.ones(64, dtype=torch.bool),
    probe_cols=(0, 1), n_unary=0, lower_cols=(1,), upper_cols=(),
    width=512, n_iter=18, count_only=True, needs_degree=False).sum())
out["wcoj"] = {"count": got, "want": want}

# the card's attention route on the same mesh: FlashAttention over the
# kernels' custom ops, under their sharding rules, with the kernels'
# wrappers standing in as the plain versions (the CPU has no kernel)
from repro_torch.kernels import flash_attention as fa, ops as kops
from repro_torch.kernels import ref as kref


def fwd(q, k, v, causal=True, scale=None, return_lse=False):
    o = kref.flash_attention_ref(q, k, v, causal, scale)
    if return_lse:
        return o, kref.flash_attention_lse_ref(q, k, causal, scale)
    return o


def bwd(q, k, v, o, do, causal=True, scale=None, lse=None):
    assert lse is not None
    return kref.flash_attention_bwd_ref(q, k, v, o, do, causal, scale,
                                        lse=lse)


fa.flash_attention_cuda, fa.flash_attention_bwd_cuda = fwd, bwd
kops._flash_route = fa.route = lambda *a: "tc"
cfg = ARCHS["chatglm3-6b"].reduced_cfg()
params = tt.init_params(cfg, gen, device="cpu")
toks = torch.randint(0, cfg.vocab_size, (4, 16), generator=gen)
out["kernel route"] = compare(
    "kernel route", lambda p, b, m: tt.loss_fn(p, b, cfg, mesh=m), params,
    tt.param_specs(cfg), {"tokens": toks, "labels": toks},
    {"tokens": ("data", None), "labels": ("data", None)})
dist.barrier()
dist.destroy_process_group()
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory, xla):
    """RANK_SCRIPT's results from four spawned gloo ranks, given the JAX
    references of ``xla``; each joins within ``RANK_TIMEOUT_S`` or the
    test fails (no hang)."""
    tmp = tmp_path_factory.mktemp("mesh4")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(RANK_SCRIPT), str(r), "4",
         str(tmp), str(xla[1])], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(4)]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            assert p.returncode == 0, err[-4000:]
            line = [ln for ln in out.splitlines()
                    if ln.startswith("RESULT ")]
            assert line, out[-2000:] + err[-2000:]
            outs.append(json.loads(line[-1][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


@pytest.mark.parametrize("case", ["stablelm-3b", "granite-moe-3b-a800m",
                                  "xdeepfm", "kernel route"])
def test_mesh_loss_and_grads_match_one_process(ranks4, case):
    for r in ranks4:
        got = r[case]
        assert got["loss"] == pytest.approx(got["want"], rel=1e-5), got
        assert got["grad_err"] <= 1e-5 * got["grad_max"], got


@pytest.mark.parametrize("case", ["stablelm-3b", "granite-moe-3b-a800m",
                                  "xdeepfm"])
def test_mesh_loss_and_grads_match_jax(ranks4, case):
    """The port's mesh path against the JAX package's on a (2, 2) mesh of
    forced host devices, the same parameters and batch."""
    for r in ranks4:
        got = r[case]["jax"]
        assert got["loss"] == pytest.approx(got["want"], rel=1e-5), got
        assert got["grad_err"] <= 1e-5 * got["grad_max"], got


def test_mesh_join_count_is_exact(ranks4):
    for r in ranks4:
        assert r["wcoj"]["count"] == r["wcoj"]["want"] > 0, r["wcoj"]


# ---------------------------------------------------------------------------
# (5) no mesh, no change
# ---------------------------------------------------------------------------

def test_no_mesh_changes_nothing():
    """``mesh=None`` (one card's program) still gives the JAX package's
    no-mesh values on the same weights: the loss and the hidden states
    (tolerance as in ``test_torch_transformer.py``, which holds prefill
    and decode, whose ``mesh`` defaults to None, to the JAX package)."""
    from numpy.testing import assert_allclose
    from repro.models import transformer as jt
    jcfg = J_ARCHS["chatglm3-6b"].reduced_cfg()
    cfg = T_ARCHS["chatglm3-6b"].reduced_cfg()
    p = tt.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    jp = {k: jax.numpy.asarray(v.numpy()) for k, v in p.items()}
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    tol = dict(atol=2e-4, rtol=2e-4)
    jb = {"tokens": jax.numpy.asarray(toks), "labels": jax.numpy.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    assert_allclose(float(tt.loss_fn(p, tb, cfg, mesh=None)),
                    float(jax.jit(lambda p_, b_: jt.loss_fn(p_, b_, jcfg))(
                        jp, jb)), **tol)
    x, aux = tt.forward(p, tb["tokens"], cfg, mesh=None)
    jx, jaux = jax.jit(lambda p_, t_: jt.forward(p_, t_, jcfg))(
        jp, jb["tokens"])
    assert_allclose(x.numpy(), np.asarray(jx), **tol)
    assert float(aux) == float(jaux) == 0.0
