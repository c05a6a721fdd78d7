"""Sharded training state on a real mesh, against the JAX package.

(1) The fault: a tree of DTensor leaves (one gloo rank, a (1, 1) mesh)
saves as a plain tree of the same values does; before the repair its
save raised ``.numpy() is not supported for tensor subclasses``.  On
four spawned gloo ranks (a ``file://`` store under ``tmp_path``; each
joins within ``RANK_TIMEOUT_S`` or the test fails):
(2) a tree of float32, bf16 and int32 leaves laid out on a (2, 2) data
× model mesh saves to the manifest and leaf files (sha) of a
one-process save of the same values and of the JAX package's
``CheckpointManager.save`` of the same numpy arrays; an asynchronous
save is whole on every rank once ``wait()`` returns; (3) that
checkpoint restores with ``shardings=`` onto (2, 2), onto (4, 1) and
onto no mesh bit for bit, each rank holding its own shard; (4) the JAX
package's ``restore(..., shardings=)`` on a (2, 2) mesh of forced host
devices (a subprocess) reads the port's checkpoint to the same arrays;
(5) the JAX package's ``test_sharded_train_step_and_elastic_restore``
config (2 layers, d 64, heads 4/2, ff 128, vocab 256, float32) trained
two steps on (2, 2), saved, restored onto (4, 1) and trained two more
steps gives the JAX package's single-device ``make_train_step``
losses (rtol 1e-5) and parameters (within 1e-4 of the largest |param|)
from the same weights (``convert.py``); (6) a reduced xDeepFM
``Trainer`` on (2, 2) resumes from its own checkpoint, on the mesh and
on plain tensors, with the uninterrupted run's losses (rtol 1e-5).
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

import repro  # noqa: F401  (x64, as the JAX package's own tests run)
from repro.models import transformer as jt
from repro.train.checkpoint import CheckpointManager as JCkpt
from repro.train.loop import make_train_step as j_make_train_step
from repro.train.optimizer import OptimizerConfig as JOpt
from repro.train.optimizer import init_opt_state as j_init_opt_state

from repro_torch.configs.common import named
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.mesh import make_mesh
from repro_torch.layers import sharding as tsharding
from repro_torch.layers.sharding import placements
from repro_torch.train.checkpoint import CheckpointManager

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
#: each spawned rank's time limit
RANK_TIMEOUT_S = 240.0
#: the forced-device subprocess' time limit
XLA_TIMEOUT_S = 120.0
#: (5): steps before the save on (2, 2) and after the restore on (4, 1)
STEPS_BEFORE, STEPS_AFTER = 2, 2
#: (5)'s optimizer: a learning rate at which each step moves the weights
#: (the default's warmup would move them by 3e-6)
LM_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)

#: (2)-(4): the saved tree's values and, per mesh, each leaf's spec
DATA_SPECS = {
    "2x2": {"a": ("data", "model"), "b": (None, "model"),
            "c": {"d": (("data", "model"),)}},
    "4x1": {"a": ("data", None), "b": ("data", None),
            "c": {"d": ("data",)}},
}


def data_arrays() -> dict:
    """The saved tree as numpy arrays: float32, bf16 (``ml_dtypes``, as
    the JAX package holds it) and an int32 scalar (an optimizer step)."""
    rng = np.random.default_rng(0)
    return {"a": rng.standard_normal((8, 6)).astype(np.float32),
            "b": rng.standard_normal((4, 8)).astype(ml_dtypes.bfloat16),
            "c": {"d": rng.standard_normal(16).astype(np.float32)},
            "s": np.asarray(7, np.int32)}


def as_torch(tree):
    if isinstance(tree, dict):
        return {k: as_torch(v) for k, v in tree.items()}
    if tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(tree.copy())


def lm_cfg():
    return jt.TransformerConfig(name="t", n_layers=2, d_model=64, n_heads=4,
                                n_kv_heads=2, d_ff=128, vocab_size=256,
                                dtype=jnp.float32, remat=False)


def lm_batch(step: int) -> dict:
    toks = np.random.default_rng(step).integers(0, 256, (4, 16),
                                                dtype=np.int32)
    return {"tokens": toks, "labels": np.roll(toks, 1, 1)}


def files_of(d: Path) -> dict:
    """A checkpoint directory's manifest and each file's bytes."""
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


# ---------------------------------------------------------------------------
# (1) the fault, in this process
# ---------------------------------------------------------------------------

@pytest.fixture
def one_rank(tmp_path):
    """A gloo group of one rank (this process) and its (1, 1) mesh,
    destroyed after the test."""
    assert not dist.is_initialized(), "a process group is already open"
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def spread(tree, specs, dm):
    """``tree`` with each leaf that ``specs`` gives a spec laid out so on
    ``dm`` (every rank holds the whole tensor and keeps its own shard);
    the other leaves as they are."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, dict):
        return {k: spread(v, specs.get(k) if isinstance(specs, dict)
                          else specs, dm) for k, v in tree.items()}
    if isinstance(tree, list):
        return [spread(v, s, dm) for v, s in zip(tree, specs)]
    if specs is None:
        return tree
    return distribute_tensor(tree, dm, placements(dm, specs),
                             src_data_rank=None)


def test_dtensor_save_writes_the_plain_bytes(one_rank, tmp_path):
    vals = as_torch(data_arrays())
    tree = spread(vals, DATA_SPECS["2x2"], one_rank)
    CheckpointManager(str(tmp_path / "mesh")).save(1, tree, blocking=True)
    CheckpointManager(str(tmp_path / "plain")).save(1, vals, blocking=True)
    assert files_of(tmp_path / "mesh" / "step-00000001") == files_of(
        tmp_path / "plain" / "step-00000001")


def test_sharding_of_inverts_placements(one_rank):
    from torch.distributed.tensor import distribute_tensor
    for spec in [("data", "model"), (None, "model"), (("data", "model"),
                                                       None), (None, None)]:
        t = distribute_tensor(torch.zeros(4, 4), one_rank,
                              placements(one_rank, spec),
                              src_data_rank=None)
        assert tsharding.sharding_of(t).spec == spec
        assert tsharding.sharding_of(t).mesh is one_rank
    assert tsharding.sharding_of(torch.zeros(2)) is None


def test_restore_refuses_shardings_of_missing_leaves(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"w": torch.ones(2)}, blocking=True)
    sh = named(make_mesh((1, 1), ("data", "model")),
               {"w": (None,), "x": (None,)})
    with pytest.raises(ValueError, match="does not have"):
        cm.restore(1, {"w": torch.ones(2)}, shardings=sh)


def test_process_mesh_needs_a_real_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no real process group"):
        tmesh.process_mesh(make_mesh((1, 1), ("data", "model")), "cpu")


# ---------------------------------------------------------------------------
# (2)-(6) four gloo ranks
# ---------------------------------------------------------------------------

RANK_SCRIPT = """
import json, pickle, sys
from datetime import timedelta
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
with open(tmp + "/inputs.pkl", "rb") as f:
    inp = pickle.load(f)
dist.init_process_group("gloo", init_method="file://" + tmp + "/store",
                        rank=rank, world_size=world,
                        timeout=timedelta(seconds=60))
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
from repro_torch.configs import ARCHS
from repro_torch.configs.common import named
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.launch.mesh import make_mesh
from repro_torch.layers.sharding import mesh_of, placements, sharding_of
from repro_torch.models import transformer as tt
from repro_torch.models import xdeepfm as xdf
from repro_torch.train import (CheckpointManager, OptimizerConfig, Trainer,
                               init_opt_state, make_train_step)
from repro_torch.train.tree import leaves, tree_map

dm22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
rec41 = make_mesh((4, 1), ("data", "model"))


def spread(tree, specs, dm):
    # every rank holds the whole tensor; each keeps its own shard
    if isinstance(tree, dict):
        return {k: spread(v, specs.get(k) if isinstance(specs, dict)
                          else specs, dm) for k, v in tree.items()}
    if isinstance(tree, list):
        return [spread(v, s, dm) for v, s in zip(tree, specs)]
    if specs is None:
        return tree
    return distribute_tensor(tree, dm, placements(dm, specs),
                             src_data_rank=None)


def whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def same(tree, want):
    return all(a.dtype == b.dtype and torch.equal(whole(a), b)
               for a, b in zip(leaves(tree), leaves(want)))


out = {}
# (2) save on (2, 2), blocking and asynchronous
vals, specs = inp["data"], inp["data_specs"]
tree = spread(vals, specs["2x2"], dm22)
cm = CheckpointManager(tmp + "/port_mesh")
cm.save(1, tree, blocking=True)
cm.save(2, tree)
cm.wait()
out["async_whole"] = cm.steps() == [1, 2] and cm.latest_step() == 2

# (3) restore onto (2, 2), (4, 1) (a record: the process group's mesh) and
# no mesh
out["restore"] = {}
for name, shardings in (("2x2", named(dm22, specs["2x2"])),
                        ("4x1", named(rec41, specs["4x1"])),
                        ("none", None)):
    got = cm.restore(1, vals, shardings=shardings)
    if shardings is None:
        local = all(type(t) is torch.Tensor for t in leaves(got))
    else:
        local = type(got["s"]) is torch.Tensor and all(
            tuple(got[k].to_local().shape)
            == shardings[k].shard_shape(vals[k].shape) for k in ("a", "b"))
    out["restore"][name] = {"equal": same(got, vals), "local": local}

# (5) the LM: two steps on (2, 2), a save, a restore onto (4, 1), two more
cfg = tt.TransformerConfig(name="t", n_layers=2, d_model=64, n_heads=4,
                           n_kv_heads=2, d_ff=128, vocab_size=256,
                           dtype=torch.float32, remat=False)
pspecs = tt.param_specs(cfg)
bspecs = {"tokens": ("data", None), "labels": ("data", None)}
params = spread(transformer_params_from_numpy(inp["p0"], cfg, device="cpu"),
                pspecs, dm22)
opt = init_opt_state(params)
step = make_train_step(
    lambda p, b: tt.loss_fn(p, b, cfg, mesh=mesh_of(b["tokens"])),
    OptimizerConfig(**inp["opt"]))
losses = []
for s, batch in enumerate(inp["batches"]):
    if s == inp["steps_before"]:
        lm = CheckpointManager(tmp + "/lm")
        lm.save(s, {"params": params, "opt": opt}, blocking=True)
        psh = named(rec41, pspecs)
        state = lm.restore(s, {"params": params, "opt": opt},
                           shardings={"params": psh,
                                      "opt": {"m": psh, "v": psh}})
        params, opt = state["params"], state["opt"]
        out["lm_mesh_after"] = list(params["embed"].device_mesh.shape)
    dm = params["embed"].device_mesh
    b = spread({k: torch.from_numpy(v.astype(np.int64))
                for k, v in batch.items()}, bspecs, dm)
    params, opt, m = step(params, opt, b)
    losses.append(float(m["loss"].full_tensor()))
want = transformer_params_from_numpy(inp["p_final"], cfg, device="cpu")
top = max(float(w.abs().max()) for w in leaves(want))
err = max(float((whole(g) - w).abs().max())
          for g, w in zip(leaves(params), leaves(want)))
out["lm"] = {"losses": losses, "param_err": err, "param_max": top}

# (6) xDeepFM's Trainer on (2, 2): straight, checkpointed, resumed on the
# mesh and on plain tensors
xcfg = ARCHS["xdeepfm"].reduced_cfg()
xp0 = xdf.init_xdeepfm(xcfg, torch.Generator().manual_seed(0), device="cpu")
xspecs = tree_map(lambda _: (), xp0)
xspecs["embed"] = xspecs["linear"] = ("model", None)


def get_batch(s):
    rng = np.random.default_rng(100 + s)
    return {"ids": rng.integers(0, xcfg.vocab_per_field,
                                (8, xcfg.n_sparse)).astype(np.int32),
            "labels": rng.integers(0, 2, (8,)).astype(np.int32)}


def trainer(mesh, ckpt=None, every=2):
    p = tree_map(torch.clone, xp0)
    if mesh:
        p = spread(p, xspecs, dm22)
    return Trainer(lambda pp, bb: xdf.xdeepfm_loss(pp, bb, xcfg), p,
                   OptimizerConfig(lr=1e-2, warmup_steps=1,
                                   total_steps=10), get_batch,
                   ckpt_dir=ckpt, ckpt_every=every, device="cpu")


hs = trainer(True).run(4, log_every=1)
trainer(True, tmp + "/xdf").run(2, log_every=1)
lay = {k: sharding_of(v) for k, v in spread(xp0, xspecs, dm22).items()
       if k in ("embed", "linear")}
res = {}
for name, mesh in (("mesh", True), ("plain", False)):
    # resumes from checkpoint 2 and saves nothing more
    t = trainer(mesh, tmp + "/xdf", every=100)
    hr = t.run(2, log_every=1)
    kept = (all(sharding_of(t.params[k]) == lay[k] for k in lay) if mesh
            else all(type(v) is torch.Tensor for v in leaves(t.params)))
    res[name] = {"start": t.start_step, "steps": [h["step"] for h in hr],
                 "losses": [h["loss"] for h in hr], "layout_kept": kept}
out["xdf"] = {"straight": [h["loss"] for h in hs], "resumed": res}
dist.barrier()
dist.destroy_process_group()
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """This process' JAX references: the JAX package's save of
    ``data_arrays()`` and its single-device train steps from seeded
    weights; and the inputs the ranks read (``inputs.pkl``)."""
    tmp = tmp_path_factory.mktemp("elastic")
    JCkpt(str(tmp / "jax")).save(1, data_arrays(), blocking=True)
    cfg = lm_cfg()
    p = jt.init_params(jax.random.PRNGKey(0), cfg)
    p0 = jax.tree.map(np.asarray, p)
    step = jax.jit(j_make_train_step(lambda pp, b: jt.loss_fn(pp, b, cfg),
                                     JOpt(**LM_OPT)))
    opt = j_init_opt_state(p)
    batches, losses = [], []
    for s in range(STEPS_BEFORE + STEPS_AFTER):
        batch = lm_batch(s)
        batches.append(batch)
        p, opt, m = step(p, opt, batch)
        losses.append(float(m["loss"]))
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump({"data": as_torch(data_arrays()),
                     "data_specs": DATA_SPECS, "p0": p0,
                     "p_final": jax.tree.map(np.asarray, p),
                     "batches": batches, "steps_before": STEPS_BEFORE,
                     "opt": LM_OPT}, f)
    return tmp, losses


@pytest.fixture(scope="module")
def ranks4(jax_side):
    """RANK_SCRIPT's results from four spawned gloo ranks."""
    tmp = jax_side[0]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(RANK_SCRIPT), str(r), "4",
         str(tmp)], env=env, stdout=subprocess.PIPE,
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


JAX_RESTORE = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import numpy as np
import repro
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.train.checkpoint import CheckpointManager
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
sds = jax.ShapeDtypeStruct
like = {"a": sds((8, 6), np.float32), "c": {"d": sds((16,), np.float32)},
        "s": sds((), np.int32)}
shardings = {"a": NamedSharding(mesh, P("data", "model")),
             "c": {"d": NamedSharding(mesh, P(("data", "model")))},
             "s": NamedSharding(mesh, P())}
got = CheckpointManager(sys.argv[1]).restore(1, like, shardings=shardings)
np.savez(sys.argv[2], a=np.asarray(got["a"]), d=np.asarray(got["c"]["d"]),
         s=np.asarray(got["s"]))
print("RESULT " + json.dumps({
    "a": [list(s.data.shape) for s in got["a"].addressable_shards],
    "d": [list(s.data.shape) for s in got["c"]["d"].addressable_shards]}))
"""


def test_mesh_save_writes_the_one_process_and_jax_bytes(ranks4, jax_side,
                                                        tmp_path):
    tmp = jax_side[0]
    CheckpointManager(str(tmp_path)).save(1, as_torch(data_arrays()),
                                          blocking=True)
    got = files_of(tmp / "port_mesh" / "step-00000001")
    assert got == files_of(tmp_path / "step-00000001")
    assert got == files_of(tmp / "jax" / "step-00000001")
    manifest = json.loads(got["manifest.json"])
    assert [(l["path"], l["dtype"]) for l in manifest["leaves"]] == [
        ("a", "float32"), ("b", "bfloat16"), ("c/d", "float32"),
        ("s", "int32")]


def test_async_save_is_whole_on_every_rank(ranks4):
    assert all(r["async_whole"] for r in ranks4)


@pytest.mark.parametrize("mesh", ["2x2", "4x1", "none"])
def test_restore_is_bit_exact(ranks4, mesh):
    for r in ranks4:
        assert r["restore"][mesh] == {"equal": True, "local": True}, r


def test_jax_restore_reads_the_port_checkpoint(ranks4, jax_side, tmp_path):
    """The JAX package's ``restore(..., shardings=)`` on a (2, 2) mesh of
    forced host devices, of the float32 and int32 leaves (it cannot
    restore a bf16 one: ROADMAP, Queue 3 watch-list)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    got = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(JAX_RESTORE),
         str(jax_side[0] / "port_mesh"), str(tmp_path / "got.npz")],
        env=env, capture_output=True, text=True, timeout=XLA_TIMEOUT_S)
    assert got.returncode == 0, got.stderr[-4000:]
    line = [ln for ln in got.stdout.splitlines() if ln.startswith("RESULT ")]
    shards = json.loads(line[-1][len("RESULT "):])
    assert shards == {"a": [[4, 3]] * 4, "d": [[4]] * 4}
    arrays, want = np.load(tmp_path / "got.npz"), data_arrays()
    for key, w in (("a", want["a"]), ("d", want["c"]["d"]),
                   ("s", want["s"])):
        assert arrays[key].dtype == w.dtype
        np.testing.assert_array_equal(arrays[key], w)


def test_elastic_training_matches_jax_single_device(ranks4, jax_side):
    """Two steps on (2, 2), a save, a restore onto (4, 1), two more: the
    JAX package's single-device steps on the same weights and batches."""
    for r in ranks4:
        got = r["lm"]
        assert r["lm_mesh_after"] == [4, 1]
        np.testing.assert_allclose(got["losses"], jax_side[1], rtol=1e-5)
        assert got["param_err"] <= 1e-4 * got["param_max"], got


@pytest.mark.parametrize("case", ["mesh", "plain"])
def test_trainer_on_a_mesh_resumes(ranks4, case):
    """xDeepFM's ``Trainer`` on (2, 2) checkpoints step 2; a fresh one on
    the mesh (its layout kept) or on plain tensors resumes there and
    takes steps 3-4 with the uninterrupted run's losses."""
    for r in ranks4:
        x = r["xdf"]
        got = x["resumed"][case]
        assert got["start"] == 2 and got["steps"] == [3, 4], got
        assert got["layout_kept"], got
        assert np.isfinite(x["straight"]).all()
        np.testing.assert_allclose(got["losses"], x["straight"][2:],
                                   rtol=1e-5)
