"""The port's checkpoints and data pipelines against the JAX package's.

``repro_torch.train.checkpoint.CheckpointManager`` mirrors the five
checkpoint tests of ``tests/test_checkpoint_and_data.py`` and writes the
same bytes as the JAX package's manager for the same tree (every leaf
file and the manifest), bf16 leaves included.  The port restores a
checkpoint the JAX package wrote, bf16 bit for bit; the JAX package's own
``restore`` raises on such a leaf (``<V2`` cannot be cast to bfloat16),
which a test pins.  ``repro_torch.data`` gives the JAX package's batches
exactly.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (x64, as the JAX package's own tests run)
from repro.data import LMTokenPipeline as JLMPipe
from repro.data import RecSysPipeline as JRecPipe
from repro.data import lm_synthetic_batch as j_lm_batch
from repro.data import recsys_synthetic_batch as j_rec_batch
from repro.train.checkpoint import CheckpointManager as JCkpt

from repro_torch.data import (LMTokenPipeline, RecSysPipeline,
                              lm_synthetic_batch, recsys_synthetic_batch)
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.tree import leaves, tree_map


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(8, 8, generator=g),
            "nested": {"b": torch.arange(5, dtype=torch.int64),
                       "c": torch.tensor(3.5, dtype=torch.float32)}}


def _like(tree):
    return tree_map(torch.zeros_like, tree)


# -- the mirror of tests/test_checkpoint_and_data.py's checkpoint tests ------

def test_save_restore_roundtrip(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    t = _tree()
    cm.save(10, t, blocking=True)
    assert cm.latest_step() == 10
    r = cm.restore(10, _like(t))
    for a, b in zip(leaves(t), leaves(r)):
        assert torch.equal(a, b)


def test_async_save_and_gc(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    for s in [1, 2, 3, 4]:
        cm.save(s, _tree(s))
    cm.wait()
    assert cm.steps() == [3, 4]


def test_corruption_detected_and_skipped(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, _tree(1), blocking=True)
    cm.save(2, _tree(2), blocking=True)
    victim = os.path.join(str(tmp_path), "step-00000002", "leaf-00000.npy")
    with open(victim, "r+b") as f:
        f.seek(120)
        f.write(b"\xde\xad\xbe\xef")
    assert not cm.verify(2)
    assert cm.latest_step() == 1


def test_torn_write_invisible(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(5, _tree(), blocking=True)
    os.makedirs(os.path.join(str(tmp_path), ".tmp-9"), exist_ok=True)
    assert cm.steps() == [5]


def test_restore_across_dtypes_and_structs(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    t = _tree()
    cm.save(3, t, blocking=True)
    r = cm.restore(3, _like(t))
    assert r["nested"]["b"].dtype == t["nested"]["b"].dtype
    # the like tree's dtypes win, as jnp.asarray(arr, dtype=leaf.dtype)
    r = cm.restore(3, tree_map(lambda x: torch.zeros_like(
        x, dtype=torch.float64), t))
    assert r["a"].dtype == torch.float64
    assert torch.equal(r["a"], t["a"].double())


def test_save_snapshots_tensors_updated_in_place_later(tmp_path):
    """An async save writes the values of the call, not those of a later
    in-place update (the port's optimizer updates in place)."""
    cm = CheckpointManager(str(tmp_path))
    t = _tree()
    want = t["a"].clone()
    cm.save(1, t)
    t["a"].add_(1.0)
    cm.wait()
    assert torch.equal(cm.restore(1, _like(t))["a"], want)


# -- the same files as the JAX package ---------------------------------------

def _mixed_trees():
    rng = np.random.default_rng(0)
    arrs = {"w": rng.standard_normal((4, 6)).astype(np.float32),
            "e": rng.standard_normal((3, 5)).astype(np.float32),
            "i": np.arange(7, dtype=np.int64),
            "step": np.int32(9)}
    jt = {"params": {"w": jnp.asarray(arrs["w"]),
                     "emb": jnp.asarray(arrs["e"], jnp.bfloat16)},
          "opt": {"m": {"w": jnp.asarray(arrs["w"] * 2)},
                  "step": jnp.asarray(arrs["step"]),
                  "count": jnp.asarray(arrs["i"])}}
    tt = {"params": {"w": torch.from_numpy(arrs["w"]),
                     "emb": torch.from_numpy(arrs["e"]).to(torch.bfloat16)},
          "opt": {"m": {"w": torch.from_numpy(arrs["w"] * 2)},
                  "step": torch.tensor(9, dtype=torch.int32),
                  "count": torch.from_numpy(arrs["i"])}}
    return jt, tt


def test_port_and_jax_write_identical_files(tmp_path):
    """For the same tree (f32, bf16, int64 and an int32 scalar, nested,
    keys in other orders than sorted) both managers write byte-identical
    leaf files and manifests: the same paths, order, shapes, dtypes and
    hashes."""
    jt, tt = _mixed_trees()
    JCkpt(str(tmp_path / "jax")).save(4, jt, blocking=True)
    CheckpointManager(str(tmp_path / "port")).save(4, tt, blocking=True)
    jd, td = tmp_path / "jax" / "step-00000004", tmp_path / "port" / \
        "step-00000004"
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td))
    for name in os.listdir(jd):
        assert (jd / name).read_bytes() == (td / name).read_bytes(), name
    manifest = json.loads((td / "manifest.json").read_text())
    assert [l["path"] for l in manifest["leaves"]] == [
        "opt/count", "opt/m/w", "opt/step", "params/emb", "params/w"]
    assert manifest["leaves"][3]["dtype"] == "bfloat16"


def test_port_restores_a_jax_bf16_checkpoint_bit_exactly(tmp_path):
    jt, tt = _mixed_trees()
    JCkpt(str(tmp_path)).save(6, jt, blocking=True)
    cm = CheckpointManager(str(tmp_path))
    assert cm.latest_step() == 6
    r = cm.restore(6, tree_map(torch.zeros_like, tt))
    for a, b in zip(leaves(r), leaves(tt)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # and the JAX package restores what the port writes (f32 leaves)
    CheckpointManager(str(tmp_path / "p")).save(1, {"w": tt["params"]["w"]},
                                                 blocking=True)
    back = JCkpt(str(tmp_path / "p")).restore(1, {"w": jnp.zeros((4, 6))})
    np.testing.assert_array_equal(np.asarray(back["w"]),
                                  tt["params"]["w"].numpy())


def test_jax_restore_cannot_read_its_own_bf16_leaf(tmp_path):
    """The reference's fault the port repairs (ROADMAP, Queue 3
    watch-list): ``np.load`` gives the ``<V2`` bytes a ``|V2`` array, and
    ``astype("bfloat16")`` has no cast for it."""
    jt, _ = _mixed_trees()
    cm = JCkpt(str(tmp_path))
    cm.save(2, jt, blocking=True)
    with pytest.raises(ValueError, match="cast"):
        cm.restore(2, jax.tree.map(jnp.zeros_like, jt))


# -- the data pipelines ------------------------------------------------------

@pytest.mark.parametrize("step,shard,n_shards", [(0, 0, 1), (7, 1, 2),
                                                 (3, 3, 4)])
def test_synthetic_batches_equal_jax(step, shard, n_shards):
    a = lm_synthetic_batch(step, 8, 32, 1000, seed=3, shard=shard,
                           n_shards=n_shards)
    b = j_lm_batch(step, 8, 32, 1000, seed=3, shard=shard, n_shards=n_shards)
    for k in ("tokens", "labels"):
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])
    a = recsys_synthetic_batch(step, 16, 5, 100, seed=2, shard=shard,
                               n_shards=n_shards)
    b = j_rec_batch(step, 16, 5, 100, seed=2, shard=shard, n_shards=n_shards)
    for k in ("ids", "labels"):
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])
    a = RecSysPipeline(16, 5, 100, seed=1).get_batch(step, shard, n_shards)
    b = JRecPipe(16, 5, 100, seed=1).get_batch(step, shard, n_shards)
    np.testing.assert_array_equal(a["ids"], b["ids"])


def test_file_backed_batches_equal_jax(tmp_path):
    tokens = (np.arange(10_000, dtype=np.int64) * 7 % 997).astype(np.int32)
    f = tmp_path / "toks.bin"
    tokens.tofile(f)
    ours = LMTokenPipeline(4, 16, 1000, token_file=str(f))
    theirs = JLMPipe(4, 16, 1000, token_file=str(f))
    for step in (0, 1, 5, 300):
        for shard, n in ((0, 1), (1, 2), (3, 4)):
            a, b = ours.get_batch(step, shard, n), theirs.get_batch(step,
                                                                    shard, n)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(a[k], b[k])
    synth = LMTokenPipeline(4, 16, 1000, seed=5)
    np.testing.assert_array_equal(synth.get_batch(2)["tokens"],
                                  JLMPipe(4, 16, 1000, seed=5).get_batch(2)[
                                      "tokens"])
