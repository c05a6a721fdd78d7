"""Fault-tolerant checkpoints in the JAX package's on-disk format.

The port of ``repro.train.checkpoint``, byte for byte:

* a checkpoint is a logical tree: ``manifest.json`` (each leaf's path,
  file, shape, dtype and the first 16 hex digits of its file's sha256)
  and one ``leaf-%05d.npy`` per leaf, the leaves in JAX's order
  (:mod:`repro_torch.train.tree`), so the two packages write the same
  files for the same tree and each reads the other's;
* writes are atomic: the files land in ``<dir>/.tmp-<step>`` and one
  ``os.replace`` publishes ``step-%08d``, so a crashed writer leaves no
  half checkpoint;
* saves run on a background thread; ``wait()`` joins it, and the next
  save waits for it first;
* ``latest_step`` returns the newest checkpoint whose files match their
  hashes, so a restart skips torn or corrupted ones.

bf16 leaves are written as the JAX package writes them: ``np.save`` of
an ``ml_dtypes.bfloat16`` array stores the raw 2-byte values under the
``'<V2'`` descriptor, and the manifest says ``"bfloat16"``.  Here they
are read back as bf16.  That is a deliberate divergence: the JAX
package's ``restore`` calls ``astype("bfloat16")`` on the ``V2`` array,
which raises, so it cannot restore a bf16 leaf (ROADMAP, Queue 3
watch-list).

Sharded state, as the JAX package's checkpoints hold it (a logical
tree, restored onto any mesh):

* ``save`` gathers each DTensor leaf whole on every rank
  (``full_tensor``), as ``np.asarray`` gathers a sharded ``jax.Array``,
  so a sharded tree writes the bytes an unsharded one of the same
  values writes.  Only rank 0 of the default process group writes;
  ``wait()`` and a blocking ``save`` end in a barrier, so no rank reads
  a checkpoint before it is whole.  Without a process group nothing of
  this happens.
* ``restore(step, like, shardings=)`` takes a tree shaped like ``like``
  with a ``layers.sharding.NamedSharding`` (or None) at each leaf, as
  the JAX package's takes a pytree of ``NamedSharding``
  (``configs.common.named(mesh, param_specs(cfg))`` makes one): each
  rank reads the whole leaf and keeps its own shard, with no
  collective, so a checkpoint saved on one mesh restores onto any
  other, or onto no mesh (elastic restore).

Tensors are copied to the host when ``save`` is called, before it
returns: the optimizer updates them in place afterwards.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..launch.mesh import process_mesh
from ..layers.sharding import is_dtensor, placements
from .tree import flatten_with_paths, unflatten

#: the header descriptor ``np.save`` gives an ``ml_dtypes.bfloat16`` array
BF16_DESCR = "<V2"


def _host(leaf):
    """A host numpy copy of ``leaf`` and its manifest dtype name; a bf16
    tensor becomes its raw 2-byte values (int16)."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return np.ascontiguousarray(arr), str(arr.dtype)
    t = leaf.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _write_leaf(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        f.write(arr.tobytes())


def _read_leaf(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        raw = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(raw.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr.astype(dtype)))


def _writes() -> bool:
    """Whether this process writes checkpoint files: rank 0 of the
    default process group, or a process without one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    """Every rank of the default process group waits for the others;
    nothing without a group."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        # a save whose closing barrier is still to come (every rank)
        self._pending = False

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        paths, leaves = flatten_with_paths(tree)
        writer = _writes()
        host = []
        for leaf in leaves:
            # a collective: every rank gathers the same leaves in order
            if is_dtensor(leaf):
                leaf = leaf.detach().full_tensor()
            if writer:
                host.append(_host(leaf))

        def _write():
            tmp = os.path.join(self.dir, f".tmp-{step}")
            final = os.path.join(self.dir, f"step-{step:08d}")
            os.makedirs(tmp, exist_ok=True)
            manifest = {"step": step, "leaves": []}
            for i, (p, (arr, dtype)) in enumerate(zip(paths, host)):
                fname = f"leaf-{i:05d}.npy"
                _write_leaf(os.path.join(tmp, fname), arr, dtype)
                with open(os.path.join(tmp, fname), "rb") as f:
                    digest = hashlib.sha256(f.read()).hexdigest()[:16]
                manifest["leaves"].append(
                    {"path": p, "file": fname, "shape": list(arr.shape),
                     "dtype": dtype, "sha": digest})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()

        self.wait()
        if blocking:
            if writer:
                _write()
            _barrier()
        else:
            if writer:
                self._thread = threading.Thread(target=_write, daemon=True)
                self._thread.start()
            self._pending = True

    def wait(self) -> None:
        """Join the background write; with a process group, every rank
        then waits until it is published."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending:
            self._pending = False
            _barrier()

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step-{s:08d}"),
                          ignore_errors=True)

    # -- restore ---------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step-"):
                if os.path.exists(os.path.join(self.dir, name,
                                               "manifest.json")):
                    out.append(int(name.split("-")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        for s in reversed(self.steps()):
            if self.verify(s):
                return s
        return None

    def verify(self, step: int) -> bool:
        d = os.path.join(self.dir, f"step-{step:08d}")
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
            for leaf in manifest["leaves"]:
                with open(os.path.join(d, leaf["file"]), "rb") as f:
                    if hashlib.sha256(f.read()).hexdigest()[:16] != leaf["sha"]:
                        return False
            return True
        except (OSError, json.JSONDecodeError, KeyError):
            return False

    def restore(self, step: int, like: Any, shardings: Any = None,
                device=None) -> Any:
        """Rebuild a tree of ``like``'s structure from checkpoint
        ``step``.  A tensor leaf of ``like`` gives a tensor of its dtype:
        where ``shardings`` (a tree shaped like ``like``) holds a
        ``NamedSharding`` for it, a DTensor laid out so on the
        sharding's mesh (a ``DeviceMesh``, or a ``launch.mesh.Mesh``
        record made one over the process group by ``process_mesh``),
        each rank keeping its own shard of the whole leaf it reads;
        else a plain tensor on ``device`` (default: that leaf's device).
        Any other leaf gives the stored numpy array."""
        d = os.path.join(self.dir, f"step-{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        paths, leaves = flatten_with_paths(like)
        by_path = {l["path"]: l for l in manifest["leaves"]}
        where = _shardings_by_path(shardings, paths)
        meshes = {}
        out = []
        for p, leaf in zip(paths, leaves):
            info = by_path[p]
            t = _read_leaf(os.path.join(d, info["file"]), info["dtype"])
            if not isinstance(leaf, torch.Tensor):
                out.append(t.numpy())
                continue
            sh = where.get(p)
            if sh is None:
                out.append(t.to(device=leaf.device if device is None
                                else device, dtype=leaf.dtype))
                continue
            # this rank keeps its own shard of the whole leaf: nothing moves
            from torch.distributed.tensor import distribute_tensor
            dm = _device_mesh(sh.mesh, meshes, device or leaf.device)
            out.append(distribute_tensor(
                t.to(dtype=leaf.dtype), dm, placements(dm, sh.spec),
                src_data_rank=None))
        return unflatten(like, out)


def _shardings_by_path(shardings, paths) -> dict:
    """Path -> sharding of each leaf of a ``shardings`` tree (None
    leaves are empty subtrees, as in JAX); raises on a path that the
    restored tree does not have."""
    if shardings is None:
        return {}
    spaths, sleaves = flatten_with_paths(shardings)
    extra = sorted(set(spaths) - set(paths))
    if extra:
        raise ValueError(f"restore: shardings for leaves the tree does "
                         f"not have: {extra[:4]}")
    return dict(zip(spaths, sleaves))


def _device_mesh(mesh, made: dict, device):
    """The ``DeviceMesh`` a sharding names: itself, or a record placed
    over the process group on ``device``'s type (one per record)."""
    if hasattr(mesh, "mesh_dim_names"):
        return mesh
    if mesh not in made:
        made[mesh] = process_mesh(mesh, torch.device(device).type)
    return made[mesh]
