"""Meshes as records: the port of ``repro.launch.mesh``.

A :class:`Mesh` names its axes and their sizes, as a
``jax.sharding.Mesh`` does, and holds nothing else: no devices and no
process group.  The dry-run cells (``configs.common``) read it for their
sharding specs, the way the JAX cells read a mesh: ``axis_names`` for
the data axes and ``shape["model"]`` for the tensor-parallel width.
:func:`device_mesh` makes a record a ``DeviceMesh`` over a fake process
group, on which one process runs one chip's program of the whole mesh;
:func:`process_mesh` makes it one over the real process group this
process is a rank of (a checkpoint restores onto it).
"""
from __future__ import annotations

from dataclasses import dataclass
from math import prod


@dataclass(frozen=True)
class Mesh:
    """Axis names and sizes, in axis order."""

    axis_names: tuple
    sizes: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"mesh: {len(self.axis_names)} axis names for "
                             f"{len(self.sizes)} sizes")

    @property
    def shape(self) -> dict:
        """Axis name -> size, in axis order (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return prod(self.sizes)


def make_mesh(shape, axes) -> Mesh:
    """``jax.make_mesh(shape, axes)`` as a record."""
    return Mesh(tuple(axes), tuple(int(s) for s in shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single-pod (256 chips) or 2x16x16 two-pod (512 chips) mesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


#: world size -> DeviceMesh cache key of the fake group this module made
_FAKE = {"world": None, "meshes": {}}


def _fake_world(world: int) -> None:
    """Make this process rank 0 of a fake process group of ``world``
    ranks (``FakeStore``): collectives run through it and move nothing.
    Made once per world size; a fake group of another size is replaced,
    a group this module did not make is left alone and raises."""
    import torch.distributed as dist
    # registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if _FAKE["world"] is None:
            raise RuntimeError(
                "device_mesh: a process group is already initialized; the "
                "per-chip programs need a fake group of their own")
        if _FAKE["world"] == world:
            return
        dist.destroy_process_group()
        _FAKE["meshes"].clear()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    _FAKE["world"] = world


def device_mesh(mesh: Mesh, device_type: str = "cuda"):
    """``mesh`` as a ``torch.distributed.device_mesh.DeviceMesh`` of
    ``mesh.size`` ranks over a fake process group, with the record's
    axis names; this process is rank 0, so a DTensor's local shard is
    chip 0's and its collectives move nothing.

    ``device_type`` is where the local shards live.  On a card,
    ``"cuda"``: each op runs on chip 0's share, the kernels' custom ops
    launch the hand kernels, and a redistribution between two sharded
    dims is the all-to-all the card issues.  The dry run
    (``launch.dryrun``) passes ``"cpu"``, with fake tensors on the CPU:
    a CPU-only build of PyTorch cannot index a fake CUDA tensor (its
    device guard needs CUDA), and the CPU keeps the dry run's numbers
    the same on every machine without touching a card; there DTensor
    would record an all-to-all as gloo's all-gather and chunk, so the
    dry run hands it the card's all-to-all op instead.  The group
    skips any device set-up; nothing here allocates."""
    from torch.distributed.device_mesh import DeviceMesh
    import torch
    from ..layers.sharding import register_rules
    register_rules()
    _fake_world(mesh.size)
    key = (mesh.axis_names, mesh.sizes, device_type)
    if key not in _FAKE["meshes"]:
        _FAKE["meshes"][key] = DeviceMesh(
            device_type, torch.arange(mesh.size).reshape(mesh.sizes),
            mesh_dim_names=mesh.axis_names)
    return _FAKE["meshes"][key]


def release_fake_world() -> None:
    """Destroy the fake process group :func:`device_mesh` made, if any."""
    import torch.distributed as dist
    if _FAKE["world"] is not None and dist.is_initialized():
        dist.destroy_process_group()
    _FAKE["world"] = None
    _FAKE["meshes"].clear()


def process_mesh(mesh: Mesh, device_type: str = "cuda"):
    """``mesh`` as a ``DeviceMesh`` over the default process group, whose
    ``mesh.size`` ranks are its devices in row-major order: the real
    mesh that a sharding tree on the record names
    (``train.checkpoint``'s ``restore(..., shardings=)`` places each
    leaf's shard on it).  Making one makes its subgroups, so every rank
    makes the same meshes in the same order.  Raises without a group,
    on :func:`device_mesh`'s fake group, or on a group of another
    size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from ..layers.sharding import register_rules
    if not dist.is_initialized() or _FAKE["world"] is not None:
        raise RuntimeError(
            "process_mesh: no real process group is initialized (the "
            "per-chip programs' fake group has no devices)")
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"process_mesh: a {mesh.sizes} mesh needs "
                         f"{mesh.size} ranks, the group has "
                         f"{dist.get_world_size()}")
    register_rules()
    return init_device_mesh(device_type, mesh.sizes,
                            mesh_dim_names=mesh.axis_names)
