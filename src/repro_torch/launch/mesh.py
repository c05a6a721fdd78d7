"""Meshes as records: the port of ``repro.launch.mesh``.

A :class:`Mesh` names its axes and their sizes, as a
``jax.sharding.Mesh`` does, and holds nothing else: no devices and no
process group.  The dry-run cells (``configs.common``) read it for their
sharding specs, the way the JAX cells read a mesh: ``axis_names`` for
the data axes and ``shape["model"]`` for the tensor-parallel width.
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
