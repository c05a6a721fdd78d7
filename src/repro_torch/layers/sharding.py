"""Sharding on a ``DeviceMesh``: specs as DTensor placements, the
sharding constraint, and the sharding rules of the ops DTensor has none
for.

A spec is a tuple with one entry per tensor dim: None, an axis name, or
a tuple of axis names, as a ``PartitionSpec`` is (``configs.common``'s
cells hold their shardings so).  :func:`placements` turns one into the
placements of a ``torch.distributed.device_mesh.DeviceMesh`` whose dim
names are the axis names, and :func:`sharding_of` reads a DTensor's
back as a :class:`NamedSharding` (a mesh and a spec, as JAX's
``NamedSharding`` is); :func:`wsc` is the port of
``jax.lax.with_sharding_constraint``: a DTensor is redistributed to the
spec, a plain tensor (one card, no mesh) is returned as it is.

:func:`register_rules` gives DTensor the rules of the products with a
float32 result of bf16 operands (``aten.mm.dtype``, ``aten.bmm.dtype``,
which ``layers.common._WideProduct`` runs on the card) and of
``aten.searchsorted.Tensor``, and those of the kernels' custom ops
(``kernels.custom``).  :func:`placements` registers them before it
lays out a first tensor.  Nothing here touches a card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

_DATA_AXES = ("pod", "data")


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (a tensor laid out on a mesh)."""
    if type(x) is torch.Tensor:   # the one-card hot path: no import
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def mesh_of(*tensors):
    """The ``DeviceMesh`` of the first DTensor among ``tensors``, None if
    there is none (one card's program)."""
    for t in tensors:
        if is_dtensor(t):
            return t.device_mesh
    return None


def on_mesh(*trees):
    """The context of a mesh program: where any tensor of ``trees`` is a
    DTensor, a plain tensor made inside it (a position, a mask, a
    constant of a derivative) is taken as whole on every chip
    (``implicit_replication``); else nothing."""
    from contextlib import nullcontext
    from torch.utils._pytree import tree_leaves
    if not any(is_dtensor(t) for t in tree_leaves(trees)):
        return nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def take(values, ids):
    """``values[ids]`` of a 1-D ``values``; on DTensors ``values`` is whole
    on every chip and each chip reads at its own ids, the result laid out
    as ``ids`` is (a local gather on any layout, where DTensor's index
    rule in some PyTorch releases refuses ids split over two mesh
    dims)."""
    if not is_dtensor(ids):
        return values[ids]
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = ids.device_mesh
    ip = list(ids.placements)
    return local_map(lambda v, i: v[i], out_placements=ip,
                     in_placements=([Replicate()] * mesh.ndim, ip),
                     device_mesh=mesh, redistribute_inputs=True)(values, ids)


def data_axes(dmesh) -> tuple:
    """The mesh's data axes, ``("pod", "data")`` or ``("data",)``, in mesh
    order; () without a mesh."""
    if dmesh is None:
        return ()
    return tuple(a for a in dmesh.mesh_dim_names if a in _DATA_AXES)


def axis_size(dmesh, axes) -> int:
    """The product of the sizes of ``axes`` (names) on ``dmesh``."""
    n = 1
    for a in axes:
        n *= dmesh.size(list(dmesh.mesh_dim_names).index(a))
    return n


def placements(dmesh, spec: tuple) -> list:
    """``spec`` as DTensor placements on ``dmesh``: a mesh dim named in
    the spec's entry for tensor dim ``d`` is ``Shard(d)``, every other
    one ``Replicate()``.  A dim sharded over several axes, ``("pod",
    "data")``, is sharded over their mesh dims major to minor, as
    ``PartitionSpec`` shards it; the axes must come in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    register_rules()
    names = tuple(dmesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        where = [names.index(a) for a in axes]
        if where != sorted(where):
            raise ValueError(f"placements: axes {axes} of {spec} are not "
                             f"in the mesh's order {names}")
        for m in where:
            out[m] = Shard(dim)
    return out


def _axis_sizes(mesh) -> dict:
    """Axis name -> size of a ``launch.mesh.Mesh`` record or a
    ``DeviceMesh``."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return mesh.shape


@dataclass(frozen=True)
class NamedSharding:
    """One leaf's sharding: a mesh and a spec (a tuple of axis names,
    None or tuples of axis names, one entry per dim).  The mesh is a
    ``launch.mesh.Mesh`` record (the dry run's cells) or a
    ``DeviceMesh`` (a real mesh, on which ``train.checkpoint`` restores
    a leaf)."""

    mesh: Any
    spec: tuple

    def shard_shape(self, global_shape) -> tuple:
        """One chip's shape of a ``global_shape`` array, as
        ``jax.sharding.NamedSharding.shard_shape`` gives it: each dim
        divided by the product of its axes' sizes, which must divide
        it."""
        sizes = _axis_sizes(self.mesh)
        out = []
        for dim, size in enumerate(global_shape):
            entry = self.spec[dim] if dim < len(self.spec) else None
            axes = (() if entry is None else
                    (entry,) if isinstance(entry, str) else entry)
            ways = 1
            for a in axes:
                ways *= sizes[a]
            if size % ways:
                raise ValueError(
                    f"shard_shape: axis {dim} of {tuple(global_shape)} is "
                    f"split {ways} ways by {self.spec}, which does not "
                    "divide it")
            out.append(size // ways)
        return tuple(out)


def sharding_of(t) -> NamedSharding | None:
    """The :class:`NamedSharding` of a DTensor on its own mesh, the
    inverse of :func:`placements`: tensor dim ``d``'s entry names the
    mesh dims that are ``Shard(d)``, in mesh order.  None for a plain
    tensor; a partial sum has no spec and raises."""
    if not is_dtensor(t):
        return None
    names = tuple(t.device_mesh.mesh_dim_names)
    axes = [[] for _ in range(t.ndim)]
    for name, p in zip(names, t.placements):
        if p.is_partial():
            raise ValueError(f"sharding_of: {t.placements} holds a "
                             "partial sum, which no spec describes")
        if p.is_shard():
            axes[p.dim].append(name)
    spec = tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in axes)
    return NamedSharding(t.device_mesh, spec)


class _Constrain(torch.autograd.Function):
    """A redistribution whose cotangent is constrained alike, as JAX
    transposes ``with_sharding_constraint``: DTensor's own
    ``redistribute`` would hand a partial sum's input a partial-sum
    gradient, which the products before it then reduce-scatter at their
    widest."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.want), None


def wsc(x, spec: tuple):
    """``jax.lax.with_sharding_constraint(x, spec)``: a DTensor
    redistributed to ``spec`` on its own mesh, and its gradient too (even
    where the forward is laid out so already); a plain tensor
    unchanged."""
    if not is_dtensor(x):
        return x
    return _Constrain.apply(x, tuple(placements(x.device_mesh, spec)))


def sharded_product(x, w, fn):
    """``fn(x, w)``, a product over the last dim of ``x`` (a DTensor of any
    rank) with the rows of ``w`` (2-D), on each chip's shards, laid out
    on every mesh dim as a partitioner lays out an einsum: ``x`` split
    along a leading dim (batch, sequence) meets ``w`` whole and the
    result is split alike; ``x`` whole meets ``w`` split by columns and
    the result is split by columns; both split along the contracted dim
    give a partial sum.  Any other pairing first moves the weight (or a
    partial sum) to one of these.  Each chip's product is ``fn`` on
    plain tensors, so the card's float32-result product
    (``layers.common._WideProduct``) runs as on one card, and no leading
    dims are folded into a DTensor the mesh splits twice.  The gradients
    are laid out as each pairing implies (a partial sum where a chip
    sees part of the contraction)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    n = x.ndim
    xp, wp = list(x.placements), list(w.placements)
    out, xg, wg = [], [], []
    for i, (p, q) in enumerate(zip(xp, wp)):
        if p.is_partial():
            p = xp[i] = Replicate()
        if q.is_partial():
            q = wp[i] = Replicate()
        if p.is_replicate() and q.is_shard(0):
            p = xp[i] = Shard(n - 1)
        if p.is_shard(n - 1):
            wp[i] = Shard(0)
            out.append(Partial())
            xg.append(Shard(n - 1))
            wg.append(Shard(0))
        elif p.is_shard():
            wp[i] = Replicate()
            out.append(p)
            xg.append(p)
            wg.append(Partial())
        elif q.is_shard(1):
            out.append(Shard(n - 1))
            xg.append(Partial())
            wg.append(Shard(1))
        else:
            out.append(Replicate())
            xg.append(Replicate())
            wg.append(Replicate())
    return local_map(fn, out_placements=out, in_placements=(xp, wp),
                     in_grad_placements=(xg, wg), device_mesh=mesh,
                     redistribute_inputs=True)(x, w)


def _product_rules(batched: bool):
    """The single-mesh-dim strategies of ``a @ b`` (``mm`` or ``bmm``):
    rows of ``a``, columns of ``b``, the contracted dim (a partial sum)
    or every operand whole; ``bmm`` adds its batch dim."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    o = 1 if batched else 0
    rules = [([Replicate()], [Replicate(), Replicate()]),
             ([Shard(o)], [Shard(o), Replicate()]),
             ([Shard(o + 1)], [Replicate(), Shard(o + 1)]),
             ([Partial()], [Shard(o + 1), Shard(o)])]
    if batched:
        rules.append(([Shard(0)], [Shard(0), Shard(0)]))
    return rules


_REGISTERED = []


def register_rules() -> None:
    """Register the sharding rules this module defines (once)."""
    if _REGISTERED:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    aten = torch.ops.aten

    @register_sharding(aten.mm.dtype)
    def _mm(a, b, out_dtype):
        return _product_rules(False)

    @register_sharding(aten.bmm.dtype)
    def _bmm(a, b, out_dtype):
        return _product_rules(True)

    @register_sharding(aten.searchsorted.Tensor)
    def _searchsorted(sorted_sequence, queries, *, out_int32=False,
                      right=False, side=None, sorter=None):
        # the sorted sequence whole on every chip, the queries (and the
        # positions, of their shape) split along any dim; a 1-D sequence
        # only, as every caller passes
        rules = [([Replicate()], [Replicate(), Replicate(), None])]
        if sorted_sequence.ndim == 1:
            rules += [([Shard(d)], [Replicate(), Shard(d), None])
                      for d in range(queries.ndim)]
        return rules

    from ..kernels import custom
    custom.register_rules()
    _REGISTERED.append(True)
