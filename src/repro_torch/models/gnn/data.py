"""Graph batch container shared by every GNN, and the scatters that pass
its messages: the port of ``repro.models.gnn.data``.

Edges are stored COO (src, dst).  ``GraphBatch``, :func:`pad_graph` and
:func:`random_graph_batch` are numpy, and give the JAX package's arrays
bit for bit; :meth:`GraphBatch.to` moves a batch's arrays to a device
once, so that a training step over one fixed graph copies nothing from
the host.

The scatters keep ``jax.ops.segment_*``'s semantics, which torch's
defaults do not:

* an id outside ``[0, n)`` is dropped (``index_add_`` would raise): such
  ids go to a spare row ``n`` that the result leaves out;
* an empty segment's max is ``-inf`` and its min ``+inf`` (``index_reduce``
  onto a ``-inf`` base; ``scatter_reduce(include_self=False)`` would leave
  its base there);
* the gradient of a max is split evenly among tied entries, as in JAX.

On the card ``index_add_`` sums with float atomics, so its results are
not bitwise repeatable.  A gather ``h[idx]`` is :func:`gather`, which
reads ids as JAX indexing does: negative ids wrap once, then every id
clamps into ``[0, n)``; its gradient drops the ids outside ``[-n, n)``,
as JAX's does, and sums a bf16 gradient in float32.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

from ...layers.sharding import is_dtensor

from ...device import resolve_device


@dataclass
class GraphBatch:
    """COO graph (optionally a batch of graphs flattened with offsets)."""

    src: Any          # (E,) int32
    dst: Any          # (E,) int32
    n_nodes: int
    node_feat: Any = None       # (N, F)
    edge_feat: Any = None       # (E, Fe)
    coords: Any = None          # (N, 3) for equivariant models
    graph_id: Any = None        # (N,) int32 graph membership (batched mols)
    n_graphs: int = 1
    labels: Any = None

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    def to(self, device: torch.device | str = "cuda") -> "GraphBatch":
        """A copy whose arrays are tensors on ``device`` (ids as int64,
        floats as float32, labels as they are), moved once; ``None``
        stays ``None``.  Raises without a card unless ``device`` is the
        CPU."""
        dev = resolve_device(device, "GraphBatch.to")

        def move(x, dtype=None):
            if x is None:
                return None
            t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
                np.asarray(x))
            return t.to(device=dev, dtype=dtype or t.dtype)

        return replace(
            self, src=move(self.src, torch.int64),
            dst=move(self.dst, torch.int64),
            node_feat=move(self.node_feat, torch.float32),
            edge_feat=move(self.edge_feat, torch.float32),
            coords=move(self.coords, torch.float32),
            graph_id=move(self.graph_id, torch.int64),
            labels=move(self.labels))


def pad_graph(g: GraphBatch, n_nodes: int, n_edges: int) -> GraphBatch:
    """Pad to static sizes; padded edges self-loop onto a dummy node."""
    def pad_to(x, n, fill=0):
        if x is None:
            return None
        pad = [(0, n - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
        return np.pad(np.asarray(x), pad, constant_values=fill)

    dummy = n_nodes - 1
    src = pad_to(g.src, n_edges, dummy)
    dst = pad_to(g.dst, n_edges, dummy)
    return GraphBatch(
        src=src, dst=dst, n_nodes=n_nodes,
        node_feat=pad_to(g.node_feat, n_nodes),
        edge_feat=pad_to(g.edge_feat, n_edges),
        coords=pad_to(g.coords, n_nodes),
        graph_id=pad_to(g.graph_id, n_nodes, g.n_graphs - 1),
        n_graphs=g.n_graphs, labels=g.labels)


def random_graph_batch(n_nodes: int, n_edges: int, d_feat: int,
                       seed: int = 0, coords: bool = False,
                       d_edge: int = 0, n_graphs: int = 1,
                       n_classes: int = 8) -> GraphBatch:
    """Deterministic synthetic graph batch (symmetrized COO)."""
    rng = np.random.default_rng(seed)
    half = n_edges // 2
    s = rng.integers(0, n_nodes, half).astype(np.int32)
    d = rng.integers(0, n_nodes, half).astype(np.int32)
    src = np.concatenate([s, d])
    dst = np.concatenate([d, s])
    g = GraphBatch(
        src=src, dst=dst, n_nodes=n_nodes,
        node_feat=rng.standard_normal((n_nodes, d_feat)).astype(np.float32),
        edge_feat=(rng.standard_normal((src.shape[0], d_edge))
                   .astype(np.float32) if d_edge else None),
        coords=(rng.standard_normal((n_nodes, 3)).astype(np.float32)
                if coords else None),
        graph_id=np.sort(rng.integers(0, n_graphs, n_nodes)
                         ).astype(np.int32),
        n_graphs=n_graphs,
        labels=rng.integers(0, n_classes, n_nodes).astype(np.int32))
    return g


def as_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``x`` (numpy or a tensor) as a ``dtype`` tensor on ``device``.  A
    tensor on another device raises: a batch on the card never quietly
    goes to the CPU, nor the other way."""
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(f"a GNN batch tensor is on {x.device}, the "
                             f"parameters on {device}; move the batch "
                             "with GraphBatch.to")
        return x.to(dtype)
    return torch.as_tensor(np.asarray(x), device=device).to(dtype)


def edge_ids(g: GraphBatch, device: torch.device):
    """``(src, dst)`` of ``g`` as int64 tensors on ``device``."""
    return (as_tensor(g.src, torch.int64, device),
            as_tensor(g.dst, torch.int64, device))


def graph_ids(g: GraphBatch, device: torch.device) -> torch.Tensor:
    """Each node's graph (all 0 without ``graph_id``), int64."""
    if g.graph_id is None:
        return torch.zeros(g.n_nodes, dtype=torch.int64, device=device)
    return as_tensor(g.graph_id, torch.int64, device)


class _Gather(torch.autograd.Function):
    """``x[idx]`` along the first axis with JAX's gather and its
    transpose: the forward reads a negative id wrapped once, then every id
    clamped into ``[0, n)``; the backward adds each row's cotangent at its
    wrapped id, and drops the rows of ids outside ``[-n, n)`` (JAX's
    scatter-add drops them) into a spare row ``n`` that the gradient
    leaves out, as :func:`_segments` does for the scatters.  A bf16 or
    f16 cotangent is summed in float32 and rounded once, by the sort-based
    ``index_put_`` (the same bits in every run): an LM's embedding row
    takes thousands of a step's tokens, and summing them in bf16, one
    rounding an add, loses a tenth of the largest gradient (PERF.md)."""

    @staticmethod
    def forward(ctx, x, idx):
        n = x.shape[0]
        wrapped = torch.where(idx < 0, idx + n, idx)
        inside = (wrapped >= 0) & (wrapped < n)
        ctx.save_for_backward(torch.where(inside, wrapped, n))
        ctx.n = n
        return x.index_select(0, wrapped.clamp(0, n - 1))

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        shape = (ctx.n + 1,) + tuple(g.shape[1:])
        if g.dtype in (torch.bfloat16, torch.float16):
            out = g.new_zeros(shape, dtype=torch.float32)
            out.index_put_((ids,), g.float(), accumulate=True)
            return out[:ctx.n].to(g.dtype), None
        return g.new_zeros(shape).index_add_(0, ids, g)[:ctx.n], None


def _meta_stride(shape) -> tuple:
    return torch.empty(tuple(shape), device="meta").stride()


def _as_dtensor(t: torch.Tensor, mesh):
    """``t`` as a DTensor on ``mesh``: a plain tensor is whole on every
    chip."""
    from torch.distributed.tensor import DTensor, Replicate
    if is_dtensor(t):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _whole_where_both_split(a, b):
    """``a`` gathered whole (and any partial sum reduced) on every mesh
    dim where ``b`` is split too or ``a`` is a partial sum: one chip can
    then pair its share of one with its share of the other."""
    from torch.distributed.tensor import Replicate
    want = [Replicate() if (p.is_partial() or not q.is_replicate()
                            and not p.is_replicate()) else p
            for p, q in zip(a.placements, b.placements)]
    return a if want == list(a.placements) else a.redistribute(
        a.device_mesh, want)


def _whole(t):
    """``t`` with any partial sum reduced."""
    from torch.distributed.tensor import Replicate
    want = [Replicate() if p.is_partial() else p for p in t.placements]
    return t if want == list(t.placements) else t.redistribute(
        t.device_mesh, want)


def _row_offset(n: int, mesh, placements) -> int:
    """The first global row of this chip's shard of ``n`` rows split by
    ``placements`` (``torch.chunk``'s blocks, mesh dims major to
    minor)."""
    coord = mesh.get_coordinate()
    off, size = 0, n
    for i, p in enumerate(placements):
        if p.is_shard(0):
            chunk = -(-size // mesh.size(i))
            start = min(coord[i] * chunk, size)
            off += start
            size = min(chunk, size - start)
    return off


class _ShardedGather(torch.autograd.Function):
    """:class:`_Gather` on DTensors, one chip's share: ``x`` (rows whole
    or split, any other dim split) and 1-D ids ``idx`` (whole or split),
    never split on the same mesh dim.  A chip reads its rows for the ids
    it holds: where the ids are split the result is split as they are;
    where the rows are split each chip gathers the ids that fall in its
    rows and zeros for the rest, a partial sum that the next use of the
    rows reduces (the vocabulary-parallel embedding; an all-reduce of the
    gathered rows, which XLA's partitioner also issues for a gather from
    a row-split table, where ``tab[ids]`` on DTensors would move the
    whole table by an all-to-all).  The backward adds each chip's
    cotangent rows into its rows: split rows stay split, and rows whole
    on a dim where the ids are split get a partial sum there (reduced
    where the gradient meets its parameter's layout)."""

    @staticmethod
    def forward(ctx, x, idx):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        mesh = x.device_mesh
        n = x.shape[0]
        xl, il = x.to_local(), idx.to_local()
        nl, off = xl.shape[0], _row_offset(n, mesh, x.placements)
        wrapped = torch.where(il < 0, il + n, il)
        inside = (wrapped >= 0) & (wrapped < n)
        loc = wrapped.clamp(0, n - 1) - off
        mine = (loc >= 0) & (loc < nl)
        rows = xl.index_select(0, loc.clamp(0, max(nl - 1, 0)))
        split_rows = any(p.is_shard(0) for p in x.placements)
        if split_rows:
            rows = torch.where(mine.reshape((-1,) + (1,) * (rows.dim() - 1)),
                               rows, 0)
        out_pl = []
        for p, q in zip(x.placements, idx.placements):
            if q.is_shard():
                out_pl.append(Shard(0))
            elif p.is_shard(0):
                out_pl.append(Partial())
            elif p.is_shard():
                out_pl.append(Shard(p.dim))
            else:
                out_pl.append(Replicate())
        ctx.save_for_backward(torch.where(inside & mine, loc, nl))
        ctx.mesh, ctx.nl, ctx.xshape = mesh, nl, tuple(x.shape)
        ctx.x_pl, ctx.out_pl = tuple(x.placements), tuple(out_pl)
        ctx.grad_pl = tuple(
            Partial() if (q.is_shard() and p.is_replicate()) else p
            for p, q in zip(x.placements, idx.placements))
        shape = (idx.shape[0],) + tuple(x.shape[1:])
        return DTensor.from_local(rows, mesh, out_pl, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=_meta_stride(shape))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Replicate
        (ids,) = ctx.saved_tensors
        want = [Replicate() if p.is_partial() else p for p in ctx.out_pl]
        gl = g.redistribute(ctx.mesh, want).to_local()
        shape = (ctx.nl + 1,) + tuple(gl.shape[1:])
        if gl.dtype in (torch.bfloat16, torch.float16):
            acc = gl.new_zeros(shape, dtype=torch.float32)
            acc.index_put_((ids,), gl.float(), accumulate=True)
            grad = acc[:ctx.nl].to(gl.dtype)
        else:
            grad = gl.new_zeros(shape).index_add_(0, ids, gl)[:ctx.nl]
        return DTensor.from_local(
            grad, ctx.mesh, ctx.grad_pl, run_check=False,
            shape=torch.Size(ctx.xshape),
            stride=_meta_stride(ctx.xshape)), None


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along the first axis as JAX indexes and differentiates
    it: a negative id wraps once, then ids clamp into ``[0, len(x))``; the
    gradient (:class:`_Gather`, no host read) drops the ids outside
    ``[-len(x), len(x))``.  On DTensors each chip gathers its share
    (:class:`_ShardedGather`)."""
    if is_dtensor(x) or is_dtensor(idx):
        mesh = (x if is_dtensor(x) else idx).device_mesh
        x, idx = _as_dtensor(x, mesh), _as_dtensor(idx, mesh)
        idx = _whole(idx)
        return _ShardedGather.apply(_whole_where_both_split(x, idx), idx)
    return _Gather.apply(x, idx)


def _segments(dst, n: int, msg: torch.Tensor) -> tuple:
    """``dst`` as int64 ids on ``msg``'s device, every id outside ``[0,
    n)`` sent to the spare row ``n``, and ``msg`` broadcast to one row an
    id (a single row serves every id, as in ``jax.ops.segment_*``)."""
    ids = as_tensor(dst, torch.int64, msg.device)
    msg = msg.expand((ids.shape[0],) + tuple(msg.shape[1:]))
    return torch.where((ids >= 0) & (ids < n), ids, n), msg


class _ShardedScatterSum(torch.autograd.Function):
    """``segment_sum`` on DTensors, one chip's share: rows ``msg`` and
    their ids ``ids`` (already sent to the spare row ``n`` where they lie
    outside ``[0, n)``) split alike along the rows or whole, and any other
    dim of ``msg`` split.  Each chip adds its rows into a whole
    ``(n, ...)`` result: where the rows are split that is a partial sum,
    reduced where it is next used (the psum XLA issues for a segment sum
    of split edges); the backward gathers each chip's cotangent rows."""

    @staticmethod
    def forward(ctx, msg, ids, n: int):
        from torch.distributed.tensor import DTensor, Partial
        mesh = msg.device_mesh
        ml, il = msg.to_local(), ids.to_local()
        out = ml.new_zeros((n + 1,) + tuple(ml.shape[1:]))
        out = out.index_add(0, il, ml)[:n]
        out_pl = [Partial() if p.is_shard(0) else p
                  for p in msg.placements]
        ctx.save_for_backward(il)
        ctx.mesh, ctx.msg_pl = mesh, tuple(msg.placements)
        ctx.msg_shape, ctx.out_pl = tuple(msg.shape), tuple(out_pl)
        shape = (n,) + tuple(msg.shape[1:])
        return DTensor.from_local(out, mesh, out_pl, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=_meta_stride(shape))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Replicate
        (il,) = ctx.saved_tensors
        want = [Replicate() if p.is_partial() else p for p in ctx.out_pl]
        gl = g.redistribute(ctx.mesh, want).to_local()
        gl = torch.cat([gl, gl.new_zeros((1,) + tuple(gl.shape[1:]))])
        return DTensor.from_local(
            gl.index_select(0, il), ctx.mesh, ctx.msg_pl, run_check=False,
            shape=torch.Size(ctx.msg_shape),
            stride=_meta_stride(ctx.msg_shape)), None, None


def _rows_alike(msg, ids):
    """``msg`` and ``ids`` split alike along their rows on every mesh dim
    (a whole one is cut to the other's split, which moves nothing)."""
    from torch.distributed.tensor import Shard
    mesh = msg.device_mesh
    mp, ip = list(msg.placements), list(ids.placements)
    for i, (p, q) in enumerate(zip(mp, ip)):
        if q.is_shard(0) and p.is_replicate():
            mp[i] = Shard(0)
        elif p.is_shard(0) and q.is_replicate():
            ip[i] = Shard(0)
        elif q.is_shard(0) and not p.is_shard(0):
            mp[i] = Shard(0)
    if mp != list(msg.placements):
        msg = msg.redistribute(mesh, mp)
    if ip != list(ids.placements):
        ids = ids.redistribute(mesh, ip)
    return msg, ids


def scatter_sum(msg: torch.Tensor, dst, n_nodes: int) -> torch.Tensor:
    """``jax.ops.segment_sum(msg, dst, num_segments=n_nodes)``; on
    DTensors each chip sums its rows (:class:`_ShardedScatterSum`)."""
    ids, msg = _segments(dst, n_nodes, msg)
    if is_dtensor(msg) or is_dtensor(ids):
        mesh = (msg if is_dtensor(msg) else ids).device_mesh
        msg, ids = _rows_alike(_whole(_as_dtensor(msg, mesh)),
                               _whole(_as_dtensor(ids, mesh)))
        return _ShardedScatterSum.apply(msg, ids, n_nodes)
    out = msg.new_zeros((n_nodes + 1,) + tuple(msg.shape[1:]))
    return out.index_add(0, ids, msg)[:n_nodes]


def scatter_max(msg: torch.Tensor, dst, n_nodes: int) -> torch.Tensor:
    """``jax.ops.segment_max``: ``-inf`` where a segment is empty."""
    ids, msg = _segments(dst, n_nodes, msg)
    base = msg.new_full((n_nodes + 1,) + tuple(msg.shape[1:]),
                        float("-inf"))
    return base.index_reduce(0, ids, msg, "amax",
                             include_self=True)[:n_nodes]


def scatter_min(msg: torch.Tensor, dst, n_nodes: int) -> torch.Tensor:
    """``-segment_max(-msg)``: ``+inf`` where a segment is empty."""
    return -scatter_max(-msg, dst, n_nodes)


def scatter_mean(msg: torch.Tensor, dst, n_nodes: int,
                 eps: float = 1e-9) -> torch.Tensor:
    s = scatter_sum(msg, dst, n_nodes)
    cnt = scatter_sum(torch.ones_like(msg[..., :1]), dst, n_nodes)
    return s / (cnt + eps)


def node_nll(logits: torch.Tensor, labels) -> torch.Tensor:
    """The mean over nodes of ``-log_softmax(logits)[label]``; a label
    outside the classes picks nothing (0), as the JAX package's iota
    compare does."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    lab = as_tensor(labels, torch.int64, logits.device)
    c = logp.shape[-1]
    inside = (lab >= 0) & (lab < c)
    pick = logp.gather(-1, lab.clamp(0, c - 1)[:, None])[:, 0]
    return -torch.where(inside, pick, 0.0).mean()


def graph_mse(e: torch.Tensor, labels) -> torch.Tensor:
    """``mean((e - target[:, :n_out]) ** 2)`` with the labels as float32
    reshaped to one row a graph, as EGNN's and MACE's losses take them."""
    target = as_tensor(labels, torch.float32, e.device).reshape(
        e.shape[0], -1)
    return ((e - target[:, :e.shape[1]]) ** 2).mean()
