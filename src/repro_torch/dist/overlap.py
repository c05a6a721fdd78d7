"""Collective scheduling over a process group: ring all-reduce and
compute/communication overlap (the port of ``repro.dist.overlap``).

The JAX package writes these inside ``shard_map`` over a named mesh
axis; here the axis is a ``torch.distributed`` process group (``None``
is the default group) and every rank runs the same code on its own
block:

* :func:`ring_all_reduce` — the bandwidth-optimal two-phase ring
  (reduce-scatter then all-gather over ``n`` chunks): each rank sends
  ``2 (n-1)/n`` of the payload regardless of ``n``.  ``ppermute`` to
  rank+1 becomes one ``batch_isend_irecv`` per hop (send to rank+1,
  receive from rank-1).
* :func:`overlapped_reduce_apply` — chunked gradient reduction
  pipelined against the parameter update: chunk ``i+1``'s
  ``all_reduce`` is issued (``async_op=True``) before chunk ``i``'s
  update runs, so the reduction hides behind the elementwise apply.

A collective runs on the device of its tensors, and the group's backend
must be the one for that device: NCCL for ``cuda``, gloo for ``cpu``.
A mismatch raises; nothing is staged through the host.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..device import check_group_device


def ring_schedule(group=None) -> tuple[int, list[tuple[int, int]]]:
    """(ring size, rank permutation) for a one-hop rotation.

    The single source of the ring wiring: :func:`ring_all_reduce` and the
    sharded-CSR adjacency exchange (``dist.sharded_csr``) both rotate
    payloads rank ``i`` -> ``i+1`` (ranks of ``group``), so after hop
    ``s`` rank ``me`` holds the block that started on ``(me - s) % n``.
    """
    n = dist.get_world_size(group)
    return n, [(i, (i + 1) % n) for i in range(n)]


def ring_hop(t: torch.Tensor, group=None) -> torch.Tensor:
    """One hop of the ring: send ``t`` to rank+1, return what rank-1
    sent (a tensor like ``t``).  At one rank the hop moves nothing and
    returns ``t`` itself, with no point-to-point operation."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    me = dist.get_rank(group)

    def peer(r: int) -> int:
        return r if group is None else dist.get_global_rank(group, r)

    t = t.contiguous()
    out = torch.empty_like(t)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, t, peer((me + 1) % n), group),
        dist.P2POp(dist.irecv, out, peer((me - 1) % n), group)])
    for r in reqs:
        r.wait()
    return out


def ring_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``x`` across ``group`` with a two-phase ring of hops.

    The local block is split into ``n`` chunks (padded to divide); after
    ``n-1`` reduce-scatter hops rank ``i`` owns the full sum of chunk
    ``(i+1) % n``, and ``n-1`` all-gather hops replicate every chunk.
    Returns the all-reduced block, same shape as ``x``, on every rank.
    """
    check_group_device(group, x.device, "ring_all_reduce")
    n, _ = ring_schedule(group)
    if n == 1:
        return x
    rows = x.shape[0]
    pad = (-rows) % n
    xp = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))]) \
        if pad else x
    chunks = xp.reshape((n, (rows + pad) // n) + tuple(x.shape[1:]))
    me = dist.get_rank(group)
    # reduce-scatter: after step s, this rank holds the partial sum of
    # chunk (me - s - 1) over ranks {me - s - 1, ..., me}.
    part = chunks[me].clone()
    for s in range(n - 1):
        part = ring_hop(part, group)
        part = part + chunks[(me - s - 1) % n]
    # all-gather: circulate the owned chunk (me + 1) % n around the ring.
    full = torch.zeros_like(chunks)
    full[(me + 1) % n] = part
    cur = part
    for s in range(n - 1):
        cur = ring_hop(cur, group)
        full[(me - s) % n] = cur
    out = full.reshape((rows + pad,) + tuple(x.shape[1:]))
    return out[:rows]


def overlapped_reduce_apply(grads: torch.Tensor, params: torch.Tensor,
                            group, apply_fn, n_chunks: int = 4
                            ) -> torch.Tensor:
    """Chunked ``all_reduce(grads)`` pipelined against ``apply_fn``.

    Splits ``grads``/``params`` into ``n_chunks`` along axis 0 and, for
    each chunk, issues the *next* chunk's ``all_reduce`` before applying
    ``apply_fn(param_chunk, reduced_grad_chunk)`` to the current one —
    the apply of chunk ``i`` overlaps the reduction of chunk ``i+1``.
    Returns the concatenated updated parameters; ``grads`` is left as
    it was.
    """
    check_group_device(group, grads.device, "overlapped_reduce_apply")
    rows = grads.shape[0]
    bounds = [(i * rows) // n_chunks for i in range(n_chunks + 1)]
    g_chunks = [grads[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    p_chunks = [params[a:b] for a, b in zip(bounds[:-1], bounds[1:])]

    def start(g):
        buf = g.clone(memory_format=torch.contiguous_format)
        return buf, dist.all_reduce(buf, group=group, async_op=True)

    reduced, work = start(g_chunks[0])
    outs = []
    for i in range(n_chunks):
        nxt = start(g_chunks[i + 1]) if i + 1 < n_chunks else None
        work.wait()
        outs.append(apply_fn(p_chunks[i], reduced))
        if nxt is not None:
            reduced, work = nxt
    return torch.cat(outs, dim=0)
