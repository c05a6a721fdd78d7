"""Kernel router: the tensors' device picks the path.

A tensor on the CPU runs the plain PyTorch version (``kernels/ref.py``);
a tensor on a CUDA device launches the hand-written CUDA kernel, or
raises.  There is no switch and no fallback: on the card, nothing here
ever runs a plain version.  A DTensor on the card (a mesh program)
reaches the kernels of ``searchsorted_segments``,
``searchsorted_segments_2level``, ``tile_member_mask`` and
``flash_attention`` (and its backward) through their custom ops
(``kernels.custom``), which run them on its local shards under the ops'
sharding rules; a plain card tensor calls the kernel's wrapper
directly, without the custom op's dispatch.
"""
from __future__ import annotations

import torch

from ..layers.sharding import is_dtensor as _sharded
from . import custom as _custom
from . import ref as _ref
from .flash_attention import FlashAttention
from .flash_attention import route as _flash_route
from .intersect import intersect_count_cuda, tile_member_mask_cuda
from .intersect_bitset import (bitset_intersect_count_cuda,
                               bitset_member_count_cuda,
                               bitset_member_mask_cuda)
from .searchsorted import searchsorted_segments_cuda
from .segment_outer import DEF_BN, DEF_TE, segment_outer_cuda
from .segment_outer import check_shapes as _segment_outer_shapes
from .segment_outer import promote as _segment_outer_promote


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for tensors on {t.device}")


def searchsorted_segments(values, lo, hi, queries, n_iter: int,
                          unroll: bool = False):
    """``(pos, found)`` of segmented lower bounds; see
    :func:`kernels.ref.searchsorted_segments_ref`.  ``unroll`` is the JAX
    package's loop-unrolling switch, accepted and ignored (eager PyTorch
    has no loop to unroll)."""
    if _on_cpu(values):
        return _ref.searchsorted_segments_ref(values, lo, hi, queries,
                                              n_iter=n_iter)
    if _sharded(values):
        return _custom.searchsorted_segments(values, lo, hi, queries,
                                             n_iter)
    return searchsorted_segments_cuda(values, lo, hi, queries, n_iter)


def searchsorted_segments_2level(values, summary, lo, hi, queries, *,
                                 stride: int, n1: int, n2: int):
    """Two-level segmented lower bound; see
    :func:`kernels.ref.searchsorted_segments_2level_ref`.  On the card it
    is two launches of the ``searchsorted_segments`` kernel (the summary
    level, then the window level) with the window arithmetic between
    them in PyTorch, as the reference computes it outside any kernel."""
    if _on_cpu(values):
        return _ref.searchsorted_segments_2level_ref(
            values, summary, lo, hi, queries, stride, n1, n2)
    if _sharded(values):
        return _custom.searchsorted_segments_2level(
            values, summary, lo, hi, queries, stride, n1, n2)
    return _ref.searchsorted_segments_2level_ref(
        values, summary, lo, hi, queries, stride, n1, n2,
        search=searchsorted_segments_cuda)


def tile_member_mask(indices, lo, hi, cand, check_width: int,
                     lane_len=None):
    """Per-lane membership in the first ``check_width`` values of each
    row's check segment, false past ``lane_len`` where it is given; see
    :func:`kernels.ref.tile_member_mask_ref`."""
    if _on_cpu(indices):
        return _ref.tile_member_mask_ref(indices, lo, hi, cand, check_width,
                                         lane_len)
    if _sharded(indices):
        return _custom.tile_member_mask(indices, lo, hi, cand, check_width,
                                        lane_len)
    return tile_member_mask_cuda(indices, lo, hi, cand, check_width,
                                 lane_len)


def intersect_count(a, a_len, b, b_len):
    """Per-row |A ∩ B| of padded sorted lists; see
    :func:`kernels.ref.intersect_count_ref`."""
    if _on_cpu(a):
        return _ref.intersect_count_ref(a, a_len, b, b_len)
    return intersect_count_cuda(a, a_len, b, b_len)


def bitset_intersect_count(a_words, b_words):
    """Per-row ``sum(popcount(a & b))``; see
    :func:`kernels.ref.bitset_intersect_count_ref`."""
    if _on_cpu(a_words):
        return _ref.bitset_intersect_count_ref(a_words, b_words)
    return bitset_intersect_count_cuda(a_words, b_words)


def bitset_member_mask(words, row, cand, lane_len=None):
    """Per-lane bitset membership, false past ``lane_len`` where it is
    given; see :func:`kernels.ref.bitset_member_mask_ref`."""
    if _on_cpu(words):
        return _ref.bitset_member_mask_ref(words, row, cand, lane_len)
    return bitset_member_mask_cuda(words, row, cand, lane_len)


def bitset_member_count(words, b, b_len):
    """Per-row |bitset ∩ B|; see :func:`kernels.ref.bitset_member_count_ref`."""
    if _on_cpu(words):
        return _ref.bitset_member_count_ref(words, b, b_len)
    return bitset_member_count_cuda(words, b, b_len)


def flash_attention(q, k, v, causal: bool = True, scale=None):
    """Causal GQA softmax attention, queries the last Tq positions of the
    Tk stream; see :func:`kernels.ref.flash_attention_ref`.  On the card
    the dtype and head dim pick the kernel
    (:func:`kernels.flash_attention.route`: bf16 with D a multiple of 16
    up to 128 on wgmma, the rest on mma.sync).  As in the JAX package,
    the plain path takes any shape and the kernel path raises where
    ``flash_attention_pallas`` asserts
    (:func:`kernels.flash_attention.check_shapes`: Tq and Tk multiples of
    min(128, T)).  On the card the result carries its gradient through
    :class:`kernels.flash_attention.FlashAttention`, whose backward is a
    hand-written kernel of the same route (``flash_attention_bwd_tc`` on
    wgmma, ``flash_attention_bwd`` on mma.sync); on the CPU autograd
    differentiates the plain version."""
    if _flash_route(q.device, q.dtype, q.shape[-1]) == "plain":
        return _ref.flash_attention_ref(q, k, v, causal=causal, scale=scale)
    return FlashAttention.apply(q, k, v, causal, scale)


def segment_outer(msg, basis, dst, block_tile0, n_nodes: int, n_tiles: int,
                  bn: int = DEF_BN, te: int = DEF_TE):
    """Segment-sum of per-edge outer products over dst-sorted edges, the
    arguments of ``segment_outer_pallas``; see
    :func:`kernels.ref.segment_outer_ref`.  Both paths take what the JAX
    function takes (any real msg and basis types; any C and M;
    ``block_tile0`` and ``n_tiles`` unused) and raise where it asserts
    (E % te == 0, n_nodes % bn == 0).  Both form the products in the type
    the kernel runs (:func:`kernels.segment_outer.promote`: the pair's
    promotion where it is float32, bf16 or f16, else float32), so the two
    paths agree on integer and float64 inputs too, and sum in float32 or
    wider."""
    _segment_outer_shapes(msg, basis, dst, n_nodes, bn, te)
    msg, basis = _segment_outer_promote(msg, basis)
    if _on_cpu(msg):
        return _ref.segment_outer_ref(msg, basis, dst, n_nodes)
    return segment_outer_cuda(msg, basis, dst, block_tile0, n_nodes, n_tiles,
                              bn=bn, te=te)
