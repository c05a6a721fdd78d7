"""Kernel router: the tensors' device picks the path.

A tensor on the CPU runs the plain PyTorch version (``kernels/ref.py``);
a tensor on a CUDA device launches the hand-written CUDA kernel, or
raises.  There is no switch and no fallback: on the card, nothing here
ever runs a plain version.
"""
from __future__ import annotations

import torch

from . import ref as _ref
from .intersect_bitset import (bitset_member_count_cuda,
                               bitset_member_mask_cuda)
from .searchsorted import searchsorted_segments_cuda


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for tensors on {t.device}")


def searchsorted_segments(values, lo, hi, queries, n_iter: int):
    """``(pos, found)`` of segmented lower bounds; see
    :func:`kernels.ref.searchsorted_segments_ref`."""
    if _on_cpu(values):
        return _ref.searchsorted_segments_ref(values, lo, hi, queries,
                                              n_iter=n_iter)
    return searchsorted_segments_cuda(values, lo, hi, queries, n_iter)


def bitset_member_mask(words, row, cand):
    """Per-lane bitset membership; see
    :func:`kernels.ref.bitset_member_mask_ref`."""
    if _on_cpu(words):
        return _ref.bitset_member_mask_ref(words, row, cand)
    return bitset_member_mask_cuda(words, row, cand)


def bitset_member_count(words, b, b_len):
    """Per-row |bitset ∩ B|; see :func:`kernels.ref.bitset_member_count_ref`."""
    if _on_cpu(words):
        return _ref.bitset_member_count_ref(words, b, b_len)
    return bitset_member_count_cuda(words, b, b_len)
