"""Batched segmented binary search on the card — the vectorized ``seek_lub``.

Wrapper of ``csrc/searchsorted.cu``, the Hopper kernel that replaces
``repro.kernels.searchsorted.searchsorted_segments_pallas``.  Every lane
carries one (query, segment) pair and runs exactly ``n_iter`` branchless
rounds; see the source for the design.  The plain PyTorch version is
``kernels.ref.searchsorted_segments_ref``; ``kernels.ops`` routes between
the two by the tensors' device.
"""
from __future__ import annotations

import torch

from . import build


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"searchsorted_segments: {msg}")


def searchsorted_segments_cuda(values: torch.Tensor, lo: torch.Tensor,
                               hi: torch.Tensor, queries: torch.Tensor,
                               n_iter: int
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(pos, found)`` of each query in its segment ``values[lo:hi)``.

    values: (M,) int32, contiguous, M >= 1; queries: (R, W) int32,
    contiguous; lo, hi: int32 of shape (R, 1) or (R, W) with any strides
    (a per-row bound is read per row, never broadcast in memory).  All
    on one CUDA device.  Returns ``pos`` (R, W) int32 and ``found``
    (R, W) bool.
    """
    _require(values.is_cuda, "tensors must lie on a CUDA device")
    for name, t in (("values", values), ("lo", lo), ("hi", hi),
                    ("queries", queries)):
        _require(t.device == values.device, f"{name} is on {t.device}")
        _require(t.dtype == torch.int32, f"{name} must be int32")
    _require(values.dim() == 1 and values.shape[0] >= 1
             and values.is_contiguous(),
             "values must be a non-empty contiguous (M,) tensor")
    _require(values.shape[0] < 2 ** 31, "values longer than int32 ids")
    _require(queries.dim() == 2 and queries.is_contiguous(),
             "queries must be a contiguous (R, W) tensor")
    r, w = queries.shape
    for name, t in (("lo", lo), ("hi", hi)):
        _require(t.dim() == 2 and t.shape[0] == r and t.shape[1] in (1, w),
                 f"{name} must have shape (R, 1) or (R, W)")
    _require(n_iter >= 0, "n_iter must be >= 0")
    lo_b, hi_b = lo.expand(r, w), hi.expand(r, w)   # views: stride 0
    pos = torch.empty((r, w), dtype=torch.int32, device=values.device)
    found = torch.empty((r, w), dtype=torch.bool, device=values.device)
    lib = build.library()
    stream = torch.cuda.current_stream(values.device).cuda_stream
    rc = lib.searchsorted_segments_launch(
        values.data_ptr(), values.shape[0],
        lo_b.data_ptr(), lo_b.stride(0), lo_b.stride(1),
        hi_b.data_ptr(), hi_b.stride(0), hi_b.stride(1),
        queries.data_ptr(), r, w, int(n_iter),
        pos.data_ptr(), found.data_ptr(), stream)
    build.check(rc, "searchsorted_segments")
    build.count_launch("searchsorted_segments")
    return pos, found
