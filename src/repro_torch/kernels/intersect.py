"""Sorted-list intersection on the card — the VLFTJ tile check.

Wrappers of ``csrc/intersect.cu``, the Hopper kernels that replace
``repro.kernels.intersect.intersect_count_pallas``: the per-lane mask
form that the ``tile`` check mode launches, and the per-row count form
with the Pallas kernel's own contract beside it.  See the source for the
design.  The plain PyTorch versions are ``kernels.ref.tile_member_mask_ref``
and ``kernels.ref.intersect_count_ref``; ``kernels.ops`` routes between
them by the tensors' device.
"""
from __future__ import annotations

import torch

from . import build

#: shared memory one block may use on sm_90 (227 KB); the mask form
#: stages ``check_width`` int32 values there for each row in flight
MAX_SHARED_BYTES = 232448


def _require(cond: bool, name: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def _check_int32(name: str, tensors: dict[str, torch.Tensor]) -> None:
    first = next(iter(tensors.values()))
    _require(first.is_cuda, name, "tensors must lie on a CUDA device")
    for arg, t in tensors.items():
        _require(t.device == first.device, name, f"{arg} is on {t.device}")
        _require(t.dtype == torch.int32, name, f"{arg} must be int32")
        _require(t.is_contiguous(), name, f"{arg} must be contiguous")


def tile_member_mask_cuda(indices: torch.Tensor, lo: torch.Tensor,
                          hi: torch.Tensor, cand: torch.Tensor,
                          check_width: int,
                          lane_len: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """found[r, j]: ``j < lane_len[r]`` (every lane where ``lane_len`` is
    None) and ``cand[r, j]`` is among the first ``check_width`` values of
    ``indices[lo[r]:hi[r])``.  The candidates of lanes at or past
    ``lane_len`` are not used.

    indices: (M,) int32, M >= 1, each segment sorted; lo, hi: (R, 1)
    int32; cand: (R, W) int32; lane_len: (R,) int32 or None; all
    contiguous on one CUDA device.  Returns (R, W) bool."""
    name = "tile_member_mask"
    tensors = {"indices": indices, "lo": lo, "hi": hi, "cand": cand}
    if lane_len is not None:
        tensors["lane_len"] = lane_len
    _check_int32(name, tensors)
    _require(indices.dim() == 1 and 1 <= indices.shape[0] < 2 ** 31, name,
             "indices must be a non-empty (M,) tensor of int32 ids")
    _require(cand.dim() == 2, name, "cand must be (R, W)")
    r, w = cand.shape
    for arg, t in (("lo", lo), ("hi", hi)):
        _require(tuple(t.shape) == (r, 1), name, f"{arg} must be (R, 1)")
    _require(lane_len is None or tuple(lane_len.shape) == (r,), name,
             "lane_len must be (R,)")
    _require(0 <= check_width and 4 * check_width <= MAX_SHARED_BYTES, name,
             f"check_width {check_width} does not fit in shared memory")
    found = torch.empty((r, w), dtype=torch.bool, device=cand.device)
    lib = build.library()
    stream = torch.cuda.current_stream(cand.device).cuda_stream
    rc = lib.tile_member_mask_launch(
        indices.data_ptr(), indices.shape[0], lo.data_ptr(), hi.data_ptr(),
        cand.data_ptr(), None if lane_len is None else lane_len.data_ptr(),
        r, w, int(check_width), found.data_ptr(), stream)
    build.check(rc, name)
    build.count_launch(name)
    return found


def intersect_count_cuda(a: torch.Tensor, a_len: torch.Tensor,
                         b: torch.Tensor, b_len: torch.Tensor
                         ) -> torch.Tensor:
    """Per-row |A ∩ B|: the valid ``a[r, :a_len[r]]`` found among the
    valid ``b[r, :b_len[r]]``, which must be sorted.

    a: (R, LA), b: (R, LB), a_len, b_len: (R,), all int32, contiguous,
    on one CUDA device; any R, LA, LB.  Returns (R,) int32."""
    name = "intersect_count"
    _check_int32(name, {"a": a, "a_len": a_len, "b": b, "b_len": b_len})
    _require(a.dim() == 2 and b.dim() == 2 and b.shape[0] == a.shape[0],
             name, "a must be (R, LA) and b (R, LB)")
    r = a.shape[0]
    _require(a_len.shape == (r,) and b_len.shape == (r,), name,
             "a_len and b_len must be (R,)")
    out = torch.empty(r, dtype=torch.int32, device=a.device)
    lib = build.library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = lib.intersect_count_launch(
        a.data_ptr(), a.shape[1], a_len.data_ptr(), b.data_ptr(), b.shape[1],
        b_len.data_ptr(), r, out.data_ptr(), stream)
    build.check(rc, name)
    build.count_launch(name)
    return out
