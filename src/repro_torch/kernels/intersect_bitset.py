"""Bitset membership on the card — the hub-bitset check of the hybrid
layout.

Wrappers of ``csrc/bitset_member.cu``, the Hopper kernel that replaces
``repro.kernels.intersect_bitset.bitset_member_count_pallas`` and the
per-lane form of it that the JAX level step computes inline.  Bitset
words are int32 bit patterns of the uint32 words (see
``core/device_graph.py``).  The plain PyTorch versions live in
``kernels/ref.py``; ``kernels/ops.py`` routes between them by device.
"""
from __future__ import annotations

import torch

from . import build


def _require(cond: bool, name: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def _check_inputs(name: str, words: torch.Tensor,
                  others: dict[str, torch.Tensor]) -> None:
    _require(words.is_cuda, name, "tensors must lie on a CUDA device")
    _require(words.dim() == 2 and words.shape[0] >= 1 and words.shape[1] >= 1
             and words.is_contiguous(), name,
             "words must be a non-empty contiguous (H, NW) tensor")
    for arg, t in {"words": words, **others}.items():
        _require(t.device == words.device, name, f"{arg} is on {t.device}")
        _require(t.dtype == torch.int32, name, f"{arg} must be int32")
        _require(t.is_contiguous(), name, f"{arg} must be contiguous")


def bitset_member_mask_cuda(words: torch.Tensor, row: torch.Tensor,
                            cand: torch.Tensor) -> torch.Tensor:
    """found[r, c] = bit ``cand & 31`` of ``words[row[r], cand >> 5]``.

    words: (H, NW) int32; row: (R,) int32; cand: (R, W) int32, all on
    one CUDA device.  ``row`` is clamped to [0, H-1] and ``cand >> 5`` to
    [0, NW-1].  Returns (R, W) bool."""
    name = "bitset_member_mask"
    _check_inputs(name, words, {"row": row, "cand": cand})
    _require(cand.dim() == 2 and row.dim() == 1
             and row.shape[0] == cand.shape[0], name,
             "row must be (R,) and cand (R, W)")
    r, w = cand.shape
    found = torch.empty((r, w), dtype=torch.bool, device=cand.device)
    lib = build.library()
    stream = torch.cuda.current_stream(cand.device).cuda_stream
    rc = lib.bitset_member_mask_launch(
        words.data_ptr(), words.shape[0], words.shape[1], row.data_ptr(),
        cand.data_ptr(), r, w, found.data_ptr(), stream)
    build.check(rc, name)
    build.count_launch(name)
    return found


def bitset_member_count_cuda(words: torch.Tensor, b: torch.Tensor,
                             b_len: torch.Tensor) -> torch.Tensor:
    """Per-row count of valid ``b[r, j]`` (``j < b_len[r]``) whose bit is
    set in ``words[r]``.  words: (R, NW), b: (R, LB), b_len: (R,), all
    int32 on one CUDA device.  Returns (R,) int32."""
    name = "bitset_member_count"
    _check_inputs(name, words, {"b": b, "b_len": b_len})
    r = words.shape[0]
    _require(b.dim() == 2 and b.shape[0] == r and b_len.shape == (r,), name,
             "b must be (R, LB) and b_len (R,) for (R, NW) words")
    _require(r < 2 ** 31, name, "too many rows for one grid")
    out = torch.empty(r, dtype=torch.int32, device=words.device)
    lib = build.library()
    stream = torch.cuda.current_stream(words.device).cuda_stream
    rc = lib.bitset_member_count_launch(
        words.data_ptr(), words.shape[1], b.data_ptr(), r, b.shape[1],
        b_len.data_ptr(), out.data_ptr(), stream)
    build.check(rc, name)
    build.count_launch(name)
    return out
