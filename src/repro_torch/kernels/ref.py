"""Plain PyTorch versions of the port's kernels (the ``ref.py`` contract).

Written from ``repro.kernels.ref``: the same arithmetic, with every
gather index clamped explicitly where JAX clamps implicitly (PyTorch
raises on an out-of-range index).  ``kernels/ops.py`` runs these for
tensors on the CPU; ``chip_smoke.py`` holds the CUDA kernels against
them on the card.
"""
from __future__ import annotations

import torch


def searchsorted_segments_ref(values: torch.Tensor, lo: torch.Tensor,
                              hi: torch.Tensor, queries: torch.Tensor,
                              n_iter: int
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Branchless lower bound of ``queries`` within ``values[lo:hi)``.

    values: (M,) int32 sorted within each segment; lo, hi: int32,
    broadcastable to queries' shape; n_iter >= ceil(log2(max segment
    length)) + 1 rounds, run exactly.  Returns ``(pos, found)``: ``pos``
    the first index in [lo, hi) with ``values[pos] >= q`` (``hi`` if
    none), ``found`` whether ``q`` is present.
    """
    m = values.shape[0]
    if m == 0:
        raise ValueError("searchsorted_segments: values is empty")
    q = queries
    hi0 = torch.broadcast_to(hi, q.shape)
    lo_c = torch.broadcast_to(lo, q.shape).clone()
    hi_c = hi0.clone()
    for _ in range(n_iter):
        active = lo_c < hi_c
        mid = (lo_c + hi_c) >> 1
        v = values[mid.clamp(0, m - 1)]
        go_right = active & (v < q)
        lo_c = torch.where(go_right, mid + 1, lo_c)
        hi_c = torch.where(active & ~go_right, mid, hi_c)
    pos = lo_c
    found = (pos < hi0) & (values[pos.clamp(0, m - 1)] == q)
    return pos, found


def bitset_member_mask_ref(words: torch.Tensor, row: torch.Tensor,
                           cand: torch.Tensor) -> torch.Tensor:
    """Bit ``cand & 31`` of ``words[row[r], cand >> 5]`` per lane.

    words: (H, NW) int32 bit patterns of uint32 bitset rows; row: (R,)
    bitset row per frontier row; cand: (R, W) int32 vertex ids.  ``row``
    is clamped to [0, H-1] and ``cand >> 5`` to [0, NW-1], as the JAX
    gathers clamp.  Returns (R, W) bool.
    """
    h, nw = words.shape
    r = row.clamp(0, h - 1)[:, None]
    w = words[r, (cand >> 5).clamp(0, nw - 1)]
    return ((w >> (cand & 31)) & 1) != 0


def bitset_member_ref(words: torch.Tensor,
                      queries: torch.Tensor) -> torch.Tensor:
    """Gather-test membership: bit ``q & 31`` of ``words[r, q >> 5]``.

    words: (R, NW) int32 bit patterns; queries: (R, Q) ids within the
    word-aligned domain.  Returns (R, Q) bool."""
    rows = torch.arange(words.shape[0], device=words.device,
                        dtype=torch.int32)
    return bitset_member_mask_ref(words, rows, queries)


def bitset_member_count_ref(words: torch.Tensor, b: torch.Tensor,
                            b_len: torch.Tensor) -> torch.Tensor:
    """Per-row |bitset ∩ B| for padded arrays ``b`` (R, LB) with valid
    lengths ``b_len`` (R,); padded lanes test bit 0 and never count.
    Returns (R,) int32."""
    lanes = torch.arange(b.shape[1], device=b.device)
    valid = lanes[None, :] < b_len[:, None]
    hit = bitset_member_ref(words, torch.where(valid, b, 0)) & valid
    return hit.sum(dim=1, dtype=torch.int32)
