"""Plain PyTorch versions of the port's kernels (the ``ref.py`` contract).

Written from ``repro.kernels.ref``: the same arithmetic, with every
gather index clamped explicitly where JAX clamps implicitly (PyTorch
raises on an out-of-range index).  ``kernels/ops.py`` runs these for
tensors on the CPU; ``chip_smoke.py`` holds the CUDA kernels against
them on the card.
"""
from __future__ import annotations

import torch

from ..layers.sharding import take


def searchsorted_segments_ref(values: torch.Tensor, lo: torch.Tensor,
                              hi: torch.Tensor, queries: torch.Tensor,
                              n_iter: int, unroll: bool = False
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Branchless lower bound of ``queries`` within ``values[lo:hi)``.

    values: (M,) int32 sorted within each segment; lo, hi: int32,
    broadcastable to queries' shape; n_iter >= ceil(log2(max segment
    length)) + 1 rounds, run exactly.  Returns ``(pos, found)``: ``pos``
    the first index in [lo, hi) with ``values[pos] >= q`` (``hi`` if
    none), ``found`` whether ``q`` is present.  ``unroll`` (the JAX
    package's ``fori_loop`` switch) is accepted and changes nothing.
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
        # the function, not the operator: a DTensor's ``>>`` with a
        # Python int returns its input unshifted (PyTorch 2.13)
        mid = torch.bitwise_right_shift(lo_c + hi_c, 1)
        v = take(values, mid.clamp(0, m - 1))
        go_right = active & (v < q)
        lo_c = torch.where(go_right, mid + 1, lo_c)
        hi_c = torch.where(active & ~go_right, mid, hi_c)
    pos = lo_c
    found = (pos < hi0) & (take(values, pos.clamp(0, m - 1)) == q)
    return pos, found


def searchsorted_segments_2level_ref(values: torch.Tensor,
                                     summary: torch.Tensor,
                                     lo: torch.Tensor, hi: torch.Tensor,
                                     queries: torch.Tensor, stride: int,
                                     n1: int, n2: int,
                                     unroll: bool = False,
                                     search=searchsorted_segments_ref
                                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-level segmented lower bound.

    ``summary[k] = values[k * stride]``: the first level searches the
    summary over the segment's full blocks, the second a window of at
    most ``2 * stride + 1`` values of ``values``.  Same ``(pos, found)``
    contract as :func:`searchsorted_segments_ref`; ``search`` runs both
    levels (``kernels.ops`` passes the CUDA kernel); ``unroll`` is
    accepted and ignored.  The bounds are
    non-negative, so floor division is plain integer division.
    """
    q = queries
    lo_b = torch.broadcast_to(lo, q.shape)
    hi_b = torch.broadcast_to(hi, q.shape)
    fb0 = torch.div(lo_b + (stride - 1), stride, rounding_mode="floor")
    fb1 = torch.div(hi_b, stride, rounding_mode="floor")
    has_blocks = fb1 > fb0
    pos1, _ = search(summary, fb0, torch.maximum(fb0, fb1), q, n1)
    wlo = torch.where(has_blocks & (pos1 > fb0), (pos1 - 1) * stride, lo_b)
    wlo = torch.maximum(wlo, lo_b)
    whi = torch.where(has_blocks & (pos1 < fb1), pos1 * stride + 1, hi_b)
    whi = torch.minimum(whi, hi_b)
    return search(values, wlo, whi, q, n2)


#: (rows x lanes x segment) compare elements per block of the dense
#: plain versions below, so a full-size chunk does not materialize a
#: multi-GB boolean tensor
_DENSE_BLOCK_ELEMS = 1 << 26


def _row_blocks(rows: int, per_row: int):
    step = max(1, _DENSE_BLOCK_ELEMS // max(1, per_row))
    for s in range(0, rows, step):
        yield s, min(rows, s + step)


def tile_member_mask_ref(indices: torch.Tensor, lo: torch.Tensor,
                         hi: torch.Tensor, cand: torch.Tensor,
                         check_width: int,
                         lane_len: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """Tile-compare membership: ``cand[r, j]`` against the first
    ``check_width`` values of its row's check segment ``indices[lo:hi)``.

    indices: (M,) int32; lo, hi: (R, 1) int32; cand: (R, W) int32;
    lane_len: (R,) int32 valid lanes per row (the Pallas kernel's
    ``a_len``), or None for every lane.  The segment is gathered once per
    row (``seg_idx = lo + arange(check_width)`` clamped to [0, M-1],
    valid where ``seg_idx < hi``) and every live lane is compared with
    all of it, as the reference's tile branch does.  Values past
    ``check_width`` are never seen; lanes at or past ``lane_len`` are
    false, and their candidates are not used.  Returns (R, W) bool.
    """
    m = indices.shape[0]
    rows, w = cand.shape
    j2 = torch.arange(check_width, dtype=torch.int32, device=cand.device)
    seg_idx = lo + j2[None, :]                                  # (R, W2)
    seg = indices[seg_idx.clamp(0, max(0, m - 1))]
    seg_ok = seg_idx < hi
    found = torch.zeros(cand.shape, dtype=torch.bool, device=cand.device)
    live = w
    if lane_len is not None:
        lanes = lane_len.clamp(0, w)
        live = int(lanes.max()) if rows else 0
    for s, e in _row_blocks(rows, live * check_width):
        eq = cand[s:e, :live, None] == seg[s:e, None, :]
        eq &= seg_ok[s:e, None, :]
        found[s:e, :live] = eq.any(dim=2)
    if lane_len is not None:
        found &= (torch.arange(w, device=cand.device)[None, :]
                  < lanes[:, None])
    return found


def intersect_count_ref(a: torch.Tensor, a_len: torch.Tensor,
                        b: torch.Tensor, b_len: torch.Tensor
                        ) -> torch.Tensor:
    """Per-row |A ∩ B| of two padded sorted int32 lists.

    a: (R, LA), b: (R, LB); a_len, b_len: (R,) valid lengths.  The dense
    membership compare of every valid A lane with every valid B lane.
    Returns (R,) int32.
    """
    la = torch.arange(a.shape[1], device=a.device)[None, :]
    lb = torch.arange(b.shape[1], device=b.device)[None, :]
    va = la < a_len[:, None]
    vb = lb < b_len[:, None]
    out = torch.empty(a.shape[0], dtype=torch.int32, device=a.device)
    for s, e in _row_blocks(a.shape[0], a.shape[1] * b.shape[1]):
        eq = a[s:e, :, None] == b[s:e, None, :]
        eq &= va[s:e, :, None] & vb[s:e, None, :]
        out[s:e] = eq.any(dim=2).sum(dim=1, dtype=torch.int32)
    return out


def popcount32(v: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 bit patterns (SWAR), as int32.
    Worked in int64 on the low 32 bits, so no step overflows."""
    v = v.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def bitset_intersect_count_ref(a_words: torch.Tensor,
                               b_words: torch.Tensor) -> torch.Tensor:
    """Per-row |A ∩ B| of two bitset rows: ``sum(popcount(a & b))``.

    a_words, b_words: (R, NW) int32 bit patterns over a common
    word-aligned domain.  Returns (R,) int32."""
    return popcount32(a_words & b_words).sum(dim=1, dtype=torch.int32)


def bitset_member_mask_ref(words: torch.Tensor, row: torch.Tensor,
                           cand: torch.Tensor,
                           lane_len: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Bit ``cand & 31`` of ``words[row[r], cand >> 5]`` per lane.

    words: (H, NW) int32 bit patterns of uint32 bitset rows; row: (R,)
    bitset row per frontier row; cand: (R, W) int32 vertex ids; lane_len:
    (R,) int32 valid lanes per row, or None for every lane.  ``row`` is
    clamped to [0, H-1] and ``cand >> 5`` to [0, NW-1], as the JAX
    gathers clamp; ``lane_len`` is clamped to [0, W], and lanes at or past
    it are false.  Returns (R, W) bool.
    """
    h, nw = words.shape
    r = row.clamp(0, h - 1)[:, None]
    w = words[r, (cand >> 5).clamp(0, nw - 1)]
    found = ((w >> (cand & 31)) & 1) != 0
    if lane_len is not None:
        width = cand.shape[1]
        found &= (torch.arange(width, device=cand.device)[None, :]
                  < lane_len.clamp(0, width)[:, None])
    return found


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


# ---------------------------------------------------------------------------
# Flash attention (causal, GQA) and the segment outer product
# ---------------------------------------------------------------------------

#: log2(e): the kernels keep scores and log-sum-exps in log2 units
LOG2E = 1.4426950408889634


def _flash_logits(q: torch.Tensor, k: torch.Tensor, causal: bool,
                  scale: float) -> torch.Tensor:
    """Scaled scores (B, Hkv, G, Tq, Tk) in f32 of queries grouped by
    their KV head, -inf where the causal mask hides the key (the queries
    are the last Tq positions of the Tk stream)."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, tq, d).float()
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    if causal:
        qpos = torch.arange(tq, device=q.device) + (tk - tq)
        mask = qpos[:, None] >= torch.arange(tk, device=q.device)[None, :]
        logits = logits.masked_fill(~mask, float("-inf"))
    return logits


def _lse2(logits: torch.Tensor) -> torch.Tensor:
    """Each row's log-sum-exp of ``logits`` in log2 units, keepdim; +inf
    for a row that sees no key."""
    lse = torch.logsumexp(logits, dim=-1, keepdim=True) * LOG2E
    return torch.where(torch.isneginf(lse), float("inf"), lse)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        scale: float | None = None) -> torch.Tensor:
    """Plain softmax attention: f32 math, output in q's dtype.

    q: (B, Hq, Tq, D); k, v: (B, Hkv, Tk, D); Hq % Hkv == 0 (query head h
    reads KV head h // (Hq / Hkv)).  The queries are the last Tq
    positions of the Tk stream."""
    b, hq, tq, d = q.shape
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    p = torch.softmax(_flash_logits(q, k, causal, scale), dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(b, hq, tq, d).to(q.dtype)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            causal: bool = True,
                            scale: float | None = None) -> torch.Tensor:
    """Each query row's log-sum-exp of its scaled scores, in log2 units:
    ``log2 sum_k 2^(s_k * scale * log2 e)`` = logsumexp(s * scale) *
    log2 e, (B, Hq, Tq) float32; +inf for a row that sees no key (causal
    with Tq > Tk).  The plain version of what either forward kernel saves
    for its backward (``csrc/flash_attention_tc.cu``,
    ``csrc/flash_attention.cu``)."""
    b, hq, tq, d = q.shape
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    return _lse2(_flash_logits(q, k, causal, scale)).reshape(b, hq, tq)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, causal: bool = True,
                            scale: float | None = None,
                            lse: torch.Tensor | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The gradient of :func:`flash_attention_ref`: ``(dq, dk, dv)`` for
    the output cotangent ``do``, in float32 math, each returned in its
    input's dtype (the plain version of ``csrc/flash_attention_bwd.cu``
    and ``csrc/flash_attention_bwd_tc.cu``).

    ``o`` is the forward's output; ``Delta = rowsum(do * o)`` stands in
    for ``rowsum(P * dP)``, as the kernels compute it.  ``lse`` (B, Hq,
    Tq), as :func:`flash_attention_lse_ref` gives it, is used where given
    instead of recomputing it (both kernels take the forward's);
    ``P = 2^(s * scale * log2 e - lse)``.  A query row that sees no key
    (causal with Tq > Tk) carries no gradient: the kernels' forward gives
    it 0, where ``flash_attention_ref``'s softmax gives NaN and autograd
    spreads the NaN into dk and dv."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    qg = q.reshape(b, hkv, group, tq, d).float()
    dog = do.reshape(b, hkv, group, tq, d).float()
    kf, vf = k.float(), v.float()
    logits = _flash_logits(q, k, causal, scale)
    if lse is None:
        lse2 = _lse2(logits)
    else:
        lse2 = lse.float().reshape(b, hkv, group, tq, 1)
    seen = torch.isfinite(lse2)
    p = torch.where(seen, torch.exp2(logits * LOG2E - lse2), 0.0)
    delta = (dog * o.reshape(b, hkv, group, tq, d).float()).sum(
        -1, keepdim=True)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, vf)
    ds = torch.where(seen, p * (dp - delta), 0.0)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg) * scale
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dog)
    return (dq.reshape(b, hq, tq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def segment_outer_ref(msg: torch.Tensor, basis: torch.Tensor,
                      dst: torch.Tensor, n_nodes: int,
                      chunk_bytes: int = 1 << 28) -> torch.Tensor:
    """Segment-sum of explicit outer products:
    ``out[n, c, m] = sum over j with dst[j] == n of msg[j, c] * basis[j, m]``.

    msg (E, C), basis (E, M), dst (E,); ``dst`` is clipped to
    [0, n_nodes] and the rows landing on ``n_nodes`` (the padding) are
    dropped.  The (E, C, M) products are formed in the inputs' dtype
    ``chunk_bytes`` at a time and scattered with ``index_add_`` into a
    float64 sum, rounded once to float32: a node may have 10^5 edges,
    where float32 sums in two orders differ by ~1e-2 on entries near 0.
    Returns (n_nodes, C, M) float32."""
    e, c = msg.shape
    m = basis.shape[1]
    out = torch.zeros((n_nodes + 1, c, m), dtype=torch.float64,
                      device=msg.device)
    safe = dst.long().clamp(0, n_nodes)
    step = max(1, chunk_bytes // (8 * c * m))
    for s in range(0, e, step):
        prod = msg[s:s + step, :, None] * basis[s:s + step, None, :]
        out.index_add_(0, safe[s:s + step], prod.double())
    return out[:n_nodes].float()
