"""Flash attention on the card — the attention of every transformer layer.

Two hand-written Hopper kernels replace
``repro.kernels.flash_attention.flash_attention_pallas`` (causal GQA
attention with an online softmax, the queries being the last Tq positions
of the Tk stream), chosen by dtype and head dim (:func:`route`):

* ``csrc/flash_attention_tc.cu``: bf16 with D a multiple of 16 up to 128
  (the models' prefill and forward: chatglm3-6b's 128, stablelm-3b's 80)
  on the tensor cores, wgmma with TMA loads;
* ``csrc/flash_attention.cu``: everything else (float32 at any head dim,
  and bf16 at a head dim that is not a multiple of 16) on the tensor cores
  through warp-level ``mma.sync``, float32 as 3xTF32.

See the sources for the designs.  Each launch counts under its own name,
``flash_attention_tc`` or ``flash_attention_mma``.  The plain PyTorch
version is ``kernels.ref.flash_attention_ref``, run for CPU tensors.

The gradient has two hand-written kernels, routed by the same
:func:`route`, which the JAX package does not have: it differentiates its
plain attention.  :func:`flash_attention_bwd_cuda` runs
``csrc/flash_attention_bwd_tc.cu`` on the ``tc`` route (wgmma, counted as
``flash_attention_bwd_tc``) and ``csrc/flash_attention_bwd.cu`` (mma.sync,
float32 as 3xTF32, counted as ``flash_attention_bwd``) on the ``mma``
route; one count a backward call, for its launches.  Both take each row's
log-sum-exp from their route's forward (``return_lse``).
:class:`FlashAttention` is the ``torch.autograd.Function`` that pairs the
routed forward kernel with it; its plain version is
``kernels.ref.flash_attention_bwd_ref``.
"""
from __future__ import annotations

import functools

import torch

from . import build

#: the TPU kernel's default query and key block (``DEF_BQ``, ``DEF_BK``):
#: its shape contract asks Tq and Tk to be multiples of min(128, T)
PALLAS_BLOCK = 128
#: the widest head the kernels take (their output tile is 128 columns)
MAX_HEAD_DIM = 128
#: dtype -> the mma.sync entry point's dtype code
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the copies the mma.sync kernel stages tiles with, widest first (bytes)
COPY_WIDTHS = (16, 8, 4, 2)
#: forward route -> the backward kernel that serves it (its launch counter)
BWD_KERNELS = {"tc": "flash_attention_bwd_tc", "mma": "flash_attention_bwd"}
#: keys a block of the tensor-core backward's dk/dv kernel takes
BWD_TC_KEYS = 128
#: keys a block of the mma.sync backward's dk/dv kernel takes, by dtype
BWD_MMA_KEYS = {torch.float32: 128, torch.bfloat16: 64}


def tc_head_dim(head_dim: int) -> bool:
    """Whether the tensor-core kernel takes this head dim: a multiple of 16
    (one wgmma k16 slice) up to :data:`MAX_HEAD_DIM`.  Its launcher runs
    a head of d on the smallest of its template instances (64, 80, 128)
    of at least d, the columns past d zero."""
    return 0 < head_dim <= MAX_HEAD_DIM and head_dim % 16 == 0


def route(device, dtype: torch.dtype, head_dim: int) -> str:
    """Which flash path runs for queries of this device, dtype and head
    dim: ``"plain"`` on the CPU, ``"tc"`` (the tensor-core kernel) for
    bf16 on a CUDA device with a head dim that is a multiple of 16 up to
    128 (:func:`tc_head_dim`), ``"mma"`` (the mma.sync kernel) for any
    other CUDA input.  A route by shape, not a fallback: the chosen
    kernel raises if it cannot build or launch."""
    kind = torch.device(device).type
    if kind == "cpu":
        return "plain"
    if kind != "cuda":
        raise ValueError(f"flash_attention: no kernel for tensors on "
                         f"{device}")
    if dtype == torch.bfloat16 and tc_head_dim(head_dim):
        return "tc"
    return "mma"


def bwd_kernel(device, dtype: torch.dtype, head_dim: int) -> str:
    """The backward kernel of a CUDA input: the one of its forward's
    :func:`route` (:data:`BWD_KERNELS`)."""
    return BWD_KERNELS[route(device, dtype, head_dim)]


def bwd_split(b: int, hkv: int, tk: int, group: int, n_sm: int,
              keys: int = BWD_TC_KEYS) -> int:
    """Over how many blocks a backward's dk/dv kernel splits each GQA
    group's query heads: 1 where its grid of B * Hkv * (key tiles of
    ``keys``: :data:`BWD_TC_KEYS`, or :data:`BWD_MMA_KEYS` by dtype)
    blocks fills the card's ``n_sm`` SMs, else the smallest divisor of
    ``group`` that does (or ``group``).  Each split writes float32
    partials that a third kernel sums in split order, so the result stays
    deterministic (chatglm3-6b's 2 KV heads at B 1 x T 4096 give 64
    tensor-core blocks: split 4)."""
    blocks = b * hkv * -(-tk // keys)
    for s in range(1, group + 1):
        if group % s == 0 and blocks * s >= n_sm:
            return s
    return group


def tma_geometry(t: torch.Tensor):
    """The TMA tensor map of a (B, H, T, D) tensor read in place: its dims
    innermost first, (D, T, H, B), and the byte strides of the T, H and B
    dims.  A dim of size 1 gets the stride a contiguous tensor would have
    (it is never stepped over).  ``None`` where TMA cannot read the tensor
    in place: the D dim not contiguous, the base not 16-byte aligned, or
    a stride not a multiple of 16 bytes."""
    b, h, n, d = t.shape
    es = t.element_size()
    if d > 1 and t.stride(3) != 1:
        return None
    strides, inner = [], d
    for size, stride in ((n, t.stride(2)), (h, t.stride(1)),
                         (b, t.stride(0))):
        strides.append((stride if size > 1 else inner) * es)
        inner *= size
    if t.data_ptr() % 16 or any(s % 16 or s >= 1 << 40 for s in strides):
        return None
    return (d, n, h, b), tuple(strides)


def copy_width(*tensors: torch.Tensor) -> int:
    """The bytes one staging copy of the mma.sync kernel moves for these
    (B, H, T, D) tensors read in place: the widest of :data:`COPY_WIDTHS`,
    and at least the element size, that divides each tensor's base
    address, the byte strides of its B, H and T dims (those of size > 1)
    and the row's D * element size.  16, 8 and 4 go through ``cp.async``;
    2 (a bf16 row of odd length or stride) through plain loads."""
    es = tensors[0].element_size()
    need = []
    for t in tensors:
        need.append(t.data_ptr())
        need.append(t.shape[3] * es)
        need.extend(t.stride(i) * es for i in range(3) if t.shape[i] > 1)
    return next(w for w in COPY_WIDTHS
                if w == es or (w > es and all(x % w == 0 for x in need)))


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise where ``flash_attention_pallas`` asserts, so that the two
    packages accept the same inputs: q (B, Hq, Tq, D), k and v
    (B, Hkv, Tk, D), Hq % Hkv == 0, Tq % min(128, Tq) == 0 and
    Tk % min(128, Tk) == 0."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention: q must be (B, Hq, Tq, D) and k, v "
                         "(B, Hkv, Tk, D) of one shape")
    b, hq, tq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError("flash_attention: q, k and v must agree on B and D")
    hkv, tk = k.shape[1], k.shape[2]
    if hkv < 1 or hq % hkv:
        raise ValueError(f"flash_attention: Hq {hq} is not a multiple of "
                         f"Hkv {hkv}")
    for name, t in (("Tq", tq), ("Tk", tk)):
        if t < 1 or t % min(PALLAS_BLOCK, t):
            raise ValueError(f"flash_attention: {name} {t} is not a multiple "
                             f"of min({PALLAS_BLOCK}, {name})")


def _tma_ready(t: torch.Tensor):
    """``t`` and its :func:`tma_geometry` byte strides, ``t`` copied to a
    contiguous tensor first where TMA cannot read it in place."""
    geo = tma_geometry(t)
    if geo is None:
        t = t.contiguous()
        geo = tma_geometry(t)
    return t, geo[1]


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, scale: float | None = None,
                         return_lse: bool = False):
    """Causal GQA attention of (B, Hq, Tq, D) queries over (B, Hkv, Tk, D)
    keys and values, all f32 or all bf16 on one CUDA device, D <= 128,
    through the kernel :func:`route` picks.  Any strides, as long as the
    last dim is contiguous (a transposed view costs no copy).  Returns
    (B, Hq, Tq, D) contiguous, in q's dtype; ``scale`` defaults to
    1 / sqrt(D).  With ``return_lse`` it returns ``(o, lse)``: each row's
    log-sum-exp of its scaled scores, (B, Hq, Tq) float32 in log2 units,
    +inf for a row that sees no key
    (:func:`kernels.ref.flash_attention_lse_ref`), which the backward of
    either route takes; ``o`` is the same with it or without."""
    name = "flash_attention"
    check_shapes(q, k, v)
    if not q.is_cuda:
        raise ValueError(f"{name}: tensors must lie on a CUDA device")
    for arg, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name}: {arg} must match q's device and dtype")
    if q.dtype not in DTYPES:
        raise ValueError(f"{name}: dtype {q.dtype} (the kernels take "
                         "float32 and bfloat16)")
    if q.shape[3] > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {q.shape[3]} > {MAX_HEAD_DIM}")
    if scale is None:
        scale = 1.0 / (q.shape[3] ** 0.5)
    lse = (torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
           if return_lse else None)
    launch = (_launch_tc if route(q.device, q.dtype, q.shape[3]) == "tc"
              else _launch_mma)
    out = launch(q, k, v, causal, float(scale), lse)
    return (out, lse) if return_lse else out


def _launch_tc(q, k, v, causal: bool, scale: float,
               lse: torch.Tensor | None = None) -> torch.Tensor:
    """The tensor-core kernel (bf16, D a multiple of 16 up to 128).  A
    tensor TMA cannot read in place is copied to a contiguous one first.
    Where ``lse`` ((B, Hq, Tq) float32, contiguous) is given, the kernel
    also writes each row's log-sum-exp into it."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    (qt, qs), (kt, ks), (vt, vs) = (_tma_ready(t) for t in (q, k, v))
    out = torch.empty((b, hq, tq, d), dtype=q.dtype, device=q.device)
    lib = build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_tc_launch(
        qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, hq, hkv, tq, tk, d, *qs,
        *ks, *vs, scale, int(bool(causal)), stream)
    build.check(rc, "flash_attention_tc")
    build.count_launch("flash_attention_tc")
    return out


def _launch_mma(q, k, v, causal: bool, scale: float,
                lse: torch.Tensor | None = None) -> torch.Tensor:
    """The mma.sync kernel (f32 or bf16, any D <= 128), staging tiles with
    copies of :func:`copy_width` bytes.  Where ``lse`` ((B, Hq, Tq)
    float32, contiguous) is given, the kernel also writes each row's
    log-sum-exp into it."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    q, k, v = (t if t.stride(3) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((b, hq, tq, d), dtype=q.dtype, device=q.device)
    lib = build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, hq, hkv, tq, tk, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        scale, int(bool(causal)), DTYPES[q.dtype], copy_width(q, k, v),
        stream)
    build.check(rc, "flash_attention_mma")
    build.count_launch("flash_attention_mma")
    return out


def check_bwd_lse(q: torch.Tensor, lse: torch.Tensor | None,
                  kernel_route: str | None = None) -> None:
    """Raise where the backward cannot take ``lse``: any given ``lse`` must
    be the forward's (B, Hq, Tq) float32 log-sum-exp on q's device, and
    the kernel of either CUDA route (``kernel_route``, ``tc`` or ``mma``;
    None where not known yet) needs one."""
    name = "flash_attention_bwd"
    if lse is None:
        if kernel_route in BWD_KERNELS:
            raise ValueError(f"{name}: the {kernel_route} backward needs the "
                             "forward's lse (flash_attention_cuda(..., "
                             "return_lse=True))")
        return
    if (lse.shape != q.shape[:3] or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ValueError(f"{name}: lse must be float32 of shape "
                         f"{tuple(q.shape[:3])} on {q.device}, not "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, causal: bool = True,
                             scale: float | None = None,
                             lse: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`flash_attention_cuda` for the output
    cotangent ``do`` (B, Hq, Tq, D), given the forward's output ``o``, for
    the forward's contract (f32 or bf16, all five tensors alike, D <= 128,
    any strides with a contiguous last dim), through the backward kernel of
    the forward's :func:`route` (:func:`bwd_kernel`): on ``tc`` the wgmma
    kernel, on ``mma`` the mma.sync one; both need the forward's ``lse``
    (``flash_attention_cuda(..., return_lse=True)``).  A route by shape,
    not a fallback: a launch that fails raises.  Returns contiguous
    tensors in q's dtype."""
    name = "flash_attention_bwd"
    check_shapes(q, k, v)
    for arg, t in (("o", o), ("do", do)):
        if t.shape != q.shape:
            raise ValueError(f"{name}: {arg} must have q's shape")
    check_bwd_lse(q, lse)
    if not q.is_cuda:
        raise ValueError(f"{name}: tensors must lie on a CUDA device")
    for arg, t in (("k", k), ("v", v), ("o", o), ("do", do)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name}: {arg} must match q's device and dtype")
    if q.dtype not in DTYPES:
        raise ValueError(f"{name}: dtype {q.dtype} (the kernels take "
                         "float32 and bfloat16)")
    d = q.shape[3]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} > {MAX_HEAD_DIM}")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    kernel_route = route(q.device, q.dtype, d)
    check_bwd_lse(q, lse, kernel_route)
    launch = _launch_bwd_tc if kernel_route == "tc" else _launch_bwd_mma
    return launch(q, k, v, o, do, lse, causal, float(scale))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_bwd_mma(q, k, v, o, do, lse, causal: bool, scale: float):
    """The mma.sync kernel (``csrc/flash_attention_bwd.cu``: f32 or bf16,
    any D <= 128), given the forward's ``lse``, staging tiles with copies
    of :func:`copy_width` bytes; the dk/dv kernel's head split
    (:func:`bwd_split` over :data:`BWD_MMA_KEYS`) gets its float32 scratch
    here."""
    name = BWD_KERNELS["mma"]
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    q, k, v, o, do = (t if t.stride(3) == 1 else t.contiguous()
                      for t in (q, k, v, o, do))
    lse = lse.contiguous()
    dq = torch.empty((b, hq, tq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, hkv, tk, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    delta = torch.empty((b, hq, tq), dtype=torch.float32, device=q.device)
    split = bwd_split(b, hkv, tk, hq // hkv, _sm_count(q.device.index),
                      BWD_MMA_KEYS[q.dtype])
    part = (torch.empty((split, 2, b, hkv, tk, d), dtype=torch.float32,
                        device=q.device) if split > 1 else None)
    lib = build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(),
        None if part is None else part.data_ptr(), b, hq, hkv, tq, tk, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        *do.stride()[:3], split, scale, int(bool(causal)), DTYPES[q.dtype],
        copy_width(q, k, v, do), stream)
    build.check(rc, name)
    build.count_launch(name)
    return dq, dk, dv


def _launch_bwd_tc(q, k, v, o, do, lse, causal: bool, scale: float):
    """The tensor-core kernel (``csrc/flash_attention_bwd_tc.cu``: bf16, D
    a multiple of 16 up to 128), given the forward's ``lse``.  Tensors TMA
    cannot read in place are copied contiguous first; the dk/dv kernel's
    head split (:func:`bwd_split`) gets its float32 scratch here."""
    name = BWD_KERNELS["tc"]
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    (qt, qs), (kt, ks), (vt, vs), (ot, os_), (dot, dos) = (
        _tma_ready(t) for t in (q, k, v, o, do))
    lse = lse.contiguous()
    dq = torch.empty((b, hq, tq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, hkv, tk, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    delta = torch.empty((b, hq, tq), dtype=torch.float32, device=q.device)
    split = bwd_split(b, hkv, tk, hq // hkv, _sm_count(q.device.index))
    part = (torch.empty((split, 2, b, hkv, tk, d), dtype=torch.float32,
                        device=q.device) if split > 1 else None)
    lib = build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_bwd_tc_launch(
        qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), ot.data_ptr(),
        dot.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(),
        None if part is None else part.data_ptr(), b, hq, hkv, tq, tk, d,
        *qs, *ks, *vs, *os_, *dos, split, scale, int(bool(causal)), stream)
    build.check(rc, name)
    build.count_launch(name)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention on the card with its gradient: the forward kernel
    :func:`route` picks (``tc`` or ``mma``), and
    :func:`flash_attention_bwd_cuda` as the backward; on DTensors each
    through its custom op (``kernels.custom``), which runs it on the
    local shards under the ops' sharding rules.  Where a gradient is
    needed the forward also returns each row's log-sum-exp, saved for the
    backward (a recompute under ``torch.utils.checkpoint`` runs the
    forward again with grad on, so it saves it again).  The JAX package
    differentiates its plain attention instead (it has no backward
    kernel); the gradient is that of the same function."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale):
        from ..layers.sharding import is_dtensor
        from . import custom   # its ops wrap this module's
        lse = None
        with_lse = any(ctx.needs_input_grad[:3])
        if is_dtensor(q):
            if with_lse:
                o, lse = custom.flash_attention_lse(q, k, v, causal, scale)
            else:
                o = custom.flash_attention(q, k, v, causal, scale)
        elif with_lse:
            o, lse = flash_attention_cuda(q, k, v, causal=causal,
                                          scale=scale, return_lse=True)
        else:
            o = flash_attention_cuda(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        from ..layers.sharding import is_dtensor
        from . import custom
        if is_dtensor(q):
            dq, dk, dv = custom.flash_attention_bwd(q, k, v, o, do, lse,
                                                    ctx.causal, ctx.scale)
        else:
            dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o, do, ctx.causal,
                                                  ctx.scale, lse=lse)
        return dq, dk, dv, None, None
