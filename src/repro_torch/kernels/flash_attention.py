"""Flash attention on the card — the attention of every transformer layer.

Wrapper of ``csrc/flash_attention.cu``, the Hopper kernel that replaces
``repro.kernels.flash_attention.flash_attention_pallas``: causal GQA
attention with an online softmax, the queries being the last Tq positions
of the Tk stream.  See the source for the design.  The plain PyTorch
version is ``kernels.ref.flash_attention_ref``; ``kernels.ops`` routes
between the two by the tensors' device.
"""
from __future__ import annotations

import torch

from . import build

#: the TPU kernel's default query and key block (``DEF_BQ``, ``DEF_BK``):
#: its shape contract asks Tq and Tk to be multiples of min(128, T)
PALLAS_BLOCK = 128
#: the widest head the kernel takes (its output tile is 128 columns)
MAX_HEAD_DIM = 128
#: dtype -> the C entry point's dtype code
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True,
                         scale: float | None = None) -> torch.Tensor:
    """Causal GQA attention of (B, Hq, Tq, D) queries over (B, Hkv, Tk, D)
    keys and values, all f32 or all bf16 on one CUDA device, D <= 128.
    Any strides, as long as the last dim is contiguous (a transposed view
    costs no copy).  Returns (B, Hq, Tq, D) contiguous, in q's dtype;
    ``scale`` defaults to 1 / sqrt(D)."""
    name = "flash_attention"
    check_shapes(q, k, v)
    if not q.is_cuda:
        raise ValueError(f"{name}: tensors must lie on a CUDA device")
    for arg, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name}: {arg} must match q's device and dtype")
    if q.dtype not in DTYPES:
        raise ValueError(f"{name}: dtype {q.dtype} (the kernel takes "
                         "float32 and bfloat16)")
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} > {MAX_HEAD_DIM}")
    q, k, v = (t if t.stride(3) == 1 else t.contiguous() for t in (q, k, v))
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    out = torch.empty((b, hq, tq, d), dtype=q.dtype, device=q.device)
    lib = build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv,
        tq, tk, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        float(scale), int(bool(causal)), DTYPES[q.dtype], stream)
    build.check(rc, name)
    build.count_launch(name)
    return out
