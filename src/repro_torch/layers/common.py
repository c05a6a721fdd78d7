"""Shared layer primitives: norms, RoPE, activations, initializers.

PyTorch versions of ``repro.layers.common`` with the same arithmetic and
explicit dtypes: norms and rotary math in float32, results cast back to
the input's dtype.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def normal_init(generator: torch.Generator, shape, stddev: float = 0.02,
                dtype: torch.dtype = torch.float32,
                device: torch.device | str | None = None) -> torch.Tensor:
    """float32 normal draws times ``stddev``, cast to ``dtype``.  The
    numbers come from ``generator`` (on ``device``); they are not the JAX
    package's numbers for the same seed."""
    x = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=device if device is not None else generator.device)
    return (x * stddev).to(dtype)


def normal_init_layers(generator: torch.Generator, shape,
                       stddev: float = 0.02,
                       dtype: torch.dtype = torch.float32,
                       device: torch.device | str | None = None
                       ) -> torch.Tensor:
    """:func:`normal_init` of a stacked ``(L, ...)`` tensor, drawn one
    layer at a time into a tensor of ``dtype``, so the float32 draws
    never exceed one layer (a whole (48, 64, 2048, 1408) expert stack
    drawn at once would take two 35 GB float32 temporaries).  The
    numbers are not those of one :func:`normal_init` of the whole shape,
    nor the JAX package's."""
    dev = device if device is not None else generator.device
    out = torch.empty(tuple(shape), dtype=dtype, device=dev)
    for i in range(out.shape[0]):
        out[i] = normal_init(generator, out.shape[1:], stddev, dtype, dev)
    return out


def matmul(x: torch.Tensor, w: torch.Tensor,
           out_dtype: torch.dtype) -> torch.Tensor:
    """``einsum(x, w, preferred_element_type=f32).astype(out_dtype)``: a
    product over the last axis of ``x`` with float32 accumulation.  A
    bf16 product asked for a float32 result keeps it unrounded
    (``torch.mm``'s ``out_dtype`` on the card; float32 operands on the
    CPU)."""
    if out_dtype == torch.float32 and x.dtype != torch.float32:
        if x.is_cuda:
            y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=out_dtype)
            return y.reshape(*x.shape[:-1], w.shape[-1])
        return torch.matmul(x.float(), w.float())
    return torch.matmul(x, w).to(out_dtype)


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` with a float32 result, as
    ``einsum("ecd,edf->ecf", ..., preferred_element_type=f32)``: bf16
    operands on the card give an unrounded float32 result (``torch.bmm``'s
    ``out_dtype``), float32 operands on the CPU the same products."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor,
              bias: torch.Tensor | None = None,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)  # jnp.var: population
    out = (xf - mu) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def make_norm(kind: str) -> Callable:
    if kind == "rmsnorm":
        return lambda x, p: rmsnorm(x, p["scale"])
    if kind == "layernorm":
        return lambda x, p: layernorm(x, p["scale"], p.get("bias"))
    raise ValueError(kind)


def act_fn(kind: str) -> Callable:
    """``jax.nn.gelu`` is the tanh form by default; so is this one."""
    return {"gelu": lambda x: F.gelu(x, approximate="tanh"), "silu": F.silu,
            "relu": F.relu}[kind]


# -- rotary position embedding ----------------------------------------------

def rope_frequencies(d_rot: int, theta: float = 10_000.0,
                     device: torch.device | str | None = None
                     ) -> torch.Tensor:
    exps = torch.arange(0, d_rot, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / d_rot))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               rot_frac: float = 1.0, theta: float = 10_000.0
               ) -> torch.Tensor:
    """Rotary embedding on the leading ``rot_frac`` of head dims (rounded
    down to even), rotating interleaved pairs (dims 2i, 2i+1), identity
    on the rest.

    x: (..., T, n_heads, d_head); positions: (..., T).  ``rot_frac=0.5``
    is ChatGLM's 2D-RoPE convention."""
    d_head = x.shape[-1]
    d_rot = int(d_head * rot_frac)
    d_rot -= d_rot % 2
    if d_rot == 0:
        return x
    xr, xp = x[..., :d_rot], x[..., d_rot:]
    freqs = rope_frequencies(d_rot, theta, device=x.device)    # (d_rot/2,)
    ang = positions[..., None].float() * freqs                 # (..., T, d/2)
    cos = torch.cos(ang)[..., None, :]                         # (..., T, 1, :)
    sin = torch.sin(ang)[..., None, :]
    x1 = xr[..., 0::2].float()
    x2 = xr[..., 1::2].float()
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rot = torch.stack([r1, r2], dim=-1).reshape(xr.shape)
    return torch.cat([rot.to(x.dtype), xp], dim=-1)
