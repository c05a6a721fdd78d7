"""Shared layer primitives: norms, RoPE, activations, initializers, the
float32-accumulating products and the cross-entropy.

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


class _WideProduct(torch.autograd.Function):
    """``a @ b`` of low-precision operands with an unrounded float32
    result on the card (``torch.mm``/``torch.bmm`` with ``out_dtype``,
    which have no derivative of their own), differentiated as JAX
    transposes a ``dot_general`` with ``preferred_element_type=f32``: the
    float32 cotangent times the other operand, summed in float32, rounded
    once to the operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        op = torch.mm if a.dim() == 2 else torch.bmm
        return op(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.matmul(g, b.float().transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = torch.matmul(a.float().transpose(-1, -2), g).to(b.dtype)
        return da, db


def matmul(x: torch.Tensor, w: torch.Tensor,
           out_dtype: torch.dtype) -> torch.Tensor:
    """``einsum(x, w, preferred_element_type=f32).astype(out_dtype)``: a
    product over the last axis of ``x`` with float32 accumulation.  A
    bf16 product asked for a float32 result keeps it unrounded
    (``torch.mm``'s ``out_dtype`` on the card, whose gradient is JAX's,
    see :class:`_WideProduct`; float32 operands on the CPU)."""
    if out_dtype == torch.float32 and x.dtype != torch.float32:
        if x.is_cuda:
            y = _WideProduct.apply(x.reshape(-1, x.shape[-1]), w)
            return y.reshape(*x.shape[:-1], w.shape[-1])
        return torch.matmul(x.float(), w.float())
    return torch.matmul(x, w).to(out_dtype)


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` with a float32 result, as
    ``einsum("ecd,edf->ecf", ..., preferred_element_type=f32)``: bf16
    operands on the card give an unrounded float32 result (``torch.bmm``'s
    ``out_dtype``, differentiated as :class:`_WideProduct` says), float32
    operands on the CPU the same products."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return _WideProduct.apply(a, b)
    return torch.bmm(a.float(), b.float())


def cross_entropy_from_logits(logits: torch.Tensor, labels: torch.Tensor,
                              vocab: int) -> torch.Tensor:
    """Per-token cross-entropy without a one-hot: the float32
    log-sum-exp over the last axis minus the label's logit (a gather).
    A label outside the last axis picks nothing (0), as the JAX
    package's iota compare does.  ``vocab`` is unused there too: padded
    logits are already masked to -1e30."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    n = lf.shape[-1]
    lab = labels.long()
    inside = (lab >= 0) & (lab < n)
    lbl = lf.gather(-1, lab.clamp(0, n - 1)[..., None])[..., 0]
    return lse - torch.where(inside, lbl, 0.0)


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
