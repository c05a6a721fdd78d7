"""The flash-attention gradient of the port against the JAX package.

``kernels.ref.flash_attention_bwd_ref`` (the plain version of
``csrc/flash_attention_bwd.cu`` and ``csrc/flash_attention_bwd_tc.cu``)
against ``jax.vjp`` of the JAX package's ``flash_attention_ref`` (the
function the JAX package differentiates: it has no backward kernel), on
the same numpy inputs:
f32 and bf16, GQA groups 1, 2 and 4, Tq = Tk and Tq < Tk (the causal
offset), causal both ways, D 8 to 128.  Tolerance, relative to the
largest |want| of each output: 1e-5 in f32 (float32 math in both, sums
in another order) and 2e-2 in bf16 (the forward's; both compute in
float32 and round once, but ``Delta = rowsum(do * o)`` reads the bf16
output where JAX sums ``p * dp``).

The CUDA kernel itself runs only on the card: ``chip_smoke.py`` holds it
against this plain version.  Here the autograd route of
``ops.flash_attention`` on the CPU, the convention for rows that see no
key, and the wrapper's contract checks are held.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (x64, as the JAX package's own tests run)
from repro.kernels.ref import flash_attention_ref as j_flash_ref

from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 flash_attention_bwd_cuda)

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, b, hq, hkv, tq, tk, d, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d),
             (b, hq, tq, d))]
    # round through the working type once, so both packages see the
    # same values
    return [torch.from_numpy(a).to(TDT[dtype]) for a in arrs]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want, dtype=np.float32)
    return float(np.abs(_np(got) - want).max() / np.abs(want).max())


def _jax_grads(q, k, v, do, causal, dtype):
    jq, jk, jv, jdo = (jnp.asarray(_np(t), JDT[dtype]) for t in (q, k, v, do))
    out, vjp = jax.vjp(lambda a, b_, c: j_flash_ref(a, b_, c, causal=causal),
                       jq, jk, jv)
    return out, vjp(jdo)


CASES = [(dtype, group, d) for dtype in ("float32", "bfloat16")
         for group, d in ((1, 8), (1, 80), (2, 16), (2, 40), (2, 128),
                          (4, 64), (4, 72), (1, 128))]


@pytest.mark.parametrize("dtype,group,d", CASES,
                         ids=[f"{c[0]}-g{c[1]}-d{c[2]}" for c in CASES])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_jax_vjp(dtype, group, d, causal):
    hkv = 2
    for tq, tk in ((64, 64), (32, 96)):
        q, k, v, do = _inputs(d + tq, 2, hkv * group, hkv, tq, tk, d, dtype)
        out, want = _jax_grads(q, k, v, do, causal, dtype)
        o = torch.from_numpy(np.array(out, np.float32)).to(q.dtype)
        got = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal)
        for name, g, w, t in zip("qkv", got, want, (q, k, v)):
            assert g.dtype == t.dtype and g.shape == t.shape, name
            err = _rel_err(g, w)
            assert err <= TOL[dtype], (name, tq, tk, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_autograd_of_the_plain_forward_is_the_plain_backward(dtype):
    """On the CPU ``ops.flash_attention`` is the plain version and autograd
    differentiates it; its gradient is ``flash_attention_bwd_ref``'s, for
    a transposed (B, T, H, D) view as the transformer passes it."""
    q, k, v, do = _inputs(3, 2, 4, 2, 64, 64, 32, dtype)
    leaves = [t.transpose(1, 2).contiguous().requires_grad_()
              for t in (q, k, v)]
    views = [t.transpose(1, 2) for t in leaves]
    o = ops.flash_attention(*views, causal=True)
    grads = torch.autograd.grad(o, leaves, do)
    with torch.no_grad():
        want = ref.flash_attention_bwd_ref(*views, o, do, causal=True)
    for g, w in zip(grads, want):
        assert _rel_err(g.transpose(1, 2), _np(w)) <= TOL[dtype]


def test_rows_that_see_no_key_carry_no_gradient():
    """Causal with Tq > Tk: the first Tq - Tk query rows see no key.  The
    kernels' forward gives them 0 and the plain backward no gradient (dq
    rows 0, nothing in dk and dv), where the plain forward's softmax is
    NaN.  dk and dv equal the backward of the rows that do see keys."""
    q, k, v, do = _inputs(5, 1, 4, 2, 128, 64, 16, "float32")
    o = ref.flash_attention_ref(q, k, v, causal=True)
    assert torch.isnan(o[:, :, :64]).all() and not torch.isnan(o[:, :, 64:]).any()
    o = torch.nan_to_num(o, nan=0.0)
    dq, dk, dv = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=True)
    assert torch.equal(dq[:, :, :64], torch.zeros_like(dq[:, :, :64]))
    sub = ref.flash_attention_bwd_ref(q[:, :, 64:], k, v, o[:, :, 64:],
                                      do[:, :, 64:], causal=True)
    for got, want in zip((dq[:, :, 64:], dk, dv), sub):
        assert torch.equal(got, want)
    for t in (dq, dk, dv):
        assert torch.isfinite(t).all()


def test_backward_kernel_wrapper_refuses_what_it_cannot_run():
    q = torch.zeros(1, 2, 64, 16)
    k = torch.zeros(1, 1, 64, 16)
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_bwd_cuda(q, k, k, q, q)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_bwd_cuda(q, torch.zeros(1, 3, 64, 16),
                                 torch.zeros(1, 3, 64, 16), q, q)
    with pytest.raises(ValueError, match="min"):
        flash_attention_bwd_cuda(torch.zeros(1, 2, 100, 16),
                                 torch.zeros(1, 1, 130, 16),
                                 torch.zeros(1, 1, 130, 16),
                                 torch.zeros(1, 2, 100, 16),
                                 torch.zeros(1, 2, 100, 16))


def test_backward_kernel_is_built_bound_and_counted():
    """The source is one of the library's, its entry point has a C
    signature (11 pointers, 21 int64 sizes and strides, the head split,
    scale, causal, dtype, the copy width, stream) and a launch counter;
    ``FlashAttention`` is what the router applies on a CUDA tensor."""
    assert "flash_attention_bwd.cu" in {p.name for p in build.sources()}
    sig = build.SIGNATURES["flash_attention_bwd_launch"]
    assert len(sig) == 11 + 21 + 6
    assert "flash_attention_bwd" in build.LAUNCHES
    assert issubclass(FlashAttention, torch.autograd.Function)
    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    for name in ("flash_attention_bwd_mma_dq_kernel",
                 "flash_attention_bwd_mma_dkdv_kernel",
                 "flash_attention_bwd_mma_reduce_kernel",
                 'extern "C" int flash_attention_bwd_launch'):
        assert name in src
