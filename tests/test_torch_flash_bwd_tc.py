"""The tensor-core flash backward's contract, held on the CPU.

``csrc/flash_attention_bwd_tc.cu`` runs only on the card (``chip_smoke.py``
holds it against its plain version there).  Here: the plain version of
what the tensor-core forward now saves for it, ``kernels.ref.
flash_attention_lse_ref`` (each row's log-sum-exp of its scaled scores in
log2 units, +inf for a row that sees no key), against ``jax.nn.logsumexp``
of the JAX package's masked, scaled scores on the same numpy inputs;
``flash_attention_bwd_ref`` given that lse is bitwise the version that
recomputes it, and both are ``jax.vjp`` of the JAX package's plain
attention; the backward's route; the wrappers' refusals; the C signatures
and launch counter; and ``FlashAttention``'s lse plumbing through autograd.

Tolerances: the lse in f32 math on both sides, 1e-5 absolute (values of
size 5-15, sums in another order); the gradients as in
``tests/test_torch_flash_bwd.py`` (1e-5 f32, 2e-2 bf16 of the largest
|want|).
"""
import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (x64, as the JAX package's own tests run)
from repro.kernels.ref import flash_attention_ref as j_flash_ref

from repro_torch.kernels import build, ref
from repro_torch.kernels import flash_attention as fa

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LSE_TOL = 1e-5


def _inputs(seed, b, hq, hkv, tq, tk, d, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d),
             (b, hq, tq, d))]
    return [torch.from_numpy(a).to(TDT[dtype]) for a in arrs]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _jax_lse2(q, k, causal):
    """jax.nn.logsumexp of the JAX reference's masked, scaled scores (its
    ``flash_attention_ref`` before the softmax), in log2 units."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    qg = jnp.asarray(_np(q)).reshape(b, hkv, hq // hkv, tq, d)
    logits = jnp.einsum("bhgqd,bhkd->bhgqk", qg, jnp.asarray(_np(k)))
    logits = logits * (1.0 / d ** 0.5)
    if causal:
        qpos = jnp.arange(tq) + (tk - tq)
        mask = qpos[:, None] >= jnp.arange(tk)[None, :]
        logits = jnp.where(mask[None, None, None], logits, -jnp.inf)
    lse = jax.nn.logsumexp(logits, axis=-1) * np.log2(np.e)
    return np.asarray(lse, np.float32).reshape(b, hq, tq)


LSE_CASES = [(dtype, group, tq, tk, causal)
             for dtype in ("float32", "bfloat16")
             for group in (1, 3, 16)
             for tq, tk in ((64, 64), (32, 96), (128, 64), (1, 128))
             for causal in (True, False)]


@pytest.mark.parametrize(
    "dtype,group,tq,tk,causal", LSE_CASES,
    ids=[f"{c[0]}-g{c[1]}-{c[2]}of{c[3]}-{'causal' if c[4] else 'full'}"
         for c in LSE_CASES])
def test_lse_ref_matches_jax_logsumexp(dtype, group, tq, tk, causal):
    """Tq = Tk, the causal offset Tq < Tk, Tq > Tk (the first Tq - Tk rows
    see no key under the causal mask: +inf here, -inf in JAX) and a single
    query."""
    q, k, _, _ = _inputs(group * 7 + tq, 2, 2 * group, 2, tq, tk, 32, dtype)
    got = ref.flash_attention_lse_ref(q, k, causal=causal)
    assert got.dtype == torch.float32 and got.shape == (2, 2 * group, tq)
    want = _jax_lse2(q, k, causal)
    blind = np.isneginf(want)
    assert blind.any() == (causal and tq > tk)
    assert torch.isposinf(got[torch.from_numpy(blind)]).all()
    assert np.abs(_np(got)[~blind] - want[~blind]).max() <= LSE_TOL


BWD_CASES = [(dtype, group, d) for dtype in ("float32", "bfloat16")
             for group, d in ((1, 16), (3, 64), (16, 32), (2, 80))]


@pytest.mark.parametrize("dtype,group,d", BWD_CASES,
                         ids=[f"{c[0]}-g{c[1]}-d{c[2]}" for c in BWD_CASES])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_ref_with_saved_lse_is_bitwise_the_recomputed_one(
        dtype, group, d, causal):
    """Given ``flash_attention_lse_ref``'s lse, the plain backward gives the
    same bits as when it recomputes it, and both are ``jax.vjp`` of the
    JAX package's plain attention (Tq = Tk and the causal offset)."""
    for tq, tk in ((64, 64), (32, 96)):
        q, k, v, do = _inputs(d + tq + group, 1, 2 * group, 2, tq, tk, d,
                              dtype)
        jq, jk, jv, jdo = (jnp.asarray(_np(t), JDT[dtype])
                           for t in (q, k, v, do))
        out, vjp = jax.vjp(
            lambda a, b_, c: j_flash_ref(a, b_, c, causal=causal),
            jq, jk, jv)
        want = vjp(jdo)
        o = torch.from_numpy(np.array(out, np.float32)).to(q.dtype)
        lse = ref.flash_attention_lse_ref(q, k, causal=causal)
        given = ref.flash_attention_bwd_ref(q, k, v, o, do, causal, lse=lse)
        again = ref.flash_attention_bwd_ref(q, k, v, o, do, causal)
        for name, g, a, w in zip("qkv", given, again, want):
            assert torch.equal(g, a), name
            w = np.asarray(w, np.float32)
            err = np.abs(_np(g) - w).max() / np.abs(w).max()
            assert err <= TOL[dtype], (name, tq, tk, err)


def test_backward_ref_takes_no_gradient_from_rows_with_infinite_lse():
    """Causal Tq 128 of Tk 64: the saved lse of the first 64 rows is +inf,
    and with it they carry no gradient, bit for bit as when recomputed."""
    q, k, v, do = _inputs(11, 1, 4, 2, 128, 64, 16, "bfloat16")
    lse = ref.flash_attention_lse_ref(q, k)
    assert torch.isposinf(lse[:, :, :64]).all()
    assert torch.isfinite(lse[:, :, 64:]).all()
    o = torch.nan_to_num(ref.flash_attention_ref(q, k, v), nan=0.0)
    given = ref.flash_attention_bwd_ref(q, k, v, o, do, lse=lse)
    again = ref.flash_attention_bwd_ref(q, k, v, o, do)
    assert all(torch.equal(a, b) for a, b in zip(given, again))
    assert not given[0][:, :, :64].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_backward_route_is_the_forward_route(dtype):
    """The backward runs the tensor-core kernel exactly where the forward's
    ``route()`` picks ``tc`` (bf16, D a multiple of 16 up to 128), and the
    mma.sync kernel wherever it picks ``mma``."""
    for d in range(1, fa.MAX_HEAD_DIM + 1):
        kernel = fa.bwd_kernel("cuda", dtype, d)
        tc = fa.route("cuda", dtype, d) == "tc"
        assert tc == (dtype == torch.bfloat16 and d % 16 == 0)
        assert kernel == ("flash_attention_bwd_tc" if tc
                          else "flash_attention_bwd")
    assert fa.route("cpu", dtype, 64) == "plain"


def test_backward_wrapper_refuses_what_it_cannot_run():
    """CPU tensors; an lse of the wrong shape, dtype or device (refused
    before the device is looked at); either CUDA route without the
    forward's lse."""
    q = torch.zeros(1, 2, 64, 16, dtype=torch.bfloat16)
    k = torch.zeros(1, 1, 64, 16, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention_bwd_cuda(q, k, k, q, q, lse=lse)
    for bad in (torch.zeros(1, 2, 63), torch.zeros(2, 64),
                torch.zeros(1, 2, 64, dtype=torch.float64),
                torch.zeros(1, 2, 64, dtype=torch.bfloat16),
                torch.zeros(1, 2, 64, device="meta")):
        with pytest.raises(ValueError, match="lse must be float32"):
            fa.flash_attention_bwd_cuda(q, k, k, q, q, lse=bad)
    for kernel_route in ("tc", "mma"):
        with pytest.raises(ValueError, match="needs the forward's lse"):
            fa.check_bwd_lse(q, None, kernel_route)
        fa.check_bwd_lse(q, lse, kernel_route)
    fa.check_bwd_lse(q, None)
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention_cuda(q, k, k, return_lse=True)


@pytest.mark.parametrize("b,hkv,tk,group,want", [
    (1, 2, 4096, 16, 4),    # chatglm3-6b: 64 blocks, split 4 -> 256
    (1, 32, 4096, 1, 1),    # stablelm-3b: 1,024 blocks
    (1, 8, 4096, 3, 1),     # granite-moe-3b-a800m: 256 blocks
    (1, 16, 4096, 1, 1),    # moonshot-v1-16b-a3b: 512 blocks
    (2, 2, 256, 4, 4),      # a small grid takes the whole group
    (1, 2, 256, 3, 3),
    (1, 1, 64, 1, 1),
    (4, 2, 2048, 16, 2),    # 128 blocks, split 2 -> 256
])
def test_dkdv_head_split(b, hkv, tk, group, want):
    """The dk/dv kernel's split of a GQA group's query heads: 1 where its
    grid fills the card's 132 SMs, else the smallest divisor of the group
    that does (or the whole group)."""
    assert fa.bwd_split(b, hkv, tk, group, 132) == want


def test_tensor_core_backward_is_built_bound_and_counted():
    """The new source is one of the library's; its entry point has a C
    signature (11 pointers, 21 int64 sizes and byte strides, the head
    split, scale, causal, stream) with c_void_p for every pointer and the
    stream; the forward's entry gained exactly one pointer (lse, after o);
    the launch counter exists; the kernels and their names are in the
    source."""
    assert "flash_attention_bwd_tc.cu" in {p.name for p in build.sources()}
    assert "wgmma_sm90.cuh" in {p.name for p in build.headers()}
    sig = build.SIGNATURES["flash_attention_bwd_tc_launch"]
    assert len(sig) == 11 + 21 + 4
    params = re.search(r'extern "C" int flash_attention_bwd_tc_launch\('
                       r'([^)]*)\)',
                       (build.CSRC / "flash_attention_bwd_tc.cu").read_text()
                       ).group(1).split(",")
    assert len(params) == len(sig)
    for p, t in zip(params, sig):
        assert (t is ctypes.c_void_p) == ("*" in p), (p, t)
    assert sig[-1] is ctypes.c_void_p and sig[-4] is ctypes.c_int
    fwd = build.SIGNATURES["flash_attention_tc_launch"]
    assert fwd.count(ctypes.c_void_p) == 6 and len(fwd) == 23
    assert fwd[:5] == (ctypes.c_void_p,) * 5 and fwd[5] is ctypes.c_int64
    names = re.search(r'extern "C" int flash_attention_tc_launch\(([^)]*)\)',
                      (build.CSRC / "flash_attention_tc.cu").read_text()
                      ).group(1).split(",")
    assert names[4].split()[-1] == "lse"
    assert "flash_attention_bwd_tc" in build.LAUNCHES
    src = (build.CSRC / "flash_attention_bwd_tc.cu").read_text()
    for name in ("flash_attention_bwd_tc_dq_kernel",
                 "flash_attention_bwd_tc_dkdv_kernel",
                 "flash_attention_bwd_tc_reduce_kernel", "wgmma_ss_n64",
                 "rs_product", "tma_load_4d"):
        assert name in src or name in (build.CSRC / "wgmma_sm90.cuh"
                                        ).read_text()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    assert not re.search(r"atomic|\bred\.|\batom\.", code)


def test_autograd_saves_the_forward_lse_for_the_tensor_core_backward(
        monkeypatch):
    """``FlashAttention`` on the ``tc`` route asks the forward for its lse
    only where a gradient is needed and hands it to the backward; the
    kernels are replaced by their plain versions (this runs on the CPU),
    and the gradient is the plain backward's, bit for bit."""
    calls = []

    def fwd(q, k, v, causal=True, scale=None, return_lse=False):
        calls.append(("forward", return_lse))
        o = ref.flash_attention_ref(q, k, v, causal, scale)
        if return_lse:
            return o, ref.flash_attention_lse_ref(q, k, causal, scale)
        return o

    def bwd(q, k, v, o, do, causal=True, scale=None, lse=None):
        fa.check_bwd_lse(q, lse, "tc")
        calls.append(("backward", lse is not None))
        return ref.flash_attention_bwd_ref(q, k, v, o, do, causal, scale,
                                           lse=lse)

    monkeypatch.setattr(fa, "flash_attention_cuda", fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd_cuda", bwd)
    monkeypatch.setattr(fa, "route", lambda *a: "tc")
    q, k, v, do = _inputs(5, 1, 4, 2, 64, 64, 32, "float32")
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = fa.FlashAttention.apply(*leaves, True, None)
    grads = torch.autograd.grad(o, leaves, do)
    want = ref.flash_attention_bwd_ref(q, k, v, o.detach(), do)
    assert all(torch.equal(g, w) for g, w in zip(grads, want))
    fa.FlashAttention.apply(q, k, v, True, None)  # no gradient: no lse
    assert calls == [("forward", True), ("backward", True),
                     ("forward", False)]
