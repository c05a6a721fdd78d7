"""The mma.sync flash backward's arithmetic and contract, held on the CPU.

``csrc/flash_attention_bwd.cu`` runs only on the card (``chip_smoke.py``
holds it against its plain version there).  Here:

(a) an emulation of its float32 arithmetic: every one of its products
    (S, dP, dQ, dK, dV) in 3xTF32, each operand split into hi + lo, both
    rounded to TF32 as ``cvt.rna.tf32.f32`` rounds (to nearest, ties away
    from zero, the 13 low bits cleared), the product lo.hi + hi.lo +
    hi.hi with float32 sums; P and dS kept float32 and split too; P from
    the forward's log-sum-exp.  It is held against ``jax.vjp`` of the JAX
    package's ``flash_attention_ref`` within 2e-5 of the largest |want|
    of each output (``chip_smoke.py``'s float32 tolerance), and the same
    emulation with 1xTF32 products (hi.hi alone) is shown to miss that
    bound, so the tolerance tells the two apart;
(b) the bf16 arithmetic: bf16 operands, float32 products and sums, P and
    dS rounded to bf16 before the products that take them, within 2e-2
    (the bf16 tolerance);
(c) the sources, the header and the C signatures: the forward's entry
    gained exactly one pointer, ``lse``, after ``o``; the backward's
    parameters match ``build.SIGNATURES``; the products are ``mma.sync``,
    and nothing is atomic;
(d) the wrappers: the arguments they hand the C entries (the forward's
    lse, the backward's head split and copy width) against the
    signatures, with the library and the stream replaced, and
    ``FlashAttention``'s lse plumbing on the ``mma`` route with the
    kernels replaced by their plain versions.
"""
import ctypes
import re
from types import SimpleNamespace

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

#: chip_smoke.py's FLASH_BWD_TOL: relative to each output's largest |want|
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, b, hq, hkv, tq, tk, d, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d),
             (b, hq, tq, d))]
    return [torch.from_numpy(a).to(TDT[dtype]) for a in arrs]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to
    nearest, ties away from zero, the 13 low mantissa bits cleared (the
    kernel's ``split_tf32``: + 0x1000, then & 0xffffe000)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b on float32 as the kernel's tensor-core products give it:
    ``passes`` 3 is 3xTF32 (lo.hi + hi.lo + hi.hi, x = hi + lo, each part
    TF32), 1 is 1xTF32 (hi.hi), 0 exact products of float32 operands (the
    bf16 path: bf16 x bf16 is exact in float32); float32 sums."""
    a, b = a.float(), b.float()
    if passes == 0:
        return a @ b
    ah, bh = tf32(a), tf32(b)
    if passes == 1:
        return ah @ bh
    return tf32(a - ah) @ bh + ah @ tf32(b - bh) + ah @ bh


def emulated_bwd(q, k, v, o, do, lse, causal: bool, dtype: str,
                 passes: int = 3):
    """(dq, dk, dv) as the mma.sync backward computes them: the scores and
    dP as tensor-core products, P = 2^(S scale log2 e - lse) (0 where
    masked or where the row sees no key), Delta = rowsum(do * o),
    dS = P (dP - Delta), then dQ = dS K scale, dK = dS^T Q scale,
    dV = P^T dO, each product by :func:`mm`; in bf16 P and dS are rounded
    to bf16 before the last three."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = 1.0 / d ** 0.5
    bf16 = dtype == "bfloat16"
    passes = 0 if bf16 else passes
    qg = q.float().reshape(b, hkv, group, tq, d)
    dog = do.float().reshape(b, hkv, group, tq, d)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    s = mm(qg, kf.transpose(-1, -2), passes)
    dp = mm(dog, vf.transpose(-1, -2), passes)
    lse2 = lse.float().reshape(b, hkv, group, tq, 1)
    p = torch.exp2(s * (scale * ref.LOG2E) - lse2)
    if causal:
        qpos = torch.arange(tq) + (tk - tq)
        p = torch.where(qpos[:, None] >= torch.arange(tk)[None, :], p, 0.0)
    p = torch.where(torch.isfinite(lse2), p, 0.0)
    delta = (dog * o.float().reshape(b, hkv, group, tq, d)).sum(
        -1, keepdim=True)
    ds = p * (dp - delta)
    if bf16:
        p, ds = p.bfloat16().float(), ds.bfloat16().float()
    dq = mm(ds, kf, passes) * scale
    dk = mm(ds.transpose(-1, -2), qg, passes).sum(2) * scale
    dv = mm(p.transpose(-1, -2), dog, passes).sum(2)
    return (dq.reshape(b, hq, tq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _case(seed, group, d, tq, tk, causal, dtype):
    """Inputs, the JAX package's output and its vjp, and the forward's lse
    (the plain version of what the mma forward saves)."""
    q, k, v, do = _inputs(seed, 1, 2 * group, 2, tq, tk, d, dtype)
    jq, jk, jv, jdo = (jnp.asarray(_np(t), JDT[dtype]) for t in (q, k, v, do))
    out, vjp = jax.vjp(lambda a, b_, c: j_flash_ref(a, b_, c, causal=causal),
                       jq, jk, jv)
    o = torch.from_numpy(np.array(out, np.float32)).to(q.dtype)
    lse = ref.flash_attention_lse_ref(q, k, causal=causal)
    return (q, k, v, o, do, lse), [np.asarray(w, np.float32)
                                   for w in vjp(jdo)]


def _rel_errs(got, want) -> list:
    return [float(np.abs(_np(g) - w).max() / np.abs(w).max())
            for g, w in zip(got, want)]


F32_CASES = [(group, d, causal) for d in (8, 40, 72, 128)
             for group in (1, 4) for causal in (True, False)]


@pytest.mark.parametrize(
    "group,d,causal", F32_CASES,
    ids=[f"g{c[0]}-d{c[1]}-{'causal' if c[2] else 'full'}"
         for c in F32_CASES])
def test_3xtf32_arithmetic_matches_jax_vjp_and_1xtf32_does_not(group, d,
                                                               causal):
    """(a) Tq = Tk and the causal offset Tq < Tk: 3xTF32 within 2e-5 of
    ``jax.vjp``'s largest |want| in each of dq, dk, dv; 1xTF32 beyond it
    in at least one."""
    for tq, tk in ((64, 64), (32, 96)):
        args, want = _case(d + tq + 3 * group, group, d, tq, tk, causal,
                           "float32")
        errs = _rel_errs(emulated_bwd(*args, causal, "float32"), want)
        assert max(errs) <= TOL["float32"], (tq, tk, errs)
        errs1 = _rel_errs(emulated_bwd(*args, causal, "float32", passes=1),
                          want)
        assert max(errs1) > TOL["float32"], (tq, tk, errs1)


BF16_CASES = [(group, d, causal) for d in (72, 40) for group in (1, 4)
              for causal in (True, False)]


@pytest.mark.parametrize(
    "group,d,causal", BF16_CASES,
    ids=[f"g{c[0]}-d{c[1]}-{'causal' if c[2] else 'full'}"
         for c in BF16_CASES])
def test_bf16_arithmetic_matches_jax_vjp(group, d, causal):
    """(b) bf16 operands, float32 products, P and dS rounded to bf16:
    within 2e-2 of ``jax.vjp`` of the bf16 attention."""
    for tq, tk in ((64, 64), (32, 96)):
        args, want = _case(d + tq + 5 * group, group, d, tq, tk, causal,
                           "bfloat16")
        got = emulated_bwd(*args, causal, "bfloat16")
        assert all(g.dtype == torch.bfloat16 for g in got)
        errs = _rel_errs(got, want)
        assert max(errs) <= TOL["bfloat16"], (tq, tk, errs)


def test_rows_that_see_no_key_carry_no_gradient_in_the_emulation():
    """Causal Tq 128 of Tk 64: the forward's lse is +inf on the first 64
    rows, which then get dq 0 and add nothing to dk and dv: the emulation
    equals itself on the rows that see keys."""
    q, k, v, do = _inputs(7, 1, 4, 2, 128, 64, 40, "float32")
    lse = ref.flash_attention_lse_ref(q, k)
    assert torch.isposinf(lse[:, :, :64]).all()
    o = torch.nan_to_num(ref.flash_attention_ref(q, k, v), nan=0.0)
    dq, dk, dv = emulated_bwd(q, k, v, o, do, lse, True, "float32")
    assert not dq[:, :, :64].any()
    sub = emulated_bwd(q[:, :, 64:], k, v, o[:, :, 64:], do[:, :, 64:],
                       lse[:, :, 64:], True, "float32")
    for got, want in zip((dq[:, :, 64:], dk, dv), sub):
        assert torch.equal(got, want)


def _c_params(src: str, fn: str) -> list:
    text = (build.CSRC / src).read_text()
    params = re.search(rf'extern "C" int {fn}\(([^)]*)\)', text).group(1)
    return params.split(",")


def _code(name: str) -> str:
    """A source or header without its comments."""
    return "\n".join(line.split("//")[0]
                     for line in (build.CSRC / name).read_text().splitlines())


def test_sources_header_and_c_signatures():
    """(c) The forward's entry has five pointers, the fifth ``lse`` right
    after ``o``; the backward's parameters are ``build.SIGNATURES``' (a
    pointer exactly where ctypes passes ``c_void_p``: 11 tensors and the
    stream), with the head split, scale, causal, dtype and copy width
    before the stream; both sources include the shared mma.sync header,
    which ``build.headers()`` hashes into the library's name; the
    backward's products are mma.sync (bf16 m16n8k16 and 3xTF32 on tf32
    m16n8k8) and nothing in it is atomic."""
    fwd = _c_params("flash_attention.cu", "flash_attention_launch")
    names = [p.split()[-1].lstrip("*") for p in fwd]
    assert names[3:5] == ["o", "lse"]
    assert sum("*" in p for p in fwd) == 6  # five tensors and the stream
    sig = build.SIGNATURES["flash_attention_launch"]
    assert len(sig) == len(fwd)
    for p, t in zip(fwd, sig):
        assert (t is ctypes.c_void_p) == ("*" in p), (p, t)

    bwd = _c_params("flash_attention_bwd.cu", "flash_attention_bwd_launch")
    sig = build.SIGNATURES["flash_attention_bwd_launch"]
    assert len(bwd) == len(sig) == 11 + 21 + 6
    for p, t in zip(bwd, sig):
        assert (t is ctypes.c_void_p) == ("*" in p), (p, t)
    names = [p.split()[-1].lstrip("*") for p in bwd]
    assert names[5] == "lse" and names[10] == "part"
    assert names[-6:] == ["n_split", "scale", "causal", "dtype", "vec",
                          "stream"]
    assert sig[-5] is ctypes.c_float and sig[-6] is ctypes.c_int

    assert "mma_sm80.cuh" in {p.name for p in build.headers()}
    header = _code("mma_sm80.cuh")
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in header
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in header
    for src in ("flash_attention.cu", "flash_attention_bwd.cu"):
        assert '#include "mma_sm80.cuh"' in (build.CSRC / src).read_text()
    code = _code("flash_attention_bwd.cu")
    for name in ("mma_bf16", "mma_3xtf32", "split_tf32", "ldmatrix_x4_trans",
                 "cp.async", "flash_attention_bwd_mma_dq_kernel",
                 "flash_attention_bwd_mma_dkdv_kernel",
                 "flash_attention_bwd_mma_reduce_kernel"):
        assert name in code, name
    for text in (code, header):
        assert not re.search(r"atomic|\bred\.|\batom\.", text)


class _FakeLib:
    """Records the arguments of each C entry it is called through."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def fake_card(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(fa.build, "library", lambda: lib)
    monkeypatch.setattr(fa.torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(fa, "_sm_count", lambda index: 132)
    build.reset_launches()
    return lib


def test_wrappers_hand_the_c_entries_their_signatures(fake_card):
    """(d) ``_launch_mma`` passes the lse buffer right after the output
    (null without one) and ``_launch_bwd_mma`` the forward's lse, the
    head split of :func:`bwd_split` over its dtype's key tiles (its float32
    scratch where it splits) and the copy width of q, k, v and do; both
    argument lists have their signatures' lengths and count one launch."""
    q, k, v, do = _inputs(1, 1, 32, 2, 64, 64, 72, "bfloat16")
    lse = torch.zeros(1, 32, 64)
    out = fa._launch_mma(q, k, v, True, 0.125, lse)
    out2 = fa._launch_mma(q, k, v, True, 0.125)
    (n1, a1), (n2, a2) = fake_card.calls
    assert n1 == n2 == "flash_attention_launch"
    assert len(a1) == len(build.SIGNATURES[n1])
    assert a1[3] == out.data_ptr() and a1[4] == lse.data_ptr()
    assert a2[3] == out2.data_ptr() and a2[4] is None
    assert a1[-1] == 7 and a1[-2] == fa.copy_width(q, k, v)
    assert build.LAUNCHES["flash_attention_mma"] == 2

    fake_card.calls.clear()
    dq, dk, dv = fa._launch_bwd_mma(q, k, v, out, do, lse, True, 0.125)
    ((name, args),) = fake_card.calls
    assert name == "flash_attention_bwd_launch"
    assert len(args) == len(build.SIGNATURES[name])
    assert args[5] == lse.data_ptr()
    assert args[7:10] == (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    split = fa.bwd_split(1, 2, 64, 16, 132, fa.BWD_MMA_KEYS[q.dtype])
    assert split == 16 and args[10] is not None  # 2 blocks: the whole group
    assert args[11:17] == (1, 32, 2, 64, 64, 72)
    assert args[-6] == split and args[-2] == fa.copy_width(q, k, v, do)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    assert build.LAUNCHES["flash_attention_bwd"] == 1
    # the f32 path shape's 128 blocks of 128 keys take a split of 2, its
    # bf16 shape's 256 blocks of 64 none
    assert fa.bwd_split(4, 2, 2048, 16, 132,
                        fa.BWD_MMA_KEYS[torch.float32]) == 2
    assert fa.bwd_split(4, 2, 2048, 16, 132,
                        fa.BWD_MMA_KEYS[torch.bfloat16]) == 1


def test_autograd_saves_the_forward_lse_for_the_mma_backward(monkeypatch):
    """(d) ``FlashAttention`` on the ``mma`` route (float32) asks the
    forward for its lse only where a gradient is needed and hands it to
    the backward, which refuses to run without it; the kernels are
    replaced by their plain versions (this runs on the CPU), and the
    gradient is the plain backward's, bit for bit."""
    calls = []

    def fwd(q, k, v, causal=True, scale=None, return_lse=False):
        calls.append(("forward", return_lse))
        o = ref.flash_attention_ref(q, k, v, causal, scale)
        if return_lse:
            return o, ref.flash_attention_lse_ref(q, k, causal, scale)
        return o

    def bwd(q, k, v, o, do, causal=True, scale=None, lse=None):
        fa.check_bwd_lse(q, lse, fa.route("cuda", q.dtype, q.shape[3]))
        calls.append(("backward", lse is not None))
        return ref.flash_attention_bwd_ref(q, k, v, o, do, causal, scale,
                                           lse=lse)

    monkeypatch.setattr(fa, "flash_attention_cuda", fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd_cuda", bwd)
    q, k, v, do = _inputs(9, 1, 8, 2, 64, 64, 40, "float32")
    assert fa.route("cuda", q.dtype, 40) == "mma"
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = fa.FlashAttention.apply(*leaves, True, None)
    grads = torch.autograd.grad(o, leaves, do)
    want = ref.flash_attention_bwd_ref(q, k, v, o.detach(), do)
    assert all(torch.equal(g, w) for g, w in zip(grads, want))
    fa.FlashAttention.apply(q, k, v, True, None)  # no gradient: no lse
    assert calls == [("forward", True), ("backward", True),
                     ("forward", False)]
    with pytest.raises(ValueError, match="mma backward needs the forward"):
        bwd(q, k, v, o.detach(), do)
