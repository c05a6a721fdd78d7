"""The port's flash-attention and segment-outer paths on the CPU against
the JAX package: the Pallas kernels (interpret mode, as
``tests/test_kernels.py`` and ``tests/test_kernels_extra.py`` run them)
and the jnp references, on the same numpy inputs.

Tolerances are the JAX package's own for these kernels: 2e-5 for
float32 attention and 2e-2 for bfloat16 (bf16 rounds the inputs and the
output), 2e-4 for the segment outer product (its sums run in another
order than ``segment_sum``'s).  The CUDA kernels run only on the card;
``chip_smoke.py`` holds them against these same plain versions there.
"""
import ctypes
import re

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import repro  # noqa: F401  (x64 for the reference)
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.ref import flash_attention_ref as j_flash_ref
from repro.kernels.segment_outer import block_tile_starts as j_tile_starts
from repro.kernels.segment_outer import (segment_outer_pallas,
                                         segment_outer_ref as j_outer_ref)

from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.flash_attention import (copy_width,
                                                 flash_attention_cuda,
                                                 route, tma_geometry)
from repro_torch.kernels.segment_outer import (block_tile_starts,
                                               padded_channels, pass_basis,
                                               promote, segment_outer_cuda)

# the port's CPU tensors here are small: one intra-op thread per test
# process keeps parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(seed, b, hq, hkv, tq, tk, d, dtype):
    """q, k, v drawn with numpy and rounded to ``dtype`` once, so both
    packages see the same values."""
    rng = np.random.default_rng(seed)
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    return tuple(rng.standard_normal(s).astype(np_dt) for s in
                 ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d)))


def _both(arrs, dtype):
    j = tuple(jnp.asarray(a, JAX_DT[dtype]) for a in arrs)
    t = tuple(torch.from_numpy(np.asarray(a, np.float32)).to(TORCH_DT[dtype])
              for a in arrs)
    return j, t


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_pallas_and_ref(dtype, hq, hkv, causal):
    (jq, jk, jv), (q, k, v) = _both(_qkv(0, 2, hq, hkv, 256, 256, 64, dtype),
                                    dtype)
    got = ops.flash_attention(q, k, v, causal=causal)
    assert got.dtype == TORCH_DT[dtype] and got.shape == q.shape
    tol = TOL[dtype]
    for want in (flash_attention_pallas(jq, jk, jv, causal=causal),
                 j_flash_ref(jq, jk, jv, causal=causal)):
        assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("hq,hkv,tq,tk", [
    (4, 2, 1, 256),      # the decode shape: Tq = 1 against Tk = 256
    (32, 2, 128, 128),   # chatglm3's GQA group of 16
    (32, 2, 1, 256),
    (4, 4, 12, 12),      # a prompt below one block
])
def test_flash_attention_shapes(hq, hkv, tq, tk):
    (jq, jk, jv), (q, k, v) = _both(_qkv(1, 2, hq, hkv, tq, tk, 64,
                                         "float32"), "float32")
    got = ops.flash_attention(q, k, v, causal=True)
    for want in (flash_attention_pallas(jq, jk, jv, causal=True),
                 j_flash_ref(jq, jk, jv, causal=True)):
        assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=2e-5)


def test_flash_attention_reads_strided_views():
    """The transformer passes (B, T, H, D) tensors transposed to
    (B, H, T, D), which are not contiguous: the result is the same."""
    (_, _, _), (q, k, v) = _both(_qkv(2, 2, 8, 2, 128, 128, 32, "float32"),
                                 "float32")
    qs, ks, vs = (t.transpose(1, 2).contiguous().transpose(1, 2)
                  for t in (q, k, v))
    assert not qs.is_contiguous()
    assert torch.equal(ops.flash_attention(qs, ks, vs),
                       ops.flash_attention(q, k, v))


@pytest.mark.parametrize("shape_q,shape_k,msg", [
    ((1, 6, 128, 16), (1, 4, 128, 16), "multiple of Hkv"),
    ((1, 4, 200, 16), (1, 4, 200, 16), "Tq 200"),
    ((1, 4, 128, 16), (1, 4, 300, 16), "Tk 300"),
    ((1, 4, 128, 16), (1, 4, 128, 32), "agree on B and D"),
])
def test_flash_attention_shape_contract(shape_q, shape_k, msg):
    """The kernel's wrapper raises where ``flash_attention_pallas``
    asserts, and the JAX kernel refuses the same shapes."""
    q = torch.zeros(shape_q)
    k = torch.zeros(shape_k)
    with pytest.raises(ValueError, match=msg):
        flash_attention_cuda(q, k, k)
    with pytest.raises((AssertionError, TypeError, ValueError)):
        flash_attention_pallas(jnp.zeros(shape_q), jnp.zeros(shape_k),
                               jnp.zeros(shape_k))


def test_flash_attention_plain_path_takes_any_length():
    """The plain path, like the JAX package's default ``ops`` route (its
    jnp reference), takes lengths outside the kernel's contract."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(5, 1, 4, 2, 200, 300, 16,
                                         "float32"), "float32")
    with pytest.raises(ValueError, match="Tq 200"):
        flash_attention_cuda(q, k, v)
    assert_allclose(_f32(ops.flash_attention(q, k, v)),
                    _f32(j_flash_ref(jq, jk, jv)), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("group", [1, 4, 16])
@pytest.mark.parametrize("tq,tk", [(1, 256), (64, 256), (100, 100)])
def test_flash_attention_bf16_plain_matches_ref_on_tc_shapes(d, group, tq,
                                                              tk):
    """The shapes the card's bf16 sweep gives the tensor-core kernel (D 64
    and 128, GQA groups 1, 4, 16, the causal offset, a ragged stream below
    one key tile), cut to Tk 256: the plain version, which the card holds
    that kernel against, agrees with the JAX package's reference."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(7, 1, 2 * group, 2, tq, tk, d,
                                         "bfloat16"), "bfloat16")
    for causal in (True, False):
        assert_allclose(_f32(ops.flash_attention(q, k, v, causal=causal)),
                        _f32(j_flash_ref(jq, jk, jv, causal=causal)),
                        atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("device,dtype,d,want", [
    ("cuda", torch.bfloat16, 64, "tc"),
    ("cuda", torch.bfloat16, 128, "tc"),
    ("cuda", torch.float32, 128, "mma"),
    ("cuda", torch.float32, 64, "mma"),
    ("cuda", torch.bfloat16, 80, "tc"),      # stablelm-3b's heads
    ("cuda", torch.bfloat16, 16, "tc"),      # the reduced configs' heads
    ("cuda", torch.bfloat16, 40, "mma"),     # not a multiple of 16
    ("cuda", torch.bfloat16, 72, "mma"),
    ("cuda", torch.bfloat16, 8, "mma"),
    ("cuda", torch.float32, 80, "mma"),
    ("cuda:0", torch.bfloat16, 128, "tc"),
    ("cpu", torch.bfloat16, 128, "plain"),
    ("cpu", torch.float32, 80, "plain"),
])
def test_flash_route(device, dtype, d, want):
    """bf16 with D a multiple of 16 up to 128 takes the wgmma kernel,
    every other CUDA input (f32 at any D, bf16 off the multiples of 16)
    the mma.sync one, and CPU tensors the plain version."""
    assert route(device, dtype, d) == want


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 4)])
@pytest.mark.parametrize("tq,tk", [(1, 256), (128, 256), (256, 256),
                                   (100, 100)])
def test_flash_attention_bf16_plain_matches_ref_at_d80(hq, hkv, tq, tk):
    """stablelm-3b's head dim (80) in bf16, GQA groups 1 and 2, the causal
    offset and a ragged stream: the plain version, which the card holds
    the tensor-core kernel's D 80 instance against, agrees with the JAX
    package's reference at 2e-2."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(9, 1, hq, hkv, tq, tk, 80,
                                         "bfloat16"), "bfloat16")
    for causal in (True, False):
        assert_allclose(_f32(ops.flash_attention(q, k, v, causal=causal)),
                        _f32(j_flash_ref(jq, jk, jv, causal=causal)),
                        atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [40, 72])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_pallas_at_off_grid_head_dims(
        dtype, d, causal):
    """Head dims off the multiples of 16, which the card sends to the
    mma.sync kernel in both dtypes: the plain version the card holds that
    kernel against agrees with ``flash_attention_pallas`` (interpret mode)
    and the jnp reference, GQA group 2 and the causal offset (Tq 128, Tk
    256), at the JAX package's tolerances."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(11, 1, 4, 2, 128, 256, d, dtype),
                                    dtype)
    got = ops.flash_attention(q, k, v, causal=causal)
    assert got.dtype == TORCH_DT[dtype] and got.shape == q.shape
    tol = TOL[dtype]
    for want in (flash_attention_pallas(jq, jk, jv, causal=causal),
                 j_flash_ref(jq, jk, jv, causal=causal)):
        assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


def _layout(dtype, d, layout):
    """A (1, 4, 8, d) tensor: contiguous, a transposed (B, T, H, D) view,
    or a view one element into rows of d + 1."""
    if layout == "transposed":
        return torch.zeros((1, 8, 4, d), dtype=dtype).transpose(1, 2)
    if layout == "offset":
        return torch.zeros((1, 4, 8, d + 1), dtype=dtype)[..., 1:]
    return torch.zeros((1, 4, 8, d), dtype=dtype)


@pytest.mark.parametrize("dtype,d,layout,want", [
    (torch.bfloat16, 72, "contiguous", 16),   # rows of 144 bytes
    (torch.bfloat16, 40, "transposed", 16),
    (torch.bfloat16, 36, "contiguous", 8),    # rows of 72 bytes
    (torch.bfloat16, 7, "contiguous", 2),     # odd rows: plain loads
    (torch.bfloat16, 72, "offset", 2),        # base 2 bytes off
    (torch.float32, 128, "transposed", 16),
    (torch.float32, 6, "contiguous", 8),
    (torch.float32, 37, "contiguous", 4),
    (torch.float32, 128, "offset", 4),
])
def test_copy_width(dtype, d, layout, want):
    """The mma.sync kernel's staging copies are the widest that every base
    address, stride and row length allows, never below the element."""
    t = _layout(dtype, d, layout)
    assert copy_width(t) == want
    assert copy_width(t, _layout(dtype, d, "contiguous")) == want
    for w in (16, 8, 4, 2):
        if w <= want and w >= t.element_size():
            assert t.data_ptr() % w == 0 and (d * t.element_size()) % w == 0


def test_flash_route_refuses_other_devices():
    with pytest.raises(ValueError, match="no kernel"):
        route("meta", torch.bfloat16, 128)
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention(*(torch.zeros(1, 2, 4, 64, device="meta")
                              for _ in range(3)))


def _rebuild(t, geo):
    """The tensor TMA reads: element strides from the map's byte strides,
    dims (D, T, H, B) innermost first, over t's storage."""
    (d, n, h, b), byte_strides = geo
    es = t.element_size()
    st, sh, sb = (x // es for x in byte_strides)
    return torch.as_strided(t, (b, h, n, d), (sb, sh, st, 1),
                            t.storage_offset())


@pytest.mark.parametrize("b,t,h,d", [(4, 256, 8, 128), (2, 100, 2, 64),
                                     (1, 128, 1, 64), (3, 64, 16, 128),
                                     # stablelm-3b's prefill views
                                     (4, 128, 32, 80), (1, 256, 32, 80),
                                     (2, 64, 1, 80), (2, 64, 4, 16)])
def test_tma_geometry_rebuilds_the_tensor(b, t, h, d):
    """Dims and byte strides of the tensor maps rebuild the tensor with
    ``as_strided``: prefill's (B, T, H, D) -> (B, H, T, D) transposed view
    in place, and a contiguous (B, H, T, D) tensor.  The map's innermost
    extent is the real D (80 for stablelm-3b), so TMA zero-fills the
    rest of a 64-column box."""
    x = torch.from_numpy(np.random.default_rng(b * t + h + d)
                         .standard_normal((b, t, h, d)).astype(np.float32)
                         ).to(torch.bfloat16)
    view = x.transpose(1, 2)
    for tensor in (view, view.contiguous()):
        geo = tma_geometry(tensor)
        assert geo is not None
        assert geo[0] == (d, t, h, b)
        assert all(s % 16 == 0 for s in geo[1])
        assert torch.equal(_rebuild(tensor, geo), tensor)
    # the transposed view: T steps over all heads, H over one head (a
    # single head gets the stride a contiguous tensor would have)
    assert tma_geometry(view)[1][0] == h * d * 2
    assert tma_geometry(view)[1][1] == (d * 2 if h > 1 else t * d * 2)


def test_tma_geometry_refuses_what_tma_cannot_read():
    """A base off 16 bytes, a stride off 16 bytes or a non-contiguous last
    dim: the wrapper copies such a tensor to a contiguous one."""
    x = torch.zeros(2, 4, 64, 130, dtype=torch.bfloat16)
    assert tma_geometry(x[..., 1:65]) is None          # base + 2 bytes
    assert tma_geometry(x[..., :64]) is None           # T stride 260 B
    y = torch.zeros(2, 4, 64, 128, dtype=torch.bfloat16)
    assert tma_geometry(y.transpose(2, 3)) is None     # D not contiguous
    assert tma_geometry(y) is not None
    assert tma_geometry(x[..., :64].contiguous()) is not None


def _outer_inputs(dist, c, m, seed):
    """The sweep of ``tests/test_kernels_extra.py``: 64 nodes in blocks
    of 8, 900 real edges (none for ``empty``) padded to 128-edge tiles
    with ``dst = n_nodes``."""
    rng = np.random.default_rng(seed)
    n, bn, te = 64, 8, 128
    e_real = 0 if dist == "empty" else 900
    if dist == "uniform":
        dst = np.sort(rng.integers(0, n, e_real))
    elif dist == "powerlaw":
        dst = np.sort((n * rng.random(e_real) ** 3).astype(np.int64))
    elif dist == "one_block":
        dst = np.sort(rng.integers(0, bn, e_real))
    else:
        dst = np.zeros(0, np.int64)
    e = max(te, -(-max(e_real, 1) // te) * te)
    msg = rng.standard_normal((e, c)).astype(np.float32)
    basis = rng.standard_normal((e, m)).astype(np.float32)
    dstp = np.full(e, n, np.int32)
    dstp[:e_real] = dst
    msg[e_real:] = 0
    basis[e_real:] = 0
    return msg, basis, dstp, n, bn, te


#: segment-outer input types: one type for both, or msg*basis
OUTER_NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16,
            "float16": np.float16, "float64": np.float64, "int32": np.int32}
OUTER_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "float16": torch.float16, "float64": torch.float64,
               "int32": torch.int32}


def _outer_typed(msg, basis, types):
    """msg and basis rounded to the pair ``types`` ("bfloat16" or
    "bfloat16*float32") once, as numpy arrays for JAX and as tensors."""
    tm, tb = (types.split("*") * 2)[:2]
    arrs = (msg.astype(OUTER_NP[tm]), basis.astype(OUTER_NP[tb]))
    tens = tuple(torch.from_numpy(a.astype(np.float64)).to(OUTER_TORCH[t])
                 for a, t in zip(arrs, (tm, tb)))
    return arrs, tens


@pytest.mark.parametrize("types", ["float32", "bfloat16", "float16",
                                   "bfloat16*float32"])
@pytest.mark.parametrize("dist", ["uniform", "powerlaw", "one_block",
                                  "empty"])
@pytest.mark.parametrize("c,m", [(32, 16), (64, 8)])
def test_segment_outer_plain_matches_pallas_and_ref(dist, c, m, types):
    """In every input type the JAX function takes for MACE (bf16 and f16
    products rounded to the type, then summed in float32; mixed bf16 x
    f32 promoted to f32), at the JAX package's 2e-4."""
    msg, basis, dstp, n, bn, te = _outer_inputs(dist, c, m, seed=1)
    (nm, nb), (tm, tb) = _outer_typed(msg, basis, types)
    bt, n_tiles = block_tile_starts(dstp, n, bn, te)
    got = ops.segment_outer(tm, tb, torch.from_numpy(dstp), bt, n, n_tiles,
                            bn, te)
    assert got.shape == (n, c, m) and got.dtype == torch.float32
    jm, jb, jd = jnp.asarray(nm), jnp.asarray(nb), jnp.asarray(dstp)
    wants = [segment_outer_pallas(jm, jb, jd, bt, n_nodes=n, n_tiles=n_tiles,
                                  bn=bn, te=te)]
    if jnp.result_type(jm, jb) == jnp.float32:  # the jnp oracle sums in it
        wants.append(j_outer_ref(jm, jb, jd, n))
    for want in wants:
        assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)
    if dist == "empty":
        assert not got.any()


@pytest.mark.parametrize("types", ["float32", "bfloat16"])
@pytest.mark.parametrize("dist", ["uniform", "powerlaw"])
def test_segment_outer_plain_matches_pallas_at_c128_m64(dist, types):
    """C*M = 128 x 64, which the card's kernel refused before its
    redesign (a node block's (bn, C*M) sums did not fit in shared
    memory), against the Pallas kernel at 2e-4."""
    msg, basis, dstp, n, bn, te = _outer_inputs(dist, 128, 64, seed=5)
    (nm, nb), (tm, tb) = _outer_typed(msg, basis, types)
    bt, n_tiles = block_tile_starts(dstp, n, bn, te)
    got = ops.segment_outer(tm, tb, torch.from_numpy(dstp), bt, n, n_tiles,
                            bn, te)
    want = segment_outer_pallas(jnp.asarray(nm), jnp.asarray(nb),
                                jnp.asarray(dstp), bt, n_nodes=n,
                                n_tiles=n_tiles, bn=bn, te=te)
    assert got.shape == (n, 128, 64)
    assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("types,want", [
    ("float32", "float32"), ("bfloat16", "bfloat16"), ("float16", "float16"),
    ("bfloat16*float32", "float32"), ("float32*bfloat16", "float32"),
    ("float16*float32", "float32"), ("bfloat16*float16", "float32"),
    ("float64*float32", "float32"), ("int32", "float32")])
def test_segment_outer_promotes_as_jax(types, want):
    """The wrapper runs the pair in JAX's promotion of it where that is a
    type the kernel takes (f32, bf16, f16), else in float32."""
    (nm, nb), (tm, tb) = _outer_typed(np.ones((8, 3), np.float32),
                                      np.ones((8, 2), np.float32), types)
    pm, pb = promote(tm, tb)
    assert pm.dtype == pb.dtype == OUTER_TORCH[want]
    jax_type = str(jnp.result_type(jnp.asarray(nm), jnp.asarray(nb)))
    if jax_type in ("float32", "bfloat16", "float16"):
        assert jax_type == want


@pytest.mark.parametrize("types", ["int32", "float64", "int32*float32"])
def test_segment_outer_plain_path_runs_the_kernels_types(types):
    """The router promotes before it routes, so the plain path forms the
    products in the type the card's kernel runs (float32 for integers
    and float64), and the two paths agree: here integer products above
    2^24, which int32 and float32 products round differently."""
    e, n, bn, te = 128, 16, 8, 64
    rng = np.random.default_rng(7)
    dstp = np.sort(rng.integers(0, n, e)).astype(np.int32)
    msg = rng.integers(4000, 9000, (e, 3)).astype(np.float64)
    basis = rng.integers(4000, 9000, (e, 5)).astype(np.float64)
    _, (tm, tb) = _outer_typed(msg, basis, types)
    bt, n_tiles = block_tile_starts(dstp, n, bn, te)
    dst = torch.from_numpy(dstp)
    got = ops.segment_outer(tm, tb, dst, bt, n, n_tiles, bn, te)
    pm, pb = promote(tm, tb)
    assert pm.dtype == pb.dtype == torch.float32
    assert torch.equal(got, ref.segment_outer_ref(pm, pb, dst, n))


@pytest.mark.parametrize("m,width,passes", [(9, 9, 1), (5, 5, 1),
                                            (16, 8, 2), (20, 8, 3)])
def test_pass_basis_lays_out_a_column_pass_at_a_time(m, width, passes):
    """Where M takes more than one column pass, the kernel reads basis
    as (passes, E, width), the columns past M zero; else as it is."""
    basis = torch.arange(6 * m, dtype=torch.float32).reshape(6, m)
    got = pass_basis(basis, width)
    if passes == 1:
        assert got is basis
        return
    assert got.shape == (passes, 6, width) and got.is_contiguous()
    for p in range(passes):
        cols = basis[:, p * width:(p + 1) * width]
        assert torch.equal(got[p, :, :cols.shape[1]], cols)
        assert not got[p, :, cols.shape[1]:].any()


@pytest.mark.parametrize("types", ["float32", "bfloat16", "float16",
                                   "bfloat16*float32", "float16*bfloat16",
                                   "float64*float32", "int32"])
@pytest.mark.parametrize("e,n", [(128, 16), (130, 16), (128, 12)])
def test_segment_outer_cuda_raises_only_where_jax_asserts(types, e, n):
    """At C 3 and M 5 (off the kernel's vector width) in every input
    type: the JAX function asserts E % te == 0 and n_nodes % bn == 0 and
    nothing else; the card's wrapper raises on exactly those, and
    otherwise gets as far as asking for a CUDA tensor (it takes any
    block_tile0: the kernel does not read it)."""
    bn, te = 8, 64
    rng = np.random.default_rng(6)
    dstp = np.sort(rng.integers(0, n, e)).astype(np.int32)
    (nm, nb), (tm, tb) = _outer_typed(
        rng.standard_normal((e, 3)).astype(np.float32),
        rng.standard_normal((e, 5)).astype(np.float32), types)
    ok = e % te == 0 and n % bn == 0
    bt = np.zeros(-(-n // bn), np.int32)
    args = (jnp.asarray(nm), jnp.asarray(nb), jnp.asarray(dstp), bt)
    if ok:
        bt, n_tiles = block_tile_starts(dstp, n, bn, te)
        out = segment_outer_pallas(*args[:3], bt, n_nodes=n, n_tiles=n_tiles,
                                   bn=bn, te=te)
        assert out.shape == (n, 3, 5) and out.dtype == jnp.float32
    else:
        with pytest.raises(AssertionError, match="pad"):
            segment_outer_pallas(*args, n_nodes=n, n_tiles=1, bn=bn, te=te)
    with pytest.raises(ValueError, match="CUDA device" if ok else "pad"):
        segment_outer_cuda(tm, tb, torch.from_numpy(dstp), bt[:1], n, 1, bn,
                           te)


@pytest.mark.parametrize("dtype,c,want", [
    (torch.float32, 128, 128), (torch.float32, 3, 4), (torch.float32, 300,
                                                       300),
    (torch.bfloat16, 128, 128), (torch.bfloat16, 3, 8),
    (torch.float16, 9, 16)])
def test_segment_outer_pads_channels_to_16_bytes(dtype, c, want):
    assert padded_channels(c, dtype) == want


def test_c_signatures_of_the_segment_outer_product():
    """The launch takes the dtype code (an int) and the output's, the
    partial rows', the node marks' and the stream's pointers last; the
    plan takes the dtype code and writes through a pointer; each declared
    so in ctypes."""
    text = (build.CSRC / "segment_outer.cu").read_text()

    def params(fn):
        found = re.search(rf'extern "C" int {fn}\(([^)]*)\)', text).group(1)
        return [x.split()[-1].lstrip("*") for x in found.split(",")]

    names = params("segment_outer_launch")
    assert names[10:] == ["dtype", "out", "partial", "seen", "stream"]
    sig = build.SIGNATURES["segment_outer_launch"]
    assert len(sig) == len(names) and sig[10] is ctypes.c_int
    assert all(t is ctypes.c_void_p for t in sig[:3] + sig[11:])
    names = params("segment_outer_plan")
    assert names == ["e", "cp", "m", "dtype", "out"]
    sig = build.SIGNATURES["segment_outer_plan"]
    assert sig[3] is ctypes.c_int and sig[4] is ctypes.c_void_p


def test_segment_outer_plain_in_chunks():
    """The plain version forms the products a chunk of edges at a time
    (on the card the whole (E, C, M) product would not fit); the chunk
    size does not change the sums beyond float64 rounding."""
    msg, basis, dstp, n, _, _ = _outer_inputs("powerlaw", 32, 16, seed=2)
    args = (torch.from_numpy(msg), torch.from_numpy(basis),
            torch.from_numpy(dstp), n)
    whole = ref.segment_outer_ref(*args)
    for chunk_bytes in (8 * 32 * 16, 8 * 32 * 16 * 100):
        assert_allclose(ref.segment_outer_ref(*args, chunk_bytes=chunk_bytes)
                        .numpy(), whole.numpy(), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("e,n,bn,te", [(300, 64, 8, 128), (256, 60, 8, 128)])
def test_segment_outer_shape_contract(e, n, bn, te):
    """E % te and n_nodes % bn are asserted by the JAX function; the port
    raises on both paths."""
    msg, basis = torch.zeros((e, 4)), torch.zeros((e, 2))
    dst = torch.full((e,), n, dtype=torch.int32)
    bt = np.zeros(max(1, n // bn), np.int32)
    with pytest.raises(ValueError, match="pad"):
        ops.segment_outer(msg, basis, dst, bt, n, 1, bn, te)
    with pytest.raises(ValueError, match="pad"):
        segment_outer_cuda(msg, basis, dst, bt, n, 1, bn, te)
    with pytest.raises(AssertionError, match="pad"):
        segment_outer_pallas(jnp.zeros((e, 4)), jnp.zeros((e, 2)),
                             jnp.full((e,), n, jnp.int32), bt, n_nodes=n,
                             n_tiles=1, bn=bn, te=te)


@pytest.mark.parametrize("dist", ["uniform", "powerlaw", "one_block",
                                  "empty"])
@pytest.mark.parametrize("bn,te", [(8, 128), (4, 64), (16, 32)])
def test_block_tile_starts_matches_reference(dist, bn, te):
    _, _, dstp, n, _, _ = _outer_inputs(dist, 4, 2, seed=3)
    got_t0, got_n = block_tile_starts(dstp, n, bn, te)
    want_t0, want_n = j_tile_starts(dstp, n, bn, te)
    np.testing.assert_array_equal(got_t0, want_t0)
    assert got_t0.dtype == want_t0.dtype and got_n == want_n


def test_new_kernels_route_cpu_tensors_to_plain_versions():
    build.reset_launches()
    (_, (q, k, v)) = _both(_qkv(4, 1, 4, 2, 16, 16, 8, "float32"), "float32")
    assert torch.equal(ops.flash_attention(q, k, v),
                       ref.flash_attention_ref(q, k, v))
    msg, basis, dstp, n, bn, te = _outer_inputs("uniform", 8, 4, seed=4)
    bt, n_tiles = block_tile_starts(dstp, n, bn, te)
    args = (torch.from_numpy(msg), torch.from_numpy(basis),
            torch.from_numpy(dstp))
    assert torch.equal(ops.segment_outer(*args, bt, n, n_tiles, bn, te),
                       ref.segment_outer_ref(*args, n))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        segment_outer_cuda(*args, bt, n, n_tiles, bn, te)
    assert build.LAUNCHES["flash_attention_tc"] == 0
    assert build.LAUNCHES["flash_attention_mma"] == 0
    assert build.LAUNCHES["segment_outer"] == 0
