"""The port's kernels on the CPU: plain PyTorch versions vs the Pallas
kernels (interpret mode) and the jnp references, exactly.

The CUDA kernels themselves cannot run here (no card, no nvcc); they are
held against these same plain versions on the card by ``chip_smoke.py``.
What the CPU can check of them is checked here: the router sends CPU
tensors to the plain versions without launching anything, the CUDA
wrappers refuse CPU tensors, and the ctypes signatures match the C entry
points in ``csrc/``.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (x64 for the reference)
from repro.kernels.intersect_bitset import bitset_member_count_pallas
from repro.kernels.ref import (bitset_member_count_ref as j_count_ref,
                               bitset_member_ref as j_member_ref,
                               searchsorted_segments_ref as j_ss_ref)
from repro.kernels.searchsorted import searchsorted_segments_pallas

from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.intersect_bitset import (bitset_member_count_cuda,
                                                  bitset_member_mask_cuda)
from repro_torch.kernels.searchsorted import searchsorted_segments_cuda


def _segments(rng, n_seg, max_len, domain, empty_every):
    """Sorted segments (some empty) concatenated, duplicates across
    segments; returns (values, starts, ends)."""
    segs = []
    for i in range(n_seg):
        k = 0 if i % empty_every == 0 else int(rng.integers(1, max_len + 1))
        segs.append(np.sort(rng.choice(domain, size=min(k, domain),
                                       replace=False)))
    lens = np.array([len(s) for s in segs])
    ends = np.cumsum(lens)
    values = np.concatenate(segs + [np.zeros(1, np.int64)]).astype(np.int32)
    return values, ends - lens, ends


@pytest.mark.parametrize("r,w,max_len,empty_every", [
    (8, 128, 5, 3), (16, 128, 40, 4), (32, 256, 200, 5), (8, 256, 1, 2)])
def test_searchsorted_segments_plain_matches_pallas(r, w, max_len,
                                                    empty_every):
    rng = np.random.default_rng(r * 1000 + w + max_len)
    domain = 300
    values, starts, ends = _segments(rng, 40, max_len, domain, empty_every)
    seg = rng.integers(0, 40, r)
    lo = starts[seg].astype(np.int32)[:, None]
    hi = ends[seg].astype(np.int32)[:, None]
    # queries below, inside and above every segment's range
    q = rng.integers(-5, domain + 5, (r, w)).astype(np.int32)
    n_iter = int(np.ceil(np.log2(max(2, max_len)))) + 1
    pos_t, found_t = ref.searchsorted_segments_ref(
        torch.from_numpy(values), torch.from_numpy(lo), torch.from_numpy(hi),
        torch.from_numpy(q), n_iter)
    pos_p, found_p = searchsorted_segments_pallas(
        jnp.asarray(values), jnp.asarray(lo), jnp.asarray(hi),
        jnp.asarray(q), n_iter=n_iter, interpret=True)
    pos_r, found_r = j_ss_ref(jnp.asarray(values), jnp.asarray(lo),
                              jnp.asarray(hi), jnp.asarray(q), n_iter=n_iter)
    for pos, found in ((pos_p, found_p), (pos_r, found_r)):
        np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos))
        np.testing.assert_array_equal(found_t.numpy(), np.asarray(found))
    # found is exact membership in the segment
    want = np.array([[q[i, j] in values[lo[i, 0]:hi[i, 0]] for j in range(w)]
                     for i in range(r)])
    np.testing.assert_array_equal(found_t.numpy(), want)


def test_searchsorted_segments_per_lane_bounds():
    """(R, W) bounds give the same answer as the broadcast (R, 1) ones."""
    rng = np.random.default_rng(7)
    values, starts, ends = _segments(rng, 10, 30, 100, 4)
    seg = rng.integers(0, 10, 8)
    lo = torch.from_numpy(starts[seg].astype(np.int32))[:, None]
    hi = torch.from_numpy(ends[seg].astype(np.int32))[:, None]
    q = torch.from_numpy(rng.integers(0, 100, (8, 16)).astype(np.int32))
    v = torch.from_numpy(values)
    a = ref.searchsorted_segments_ref(v, lo, hi, q, 6)
    b = ref.searchsorted_segments_ref(v, lo.expand(8, 16).contiguous(),
                                      hi.expand(8, 16).contiguous(), q, 6)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _pack(sets, n_words):
    words = np.zeros((len(sets), n_words), dtype=np.uint32)
    for i, s in enumerate(sets):
        s = np.asarray(s, dtype=np.int64)
        np.bitwise_or.at(words[i], s >> 5,
                         np.uint32(1) << (s & 31).astype(np.uint32))
    return words


def _rand_sets(rng, rows, domain, max_size):
    return [np.unique(rng.integers(0, domain,
                                   int(rng.integers(0, max_size + 1))))
            for _ in range(rows)]


def _i32(words):
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


@pytest.mark.parametrize("seed,rows", [(0, 8), (1, 16), (2, 32)])
def test_bitset_member_count_plain_matches_pallas(seed, rows):
    rng = np.random.default_rng(seed)
    n_words, lb = 64, 256
    domain = 32 * n_words
    w_sets = _rand_sets(rng, rows, domain, 500)
    b_sets = _rand_sets(rng, rows, domain, lb)
    words = _pack(w_sets, n_words)
    words[:, -1] |= np.uint32(1 << 31)     # the sign bit of the int32 view
    b = np.zeros((rows, lb), dtype=np.int32)
    b_len = np.zeros(rows, dtype=np.int32)
    for i, s in enumerate(b_sets):
        b[i, :len(s)] = s
        b_len[i] = len(s)
        b[i, len(s):] = 7  # poison the padding: must be masked out
    got = ref.bitset_member_count_ref(_i32(words), torch.from_numpy(b),
                                      torch.from_numpy(b_len))
    want_p = bitset_member_count_pallas(jnp.asarray(words), jnp.asarray(b),
                                        jnp.asarray(b_len), interpret=True)
    want_r = j_count_ref(jnp.asarray(words), jnp.asarray(b),
                         jnp.asarray(b_len))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_r))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bitset_member_mask_plain_matches_reference(seed):
    rng = np.random.default_rng(seed)
    h, n_words, r, w = 12, 16, 24, 64
    words = rng.integers(0, 1 << 32, (h, n_words),
                         dtype=np.uint64).astype(np.uint32)
    row = rng.integers(0, h, r).astype(np.int32)
    cand = rng.integers(0, 32 * n_words, (r, w)).astype(np.int32)
    got = ref.bitset_member_mask_ref(_i32(words), torch.from_numpy(row),
                                     torch.from_numpy(cand))
    want = j_member_ref(jnp.asarray(words[row]), jnp.asarray(cand))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # out-of-range rows and words clamp to the last one, as JAX gathers do
    big_row = torch.full((r,), h + 5, dtype=torch.int32)
    big_cand = torch.full((r, w), 32 * n_words + 40, dtype=torch.int32)
    got = ref.bitset_member_mask_ref(_i32(words), big_row, big_cand)
    jw = jnp.asarray(words)
    want = ((jw[jnp.asarray(big_row.numpy())[:, None],
                jnp.asarray(big_cand.numpy()) >> 5]
             >> (jnp.asarray(big_cand.numpy()) & 31).astype(jnp.uint32))
            & 1) != 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ops_route_cpu_tensors_to_plain_versions():
    build.reset_launches()
    rng = np.random.default_rng(4)
    values, starts, ends = _segments(rng, 10, 20, 100, 3)
    v = torch.from_numpy(values)
    lo = torch.from_numpy(starts[:8].astype(np.int32))[:, None]
    hi = torch.from_numpy(ends[:8].astype(np.int32))[:, None]
    q = torch.from_numpy(rng.integers(0, 100, (8, 32)).astype(np.int32))
    got = ops.searchsorted_segments(v, lo, hi, q, 6)
    want = ref.searchsorted_segments_ref(v, lo, hi, q, 6)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    words = _i32(_pack(_rand_sets(rng, 8, 128, 40), 4))
    row = torch.arange(8, dtype=torch.int32)
    cand = torch.from_numpy(rng.integers(0, 128, (8, 32)).astype(np.int32))
    assert torch.equal(ops.bitset_member_mask(words, row, cand),
                       ref.bitset_member_mask_ref(words, row, cand))
    blen = torch.full((8,), 20, dtype=torch.int32)
    assert torch.equal(ops.bitset_member_count(words, cand, blen),
                       ref.bitset_member_count_ref(words, cand, blen))
    assert build.LAUNCHES == {"searchsorted_segments": 0,
                              "bitset_member_mask": 0,
                              "bitset_member_count": 0}


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: it never computes on the
    CPU itself, and the router is the only way to the plain versions."""
    build.reset_launches()
    i32 = dict(dtype=torch.int32)
    v, q = torch.zeros(4, **i32), torch.zeros((2, 8), **i32)
    lo = torch.zeros((2, 1), **i32)
    with pytest.raises(ValueError, match="CUDA"):
        searchsorted_segments_cuda(v, lo, lo, q, 3)
    words = torch.zeros((2, 4), **i32)
    with pytest.raises(ValueError, match="CUDA"):
        bitset_member_mask_cuda(words, torch.zeros(2, **i32), q)
    with pytest.raises(ValueError, match="CUDA"):
        bitset_member_count_cuda(words, q, torch.zeros(2, **i32))
    with pytest.raises(ValueError, match="no kernel"):
        ops.searchsorted_segments(v.to("meta"), lo, lo, q, 3)
    assert not any(build.LAUNCHES.values())


def test_ctypes_signatures_match_c_entry_points():
    """Each C entry point in csrc/ is declared with as many ctypes
    arguments as it has parameters (a missing c_void_p would cut a
    pointer to 32 bits on the card)."""
    found = {}
    for src in build.sources():
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            found[m.group(1)] = len(m.group(2).split(","))
    assert {p.name for p in build.sources()} == {"searchsorted.cu",
                                                  "bitset_member.cu"}
    assert found == {k: len(v) for k, v in build.SIGNATURES.items()}
