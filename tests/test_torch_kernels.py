"""The port's kernels on the CPU: plain PyTorch versions vs the Pallas
kernels (interpret mode) and the jnp references, exactly.

The CUDA kernels themselves cannot run here (no card, no nvcc); they are
held against these same plain versions on the card by ``chip_smoke.py``.
What the CPU can check of them is checked here: the router sends CPU
tensors to the plain versions without launching anything, the CUDA
wrappers refuse CPU tensors, and the ctypes signatures match the C entry
points in ``csrc/``.
"""
import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (x64 for the reference)
from repro.core.vlftj import _expand_level as j_expand_level
from repro.kernels.intersect import intersect_count_pallas
from repro.kernels.intersect_bitset import (bitset_intersect_count_pallas,
                                            bitset_member_count_pallas)
from repro.kernels.ref import (bitset_intersect_count_ref as j_and_ref,
                               bitset_member_count_ref as j_count_ref,
                               bitset_member_ref as j_member_ref,
                               intersect_count_ref as j_icount_ref,
                               popcount32 as j_popcount32,
                               searchsorted_segments_2level_ref as j_ss2_ref,
                               searchsorted_segments_ref as j_ss_ref)
from repro.kernels.searchsorted import searchsorted_segments_pallas

from repro_torch.core.vlftj import _expand_level as t_expand_level
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.intersect import (intersect_count_cuda,
                                           tile_member_mask_cuda)
from repro_torch.kernels.intersect_bitset import (bitset_intersect_count_cuda,
                                                  bitset_member_count_cuda,
                                                  bitset_member_mask_cuda)
from repro_torch.kernels.searchsorted import searchsorted_segments_cuda


# the port's CPU tensors here are small: one intra-op thread per test
# process keeps parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


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


def _edge_case(case, rng):
    """Inputs on which the card's kernel leaves its shared-memory path
    (the ``chip_smoke.py`` searchsorted edge cases, at CPU size):
    ``values``, ``lo``, ``hi``, ``queries``, ``n_iter``."""
    values, starts, ends = _segments(rng, 12, 60, 500, 5)
    m = values.shape[0]
    seg = rng.integers(0, 12, 16)
    lo = starts[seg].astype(np.int32)[:, None]
    hi = ends[seg].astype(np.int32)[:, None]
    q = rng.integers(-5, 505, (16, 64)).astype(np.int32)
    if case.startswith("above capacity"):
        # one sorted segment of 20,000 values, past the 8,192 the kernel
        # stages; with 6 rounds the search stops before it closes
        long_v = np.sort(rng.integers(0, 1 << 20, 20000)).astype(np.int32)
        n_iter = 16 if case == "above capacity" else 6
        return (long_v, np.zeros((4, 1), np.int32),
                np.full((4, 1), 20000, np.int32),
                rng.integers(0, 1 << 20, (4, 128)).astype(np.int32), n_iter)
    if case == "lo > hi":
        lo[::3] = hi[::3] + 5
    elif case == "lo < 0, hi > M":
        lo[::4] = -7
        hi[1::4] = m + 100
        hi[2::4] = m
    elif case == "per-lane bounds":
        lo = (lo + rng.integers(0, 3, q.shape)).astype(np.int32)
        hi = np.maximum(lo, hi - rng.integers(0, 3, q.shape)).astype(
            np.int32)
    elif case.startswith("W "):
        q = np.ascontiguousarray(q[:, :int(case[2:])])
    return values, lo, hi, q, 7


@pytest.mark.parametrize("case", [
    "above capacity", "above capacity, 6 rounds", "lo > hi",
    "lo < 0, hi > M", "per-lane bounds", "W 1", "W 3", "W 8"])
def test_searchsorted_segments_edge_cases_match_reference(case):
    """The plain version, which ``chip_smoke.py`` holds the kernel against
    on these inputs, agrees exactly with the JAX package's reference."""
    values, lo, hi, q, n_iter = _edge_case(case, np.random.default_rng(11))
    pos_t, found_t = ref.searchsorted_segments_ref(
        *map(torch.from_numpy, (values, lo, hi, q)), n_iter)
    pos_r, found_r = j_ss_ref(*map(jnp.asarray, (values, lo, hi, q)),
                              n_iter=n_iter)
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_r))
    np.testing.assert_array_equal(found_t.numpy(), np.asarray(found_r))


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


@pytest.mark.parametrize("case", ["random", "zero", "negative", "above W",
                                  "equal W"])
def test_bitset_member_mask_lane_len_matches_reference(case):
    """``lane_len`` clamped to [0, W]: lanes below it are the JAX
    reference's member test, lanes at or past it false, including
    ``lane_len`` of 0, negative and above W.  Rows and candidates out of
    range (negative, past H, past NW x 32) take the mask's clamps, row to
    [0, H-1] and ``cand >> 5`` to [0, NW-1], on live lanes only."""
    rng = np.random.default_rng(5)
    h, n_words, r, w = 12, 16, 24, 64
    words = rng.integers(0, 1 << 32, (h, n_words),
                         dtype=np.uint64).astype(np.uint32)
    row = rng.integers(0, h, r).astype(np.int32)
    cand = rng.integers(0, 32 * n_words, (r, w)).astype(np.int32)
    lane_len = {"random": rng.integers(-5, w + 6, r),
                "zero": np.zeros(r), "negative": np.full(r, -7),
                "above W": np.full(r, w + 9),
                "equal W": np.full(r, w)}[case].astype(np.int32)
    live = np.arange(w)[None, :] < np.clip(lane_len, 0, w)[:, None]
    got = ref.bitset_member_mask_ref(_i32(words), torch.from_numpy(row),
                                     torch.from_numpy(cand),
                                     torch.from_numpy(lane_len)).numpy()
    want = np.asarray(j_member_ref(jnp.asarray(words[row]),
                                   jnp.asarray(cand)))
    np.testing.assert_array_equal(got, want & live)
    # out of range: rows -2 and H + 1, candidates negative and past NW x 32
    row[::3], row[1::3] = -2, h + 1
    cand[:, ::3] = -cand[:, ::3] - 1
    cand[:, 1::3] += 32 * n_words
    got = ref.bitset_member_mask_ref(_i32(words), torch.from_numpy(row),
                                     torch.from_numpy(cand),
                                     torch.from_numpy(lane_len)).numpy()
    wv = words[np.clip(row, 0, h - 1)[:, None],
               np.clip(cand >> 5, 0, n_words - 1)]
    want = ((wv >> (cand & 31).astype(np.uint32)) & 1) != 0
    np.testing.assert_array_equal(got, want & live)
    every = ref.bitset_member_mask_ref(_i32(words), torch.from_numpy(row),
                                       torch.from_numpy(cand)).numpy()
    np.testing.assert_array_equal(every, want)


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
    lanes = torch.arange(8, dtype=torch.int32) * 5 - 3
    assert torch.equal(ops.bitset_member_mask(words, row, cand, lanes),
                       ref.bitset_member_mask_ref(words, row, cand, lanes))
    blen = torch.full((8,), 20, dtype=torch.int32)
    assert torch.equal(ops.bitset_member_count(words, cand, blen),
                       ref.bitset_member_count_ref(words, cand, blen))
    summary = v[::4].contiguous()
    got = ops.searchsorted_segments_2level(v, summary, lo, hi, q, stride=4,
                                           n1=4, n2=5)
    want = ref.searchsorted_segments_2level_ref(v, summary, lo, hi, q, 4, 4,
                                                5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(ops.tile_member_mask(v, lo, hi, q, 8),
                       ref.tile_member_mask_ref(v, lo, hi, q, 8))
    lanes = torch.arange(8, dtype=torch.int32) * 5
    assert torch.equal(ops.tile_member_mask(v, lo, hi, q, 8, lanes),
                       ref.tile_member_mask_ref(v, lo, hi, q, 8, lanes))
    qs = torch.sort(q, dim=1).values
    alen = torch.full((8,), 30, dtype=torch.int32)
    assert torch.equal(ops.intersect_count(qs, alen, cand, blen),
                       ref.intersect_count_ref(qs, alen, cand, blen))
    assert torch.equal(ops.bitset_intersect_count(words, words.flip(0)),
                       ref.bitset_intersect_count_ref(words, words.flip(0)))
    assert set(build.LAUNCHES) == {
        "searchsorted_segments", "bitset_member_mask", "bitset_member_count",
        "tile_member_mask", "intersect_count", "bitset_intersect_count",
        "flash_attention_tc", "flash_attention_mma", "flash_attention_bwd",
        "flash_attention_bwd_tc", "segment_outer"}
    assert not any(build.LAUNCHES.values())


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
        bitset_member_mask_cuda(words, torch.zeros(2, **i32), q,
                                torch.zeros(2, **i32))
    with pytest.raises(ValueError, match="CUDA"):
        bitset_member_count_cuda(words, q, torch.zeros(2, **i32))
    with pytest.raises(ValueError, match="CUDA"):
        tile_member_mask_cuda(v, lo, lo, q, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tile_member_mask_cuda(v, lo, lo, q, 4, lo[:, 0].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        intersect_count_cuda(q, lo[:, 0], q, lo[:, 0])
    with pytest.raises(ValueError, match="CUDA"):
        bitset_intersect_count_cuda(words, words)
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
    assert {p.name for p in build.sources()} == {
        "searchsorted.cu", "bitset_member.cu", "intersect.cu",
        "bitset_intersect.cu", "flash_attention.cu", "flash_attention_tc.cu",
        "flash_attention_bwd.cu", "flash_attention_bwd_tc.cu",
        "segment_outer.cu"}
    assert found == {k: len(v) for k, v in build.SIGNATURES.items()}
    # the mask form takes the per-row valid-lane count (a pointer, null
    # for every lane) after the candidates
    text = (build.CSRC / "intersect.cu").read_text()
    params = re.search(r'extern "C" int tile_member_mask_launch\(([^)]*)\)',
                       text).group(1).split(",")
    names = [x.split()[-1].lstrip("*") for x in params]
    assert names[4:6] == ["cand", "lane_len"]
    assert build.SIGNATURES["tile_member_mask_launch"][5] is ctypes.c_void_p


def _c_params(src: str, fn: str) -> list:
    text = (build.CSRC / src).read_text()
    params = re.search(rf'extern "C" int {fn}\(([^)]*)\)', text).group(1)
    return [x.split()[-1].lstrip("*") for x in params.split(",")]


def test_c_signatures_of_the_bitset_mask_and_the_mma_flash_kernel():
    """The bitset mask takes ``lane_len`` (a pointer, null for every lane)
    after the candidates, and the mma.sync flash kernel the staging copy
    width (an int) after the dtype and its ``lse`` (a pointer, null in
    serving) after ``o``, each declared so in ctypes."""
    names = _c_params("bitset_member.cu", "bitset_member_mask_launch")
    assert names[4:6] == ["cand", "lane_len"]
    sig = build.SIGNATURES["bitset_member_mask_launch"]
    assert sig[5] is ctypes.c_void_p and len(sig) == len(names)
    names = _c_params("flash_attention.cu", "flash_attention_launch")
    assert names[-3:] == ["dtype", "vec", "stream"]
    assert names[3:5] == ["o", "lse"]
    sig = build.SIGNATURES["flash_attention_launch"]
    assert sig[-2] is ctypes.c_int and sig[-1] is ctypes.c_void_p
    assert sig[:5] == (ctypes.c_void_p,) * 5 and sig[5] is ctypes.c_int64
    assert len(sig) == len(names)


# --- tile intersection (intersect_count_pallas and the tile check) -------

def _sorted_rows(rng, r, width, max_len, domain):
    lens = rng.integers(0, max_len + 1, r)
    arr = np.zeros((r, width), np.int32)
    for i in range(r):
        arr[i, :lens[i]] = np.sort(rng.choice(domain, size=lens[i],
                                              replace=False))
    return arr, lens.astype(np.int32)


@pytest.mark.parametrize("r,la,lb", [(8, 128, 128), (16, 256, 384),
                                     (24, 512, 128)])
def test_intersect_count_plain_matches_pallas(r, la, lb):
    """The sweep of ``tests/test_kernels.py``: plain version vs the
    Pallas kernel (interpret mode), the jnp reference and numpy."""
    rng = np.random.default_rng(r * 7 + la + lb)
    a, alen = _sorted_rows(rng, r, la, la - 5, 4000)
    b, blen = _sorted_rows(rng, r, lb, lb - 5, 4000)
    got = ref.intersect_count_ref(*map(torch.from_numpy, (a, alen, b, blen)))
    want_p = intersect_count_pallas(*map(jnp.asarray, (a, alen, b, blen)))
    want_r = j_icount_ref(*map(jnp.asarray, (a, alen, b, blen)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_r))
    want = [np.intersect1d(a[i, :alen[i]], b[i, :blen[i]]).size
            for i in range(r)]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["disjoint", "half", "empty", "ragged"])
def test_intersect_count_edge_cases(case):
    """The gap-box skip cases of ``tests/test_kernels.py`` and shapes the
    Pallas kernel refuses (R % 8, L % 128), against the jnp reference."""
    a = np.tile(np.arange(512, dtype=np.int32), (8, 1))
    full = np.full(8, 512, np.int32)
    if case == "disjoint":
        b, alen, blen = a + 100000, full, full
    elif case == "half":
        b = np.sort(np.concatenate([a[:, :256] + 100000, a[:, :256]], 1), 1)
        alen, blen = full, full
    elif case == "empty":
        a, b = np.zeros((8, 128), np.int32), np.zeros((8, 128), np.int32)
        alen, blen = np.zeros(8, np.int32), np.full(8, 100, np.int32)
    else:
        rng = np.random.default_rng(5)
        a, alen = _sorted_rows(rng, 5, 37, 40, 90)   # a_len may exceed LA
        b, blen = _sorted_rows(rng, 5, 19, 19, 90)
        alen[0], blen[1] = -3, 0
    got = ref.intersect_count_ref(*map(torch.from_numpy, (a, alen, b, blen)))
    want = j_icount_ref(*map(jnp.asarray, (a, alen, b, blen)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if case in ("disjoint", "half", "empty"):
        want_p = intersect_count_pallas(*map(jnp.asarray,
                                             (a, alen, b, blen)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want_p))


def _tile_branch_jnp(indices, lo, hi, cand, check_width):
    """The reference's tile branch (``repro/core/vlftj.py``) verbatim."""
    m = indices.shape[0]
    j2 = jnp.arange(check_width, dtype=jnp.int32)
    seg_idx = lo + j2[None, :]
    seg = indices[jnp.clip(seg_idx, 0, max(0, m - 1))]
    seg_ok = seg_idx < hi
    eq = (cand[:, :, None] == seg[:, None, :])
    eq &= seg_ok[:, None, :]
    return eq.any(axis=2)


@pytest.mark.parametrize("check_width", [0, 1, 7, 32, 200])
def test_tile_member_mask_plain_matches_reference(check_width):
    """Including segments longer than ``check_width`` (truncated, as the
    reference truncates) and queries outside every segment."""
    rng = np.random.default_rng(check_width)
    values, starts, ends = _segments(rng, 30, 60, 150, 4)
    seg = rng.integers(0, 30, 24)
    lo = starts[seg].astype(np.int32)[:, None]
    hi = ends[seg].astype(np.int32)[:, None]
    cand = rng.integers(-5, 155, (24, 40)).astype(np.int32)
    got = ref.tile_member_mask_ref(*map(torch.from_numpy,
                                        (values, lo, hi, cand)), check_width)
    want = _tile_branch_jnp(*map(jnp.asarray, (values, lo, hi, cand)),
                            check_width)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # for sorted segments it is membership in the truncated prefix
    exact = np.array([[cand[i, j] in values[lo[i, 0]:min(
        hi[i, 0], lo[i, 0] + check_width)] for j in range(40)]
        for i in range(24)])
    np.testing.assert_array_equal(got.numpy(), exact)


@pytest.mark.parametrize("case", ["random", "zero", "full", "above",
                                  "negative"])
@pytest.mark.parametrize("check_width", [7, 60])
def test_tile_member_mask_lane_len_matches_reference(case, check_width):
    """``lane_len`` is the Pallas kernel's ``a_len``: the mask's row sums
    are the JAX package's ``intersect_count_ref`` of the candidates (A,
    valid to ``lane_len``) and the staged segments (B, valid to their
    staged length), and the mask is the all-lane mask ANDed with
    ``j < lane_len``.  Including ``lane_len`` 0, equal to W, above W and
    negative."""
    rng = np.random.default_rng(check_width * 10 + len(case))
    values, starts, ends = _segments(rng, 30, 60, 150, 4)
    r, w = 24, 40
    seg = rng.integers(0, 30, r)
    lo = starts[seg].astype(np.int32)[:, None]
    hi = ends[seg].astype(np.int32)[:, None]
    cand = rng.integers(-5, 155, (r, w)).astype(np.int32)
    lane_len = {"random": rng.integers(0, w + 1, r),
                "zero": np.zeros(r),
                "full": np.full(r, w),
                "above": np.full(r, w + 13),
                "negative": rng.integers(-4, 8, r)}[case].astype(np.int32)
    args = tuple(map(torch.from_numpy, (values, lo, hi, cand)))
    got = ref.tile_member_mask_ref(*args, check_width,
                                   torch.from_numpy(lane_len))
    every = ref.tile_member_mask_ref(*args, check_width)
    live = np.arange(w)[None, :] < lane_len[:, None]
    np.testing.assert_array_equal(got.numpy(), every.numpy() & live)
    # B: each row's staged prefix, padded past its length
    n = np.clip(hi[:, 0] - lo[:, 0], 0, check_width).astype(np.int32)
    idx = np.clip(lo + np.arange(check_width)[None, :], 0,
                  values.shape[0] - 1)
    b = np.where(np.arange(check_width)[None, :] < n[:, None], values[idx],
                 -1000).astype(np.int32)
    want = j_icount_ref(*map(jnp.asarray, (cand, lane_len, b, n)))
    np.testing.assert_array_equal(got.numpy().sum(axis=1), np.asarray(want))


def test_level_step_passes_probe_degrees_as_lane_len(monkeypatch):
    """In ``tile`` mode the level step gives the mask each row's probe
    degree as ``lane_len``, 0 for invalid rows; other modes give none."""
    from repro_torch.core import vlftj as t_vlftj
    seen = []

    def spy(indices, lo, hi, cand, check_width, lane_len=None):
        seen.append(lane_len.clone())
        return ref.tile_member_mask_ref(indices, lo, hi, cand, check_width,
                                        lane_len)

    monkeypatch.setattr(t_vlftj.kops, "tile_member_mask", spy)
    rng = np.random.default_rng(12)
    values, starts, ends = _segments(rng, 40, 50, 40, 6)
    indptr = np.concatenate([starts, ends[-1:]]).astype(np.int32)
    frontier = rng.integers(0, 40, (16, 3)).astype(np.int32)
    row_valid = np.arange(16) < 11
    t_expand_level(
        *map(torch.from_numpy, (indptr, values)), (),
        *map(torch.from_numpy, (frontier, np.ones(16, np.int64), row_valid)),
        probe_cols=(0, 2), n_unary=0, lower_cols=(), upper_cols=(), width=64,
        n_iter=7, needs_degree=False, check_mode="tile", check_width=64,
        count_only=True)
    deg = indptr[frontier + 1] - indptr[frontier]
    want = np.where(row_valid, np.minimum(deg[:, 0], deg[:, 2]), 0)
    assert len(seen) == 2
    for lane_len in seen:
        assert lane_len.dtype == torch.int32
        np.testing.assert_array_equal(lane_len.numpy(), want)


def _bitset_chunk(rng, n=40, rows=16):
    """A level-step chunk on a graph whose every vertex has a bitset row
    (its adjacency), except the last two (rep_tag -1), which only the
    invalid rows (the last five) name."""
    values, starts, ends = _segments(rng, n, 30, n, 6)
    indptr = np.concatenate([starts, ends[-1:]]).astype(np.int32)
    sets = [values[starts[i]:ends[i]] for i in range(n)]
    words = _pack(sets, (n + 31) // 32)
    rep_tag = np.arange(n, dtype=np.int32)
    rep_tag[-2:] = -1
    frontier = rng.integers(0, n - 2, (rows, 3)).astype(np.int32)
    frontier[-5:] = rng.integers(n - 2, n, (5, 3))
    row_valid = np.arange(rows) < rows - 5
    return indptr, values, words, rep_tag, frontier, row_valid


def test_level_step_bitset_matches_reference():
    """One level step in ``bitset`` mode (the port passes the probe
    degrees as ``lane_len``) against the JAX package's on the same chunk,
    invalid rows included: candidates, masks and weighted counts."""
    rng = np.random.default_rng(13)
    indptr, values, words, rep_tag, frontier, row_valid = _bitset_chunk(rng)
    mult = rng.integers(1, 5, frontier.shape[0]).astype(np.int64)
    bitmap = rng.random(40) < 0.7
    kw = dict(probe_cols=(0, 2), n_unary=1, lower_cols=(1,), upper_cols=(),
              width=64, n_iter=7, needs_degree=True, check_mode="bitset")
    j_args = tuple(map(jnp.asarray, (indptr, values))) + (
        (jnp.asarray(bitmap),),) + tuple(map(jnp.asarray,
                                             (frontier, mult, row_valid)))
    t_args = tuple(map(torch.from_numpy, (indptr, values))) + (
        (torch.from_numpy(bitmap),),) + tuple(map(torch.from_numpy,
                                                  (frontier, mult, row_valid)))
    for rotate in (False, True):
        for count_only in (False, True):
            want = j_expand_level(*j_args, count_only=count_only,
                                  rotate_checks=rotate,
                                  rep_tag=jnp.asarray(rep_tag),
                                  bitset_words=jnp.asarray(words), **kw)
            got = t_expand_level(*t_args, count_only=count_only,
                                 rotate_checks=rotate,
                                 rep_tag=torch.from_numpy(rep_tag),
                                 bitset_words=_i32(words), **kw)
            if count_only:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            else:
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_level_step_passes_probe_degrees_to_bitset_mask(monkeypatch):
    """In ``bitset`` mode the level step gives the mask each row's probe
    degree as ``lane_len``, 0 for invalid rows, as ``tile`` mode does."""
    from repro_torch.core import vlftj as t_vlftj
    seen = []

    def spy(words, row, cand, lane_len=None):
        seen.append(lane_len.clone())
        return ref.bitset_member_mask_ref(words, row, cand, lane_len)

    monkeypatch.setattr(t_vlftj.kops, "bitset_member_mask", spy)
    rng = np.random.default_rng(14)
    indptr, values, words, rep_tag, frontier, row_valid = _bitset_chunk(rng)
    n = frontier.shape[0]
    t_expand_level(
        *map(torch.from_numpy, (indptr, values)), (),
        *map(torch.from_numpy, (frontier, np.ones(n, np.int64), row_valid)),
        probe_cols=(0, 2), n_unary=0, lower_cols=(), upper_cols=(), width=64,
        n_iter=7, needs_degree=False, check_mode="bitset", count_only=True,
        rep_tag=torch.from_numpy(rep_tag), bitset_words=_i32(words))
    deg = indptr[frontier + 1] - indptr[frontier]
    want = np.where(row_valid, np.minimum(deg[:, 0], deg[:, 2]), 0)
    assert len(seen) == 2
    for lane_len in seen:
        assert lane_len.dtype == torch.int32
        np.testing.assert_array_equal(lane_len.numpy(), want)


@pytest.mark.parametrize("check_mode,check_width", [("tile", 16),
                                                    ("tile", 64),
                                                    ("tile", 4),
                                                    ("bsearch2", 0)])
def test_level_step_matches_reference(check_mode, check_width):
    """One full level step (probe choice, candidates, every check, unary
    and ``<`` filters) in the new check modes, both packages on the same
    chunk: candidates, masks and weighted counts.  ``tile`` at width 64
    holds every segment (the rows ``auto`` sends there), at 16 and 4 it
    truncates; the port's mask searches only the live lanes."""
    rng = np.random.default_rng(11)
    values, starts, ends = _segments(rng, 40, 50, 40, 6)
    indptr = np.concatenate([starts, ends[-1:]]).astype(np.int32)
    frontier = rng.integers(0, 40, (16, 3)).astype(np.int32)
    mult = rng.integers(1, 5, 16).astype(np.int64)
    row_valid = np.arange(16) < 13
    bitmap = rng.random(40) < 0.7
    stride = 4
    kw = dict(probe_cols=(0, 2), n_unary=1, lower_cols=(1,), upper_cols=(),
              width=64, n_iter=7, needs_degree=True, check_mode=check_mode,
              check_width=check_width, summary_stride=stride, n_iter2=5)
    if check_mode == "bsearch2":
        kw["n_iter"] = 5
    summary = values[::stride]
    j_args = tuple(map(jnp.asarray, (indptr, values))) + (
        (jnp.asarray(bitmap),),) + tuple(map(jnp.asarray,
                                             (frontier, mult, row_valid)))
    t_args = tuple(map(torch.from_numpy, (indptr, values))) + (
        (torch.from_numpy(bitmap),),) + tuple(map(torch.from_numpy,
                                                  (frontier, mult, row_valid)))
    for count_only in (False, True):
        want = j_expand_level(*j_args, count_only=count_only,
                              summary=jnp.asarray(summary), **kw)
        got = t_expand_level(*t_args, count_only=count_only,
                             summary=torch.from_numpy(summary), **kw)
        if count_only:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("stride,max_len", [(4, 40), (16, 200), (128, 60)])
def test_searchsorted_2level_plain_matches_reference(stride, max_len):
    rng = np.random.default_rng(stride + max_len)
    values, starts, ends = _segments(rng, 40, max_len, 300, 5)
    summary = values[::stride]
    seg = rng.integers(0, 40, 16)
    lo = starts[seg].astype(np.int32)[:, None]
    hi = ends[seg].astype(np.int32)[:, None]
    q = rng.integers(-5, 305, (16, 64)).astype(np.int32)
    n1 = int(np.ceil(np.log2(max(2, max_len // stride + 2)))) + 1
    n2 = int(np.ceil(np.log2(2 * stride + 2))) + 1
    pos_t, found_t = ref.searchsorted_segments_2level_ref(
        *map(torch.from_numpy, (values, summary, lo, hi, q)), stride, n1, n2)
    pos_j, found_j = j_ss2_ref(*map(jnp.asarray, (values, summary, lo, hi, q)),
                               stride=stride, n1=n1, n2=n2)
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_j))
    np.testing.assert_array_equal(found_t.numpy(), np.asarray(found_j))
    # the two-level search finds what the one-level search finds
    _, found_1 = ref.searchsorted_segments_ref(
        *map(torch.from_numpy, (values, lo, hi, q)),
        int(np.ceil(np.log2(max_len))) + 1)
    assert torch.equal(found_t, found_1)


# --- bitset AND-popcount (bitset_intersect_count_pallas) ------------------

def test_popcount32_matches_reference():
    rng = np.random.default_rng(0)
    v = rng.integers(0, 1 << 32, 512, dtype=np.uint64).astype(np.uint32)
    v[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    got = ref.popcount32(_i32(v))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_popcount32(jnp.asarray(v))))
    np.testing.assert_array_equal(
        got.numpy(), [bin(x).count("1") for x in v.tolist()])


@pytest.mark.parametrize("seed,rows,tile", [(0, 8, 128), (1, 16, 128),
                                            (2, 8, 256), (3, 16, 256)])
def test_bitset_intersect_count_plain_matches_pallas(seed, rows, tile):
    """The sweep of ``tests/test_kernels_bitset.py``: plain version vs
    the Pallas kernel (interpret mode), the jnp reference and numpy."""
    rng = np.random.default_rng(seed)
    n_words = tile
    domain = 32 * n_words
    a_sets = _rand_sets(rng, rows, domain, 600)
    b_sets = _rand_sets(rng, rows, domain, 600)
    a, b = _pack(a_sets, n_words), _pack(b_sets, n_words)
    a[:, 0] |= np.uint32(1 << 31)
    b[::2, 0] |= np.uint32(1 << 31)    # the sign bit of the int32 view
    got = ref.bitset_intersect_count_ref(_i32(a), _i32(b))
    want_p = bitset_intersect_count_pallas(jnp.asarray(a), jnp.asarray(b),
                                           tile=tile)
    want_r = j_and_ref(jnp.asarray(a), jnp.asarray(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_r))
    want = [len(np.intersect1d(np.append(x, 31),
                               np.append(y, 31) if i % 2 == 0 else y))
            for i, (x, y) in enumerate(zip(a_sets, b_sets))]
    np.testing.assert_array_equal(got.numpy(), want)


# --- inputs the JAX functions take and the port once refused --------------

def _triangle_level(extra_rows):
    """A 3-clique level (probe ``(0, 1)``, lower ``(1,)``) on
    ``powerlaw_cluster(120, 4, seed=2)``: the ``a < b`` edges as the
    frontier, then ``extra_rows``, as (indptr, indices, frontier) numpy
    arrays and the level keywords."""
    from repro.graphs import powerlaw_cluster as j_powerlaw_cluster
    g = j_powerlaw_cluster(120, 4, seed=2)
    src = np.repeat(np.arange(g.n_nodes), np.diff(g.indptr))
    edges = np.stack([src, g.indices], axis=1)
    fr = edges[edges[:, 0] < edges[:, 1]]
    fr = np.concatenate([fr, np.asarray(extra_rows, np.int64).reshape(-1, 2)])
    kw = dict(probe_cols=(0, 1), n_unary=0, lower_cols=(1,), upper_cols=(),
              width=64, n_iter=7, needs_degree=False)
    return (np.asarray(g.indptr, np.int32), np.asarray(g.indices, np.int32),
            fr.astype(np.int32), kw)


def _level_both(indptr, indices, fr, count_only, **kw):
    n = fr.shape[0]
    mult, valid = np.ones(n, np.int64), np.ones(n, bool)
    want = j_expand_level(*map(jnp.asarray, (indptr, indices)), (),
                          *map(jnp.asarray, (fr, mult, valid)),
                          count_only=count_only, **kw)
    got = t_expand_level(*map(torch.from_numpy, (indptr, indices)), (),
                         *map(torch.from_numpy, (fr, mult, valid)),
                         count_only=count_only, **kw)
    return got, want


@pytest.mark.parametrize("extra", [[5, 121], [5, -1], [-2, 7], [-1, -2],
                                   [300, -500], [121, 120]],
                         ids=lambda e: f"{e[0]},{e[1]}")
def test_level_step_reads_ids_outside_the_graph_as_jax(extra):
    """A frontier id outside [-(n+1), n] reads ``indptr`` where JAX's
    gather reads it (a negative index wraps once, then the index is
    clamped), where a plain PyTorch gather would raise.  The 3-clique
    level with the extra row ``[5, 121]`` counts 314 in both packages,
    what it counts without the row; every row's count and every lane's
    candidate and mask are equal."""
    indptr, indices, fr, kw = _triangle_level([extra])
    for count_only in (True, False):
        got, want = _level_both(indptr, indices, fr, count_only, **kw)
        if count_only:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if extra == [5, 121]:
        assert int(got[1].sum()) == 314 == int(np.asarray(want[1]).sum())


def test_level_step_clamp_is_a_switch_the_engine_turns_off():
    """``clamp_ids=False`` gathers as PyTorch does (an id past the graph
    raises); ``VLFTJ``, whose frontiers hold vertex ids only, passes it,
    so its level loop makes no extra call per chunk."""
    from repro_torch.core import VLFTJ, get_query
    from repro_torch.core.device_graph import GraphDB
    from repro_torch.graphs import powerlaw_cluster
    indptr, indices, fr, kw = _triangle_level([[5, 121]])
    n = fr.shape[0]
    args = (*map(torch.from_numpy, (indptr, indices)), (),
            *map(torch.from_numpy, (fr, np.ones(n, np.int64),
                                    np.ones(n, bool))))
    with pytest.raises(IndexError):
        t_expand_level(*args, count_only=True, clamp_ids=False, **kw)
    ex = VLFTJ(get_query("3-clique"),
               GraphDB(powerlaw_cluster(120, 4, seed=2), device="cpu"))
    assert ex._level_kw(ex.plan[1], 0, "bsearch")["clamp_ids"] is False


def test_searchsorted_unroll_changes_nothing():
    """The port's mirror of the JAX package's
    ``test_searchsorted_unroll_matches_loop``: ``unroll`` is accepted by
    the plain version, the router and the two-level search, and changes
    no result (eager PyTorch has no loop to unroll)."""
    rng = np.random.default_rng(21)
    vals = torch.from_numpy(np.sort(rng.integers(0, 100, 64)).astype(np.int32))
    q = torch.from_numpy(rng.integers(0, 100, (8, 128)).astype(np.int32))
    lo = torch.zeros((8, 1), dtype=torch.int32)
    hi = torch.full((8, 1), 64, dtype=torch.int32)
    a = ref.searchsorted_segments_ref(vals, lo, hi, q, n_iter=8, unroll=False)
    b = ref.searchsorted_segments_ref(vals, lo, hi, q, n_iter=8, unroll=True)
    c = ops.searchsorted_segments(vals, lo, hi, q, 8, unroll=True)
    want = j_ss_ref(*map(jnp.asarray, (vals.numpy(), lo.numpy(), hi.numpy(),
                                       q.numpy())), n_iter=8, unroll=True)
    for got in (b, c):
        for g, w, o in zip(got, want, a):
            assert torch.equal(g, o)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    summary = vals[::4].contiguous()
    two = [ref.searchsorted_segments_2level_ref(vals, summary, lo, hi, q, 4,
                                                5, 5, unroll=u)
           for u in (False, True)]
    assert all(torch.equal(x, y) for x, y in zip(*two))


def test_level_step_accepts_unroll():
    """``_expand_level(unroll=True)`` as the JAX package's level keywords
    pass it: the same 314 triangles as without it, lane for lane."""
    indptr, indices, fr, kw = _triangle_level([[5, 121]])
    got, want = _level_both(indptr, indices, fr, True, unroll=True, **kw)
    base, _ = _level_both(indptr, indices, fr, True, **kw)
    assert torch.equal(got, base)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) == 314
