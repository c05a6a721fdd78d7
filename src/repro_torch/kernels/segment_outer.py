"""Segment outer product on the card — MACE's A-basis scatter.

Wrapper of ``csrc/segment_outer.cu``, the Hopper kernel that replaces
``repro.kernels.segment_outer.segment_outer_pallas``:

    out[n, c, m] = sum over edges j with dst[j] == n of msg[j, c] * basis[j, m]

over edges sorted by destination.  The kernel cuts the edges into equal
ranges, a warp each, so a node of many edges spreads over many warps;
a second pass adds the partial rows of the nodes whose edges cross a
range boundary, in range order, so two calls give bit-identical results;
a third writes the zero rows of the nodes no run started on.  See the source
for the design.

It takes what the JAX function takes.  ``msg`` and ``basis`` are
promoted as a pair (:func:`promote`, ``torch.result_type``, which is
JAX's promotion for these pairs): float32, bfloat16 and float16 run as
they are, each product rounded to that type and summed in float32, as
``segment_outer_pallas`` does; any other real type (float64, integers)
runs as float32, on the plain path too (``kernels.ops.segment_outer``
promotes before it routes).  Any C and M: C is padded to whole 16-byte
rows, and a basis that takes more than one column pass is laid out a
pass at a time (:func:`pass_basis`).  The output is float32.  ``block_tile0`` and ``n_tiles`` are not used, as in
the plain version: the kernel walks the sorted edges directly, and for
the arguments :func:`block_tile_starts` gives, the TPU kernel's windows
cover the same edges.  Edges whose ``dst`` lies outside
[0, n_nodes) add nothing, as in the TPU kernel (padding carries
``dst = n_nodes``).

:func:`block_tile_starts` is the port's copy of the JAX package's host
helper (numpy only).  The plain PyTorch version is
``kernels.ref.segment_outer_ref``; ``kernels.ops`` routes between the two
by the tensors' device.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build

DEF_TE = 128   # edges per tile
DEF_BN = 8     # nodes per block
#: the kernel's input types, by the entry point's dtype code
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def block_tile_starts(dst_sorted: np.ndarray, n_nodes: int,
                      bn: int = DEF_BN, te: int = DEF_TE
                      ) -> tuple[np.ndarray, int]:
    """(first edge-tile per bn-node block, static max tiles per block)."""
    e = dst_sorted.shape[0]
    total_tiles = max(1, e // te)
    n_blocks = -(-n_nodes // bn)
    first_edge = np.searchsorted(dst_sorted, np.arange(n_blocks) * bn,
                                 side="left")
    last_edge = np.searchsorted(dst_sorted,
                                np.arange(1, n_blocks + 1) * bn - 1,
                                side="right")
    t0 = np.minimum(first_edge // te, total_tiles - 1).astype(np.int32)
    t1 = np.minimum(np.maximum(last_edge - 1, first_edge) // te,
                    total_tiles - 1)
    n_tiles = int(max(1, (t1 - t0).max() + 1))
    return t0, n_tiles


def check_shapes(msg, basis, dst, n_nodes: int, bn: int, te: int) -> None:
    """Raise where ``segment_outer_pallas`` asserts (E % te == 0,
    n_nodes % bn == 0), and on mismatched edge counts."""
    if msg.dim() != 2 or basis.dim() != 2 or dst.dim() != 1:
        raise ValueError("segment_outer: msg must be (E, C), basis (E, M) "
                         "and dst (E,)")
    e = msg.shape[0]
    if basis.shape[0] != e or dst.shape[0] != e:
        raise ValueError("segment_outer: msg, basis and dst must have E rows")
    if te < 1 or e % te:
        raise ValueError(f"segment_outer: pad edges to the tile size "
                         f"(E {e}, te {te})")
    if bn < 1 or n_nodes % bn:
        raise ValueError(f"segment_outer: pad nodes to the block size "
                         f"(n_nodes {n_nodes}, bn {bn})")


def promote(msg: torch.Tensor, basis: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """``msg`` and ``basis`` in the one type the kernel runs them in: the
    pair's promotion where that is float32, bfloat16 or float16 (bf16 with
    f32 gives f32, bf16 with f16 gives f32, as in JAX), float32 for any
    other real type."""
    dtype = torch.result_type(msg, basis)
    if dtype.is_complex:
        raise ValueError("segment_outer: msg and basis must be real")
    if dtype not in KERNEL_DTYPES:
        dtype = torch.float32
    return msg.to(dtype), basis.to(dtype)


def padded_channels(c: int, dtype: torch.dtype) -> int:
    """C rounded up to whole 16-byte rows: the kernel's msg row stride."""
    step = 16 // torch.empty((), dtype=dtype).element_size()
    return -(-c // step) * step


def pass_basis(basis: torch.Tensor, width: int) -> torch.Tensor:
    """basis (E, M) as the kernel reads it when a column pass stages
    ``width`` of its M columns: itself where one pass takes all M, else
    (ceil(M / width), E, width), the columns past M zero."""
    e, m = basis.shape
    if width == m:
        return basis
    n_pass = -(-m // width)
    cols = basis.new_zeros((e, n_pass * width))
    cols[:, :m] = basis
    return cols.view(e, n_pass, width).transpose(0, 1).contiguous()


@functools.lru_cache(maxsize=64)
def _plan(device_index: int, e: int, cp: int, m: int, code: int
          ) -> tuple[int, int, int]:
    out = (ctypes.c_int64 * 3)()
    with torch.cuda.device(device_index):
        rc = build.library().segment_outer_plan(e, cp, m, code,
                                                ctypes.addressof(out))
    build.check(rc, "segment_outer")
    return int(out[0]), int(out[1]), int(out[2])


def plan(e: int, c: int, m: int, dtype: torch.dtype,
         device) -> tuple[int, int, int]:
    """(edges a range, ranges, basis columns a pass stages) for E edges
    of C channels and M basis columns of ``dtype`` on ``device``: the
    ranges from the occupancy of the kernel there, the width for
    :func:`pass_basis`."""
    device = torch.device(device)
    return _plan(device.index if device.index is not None
                 else torch.cuda.current_device(), e,
                 padded_channels(c, dtype), m, KERNEL_DTYPES[dtype])


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous from a 16-byte boundary (cp.async copies 16)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def segment_outer_cuda(msg: torch.Tensor, basis: torch.Tensor,
                       dst: torch.Tensor, block_tile0, n_nodes: int,
                       n_tiles: int, bn: int = DEF_BN,
                       te: int = DEF_TE) -> torch.Tensor:
    """msg (E, C) and basis (E, M) of any real types, dst (E,) sorted
    ascending and padded with ``n_nodes``, ``block_tile0`` and ``n_tiles``
    from :func:`block_tile_starts` (both unused), on one CUDA device.
    Returns (n_nodes, C, M) float32."""
    name = "segment_outer"
    check_shapes(msg, basis, dst, n_nodes, bn, te)
    msg, basis = promote(msg, basis)
    if not msg.is_cuda:
        raise ValueError(f"{name}: tensors must lie on a CUDA device")
    for arg, t in (("basis", basis), ("dst", dst)):
        if t.device != msg.device:
            raise ValueError(f"{name}: {arg} is on {t.device}")
    e, c = msg.shape
    m = basis.shape[1]
    if min(e, c, m, n_nodes) == 0:
        return torch.zeros((n_nodes, c, m), dtype=torch.float32,
                           device=msg.device)
    cp = padded_channels(c, msg.dtype)
    if cp != c:
        wide = torch.zeros((e, cp), dtype=msg.dtype, device=msg.device)
        wide[:, :c] = msg
        msg = wide
    msg = _aligned(msg)
    dst = _aligned(dst.to(torch.int32))
    range_edges, n_ranges, width = plan(e, c, m, msg.dtype, msg.device)
    basis = _aligned(pass_basis(basis, width))
    out = torch.empty((n_nodes, c, m), dtype=torch.float32,
                      device=msg.device)
    partial = torch.empty((n_ranges, 2, c * m), dtype=torch.float32,
                          device=msg.device)
    seen = torch.empty(n_nodes, dtype=torch.uint8, device=msg.device)
    lib = build.library()
    stream = torch.cuda.current_stream(msg.device).cuda_stream
    rc = lib.segment_outer_launch(
        msg.data_ptr(), basis.data_ptr(), dst.data_ptr(), e, c, cp, m,
        n_nodes, range_edges, n_ranges, KERNEL_DTYPES[msg.dtype],
        out.data_ptr(), partial.data_ptr(), seen.data_ptr(), stream)
    build.check(rc, "segment_outer")
    build.count_launch("segment_outer")
    return out
