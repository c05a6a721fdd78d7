"""Segment outer product on the card — MACE's A-basis scatter.

Wrapper of ``csrc/segment_outer.cu``, the Hopper kernel that replaces
``repro.kernels.segment_outer.segment_outer_pallas``:

    out[n, c, m] = sum over edges j with dst[j] == n of msg[j, c] * basis[j, m]

over edges sorted by destination, walked in node blocks and edge tiles.
See the source for the design.  :func:`block_tile_starts` is the port's
copy of the JAX package's host helper (numpy only) that gives each node
block its first edge tile.  The plain PyTorch version is
``kernels.ref.segment_outer_ref``; ``kernels.ops`` routes between the two
by the tensors' device.
"""
from __future__ import annotations

import numpy as np
import torch

from . import build

DEF_TE = 128   # edges per tile
DEF_BN = 8     # nodes per block
#: shared memory one block may use on sm_90 (227 KB): the kernel keeps a
#: block's (bn, C*M) f32 sums and 32 staged edges there
MAX_SHARED_BYTES = 232448
STAGED_EDGES = 32


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


def segment_outer_cuda(msg: torch.Tensor, basis: torch.Tensor,
                       dst: torch.Tensor, block_tile0, n_nodes: int,
                       n_tiles: int, bn: int = DEF_BN,
                       te: int = DEF_TE) -> torch.Tensor:
    """msg (E, C) and basis (E, M) float32, dst (E,) sorted ascending and
    padded with ``n_nodes``, ``block_tile0`` (n_nodes / bn,) and
    ``n_tiles`` from :func:`block_tile_starts`, on one CUDA device.
    Returns (n_nodes, C, M) float32."""
    name = "segment_outer"
    check_shapes(msg, basis, dst, n_nodes, bn, te)
    if not msg.is_cuda:
        raise ValueError(f"{name}: tensors must lie on a CUDA device")
    for arg, t in (("basis", basis), ("dst", dst)):
        if t.device != msg.device:
            raise ValueError(f"{name}: {arg} is on {t.device}")
    if msg.dtype != torch.float32 or basis.dtype != torch.float32:
        raise ValueError(f"{name}: msg and basis must be float32")
    e, c = msg.shape
    m = basis.shape[1]
    n_blocks = n_nodes // bn
    tile0 = torch.as_tensor(block_tile0, dtype=torch.int32,
                            device=msg.device).contiguous()
    if tile0.shape != (n_blocks,):
        raise ValueError(f"{name}: block_tile0 must be (n_nodes / bn,) = "
                         f"({n_blocks},)")
    smem = 4 * (bn * c * m + STAGED_EDGES * (c + m + 1))
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"{name}: a block's (bn, C*M) sums need {smem} bytes "
                         f"of shared memory (at most {MAX_SHARED_BYTES})")
    msg, basis = msg.contiguous(), basis.contiguous()
    dst = dst.to(torch.int32).contiguous()
    out = torch.empty((n_nodes, c, m), dtype=torch.float32, device=msg.device)
    lib = build.library()
    stream = torch.cuda.current_stream(msg.device).cuda_stream
    rc = lib.segment_outer_launch(
        msg.data_ptr(), basis.data_ptr(), dst.data_ptr(), tile0.data_ptr(),
        e, c, m, n_nodes, bn, te, int(n_tiles), out.data_ptr(), stream)
    build.check(rc, name)
    build.count_launch(name)
    return out
