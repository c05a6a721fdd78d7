"""SNAP-format edge-list IO (``# comment`` headers, whitespace pairs).

The port's copy of ``repro.graphs.io``; files written by either package
load in the other."""
from __future__ import annotations

import numpy as np

from .csr import CSRGraph


def load_edgelist(path: str, symmetrize: bool = True) -> CSRGraph:
    pairs = np.loadtxt(path, dtype=np.int64, comments="#", ndmin=2)
    if pairs.shape[1] < 2:
        raise ValueError(f"{path}: expected 2+ columns")
    # compact node ids (SNAP files may have sparse id spaces)
    src, dst = pairs[:, 0], pairs[:, 1]
    uniq, inv = np.unique(np.concatenate([src, dst]), return_inverse=True)
    src_c, dst_c = inv[: src.shape[0]], inv[src.shape[0]:]
    return CSRGraph.from_edges(src_c, dst_c, n_nodes=uniq.shape[0],
                               symmetrize=symmetrize)


def save_edgelist(g: CSRGraph, path: str) -> None:
    ea = g.edge_array()
    keep = ea[:, 0] < ea[:, 1]  # one direction only
    np.savetxt(path, ea[keep], fmt="%d",
               header="saved by repro_torch.graphs.io", comments="# ")
