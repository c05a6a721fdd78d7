"""The plain reference: each pattern's count from its Datalog body, in
plain PyTorch over the CSR and samples that the benchmark made.

It imports nothing of the program and shares none of its algorithms:
tree patterns (no filters, an acyclic variable graph) are counted by
passing per-node count vectors up the variable tree, each message a
gather over the CSR followed by segment sums taken as differences of a
running sum at the row offsets (the program's messages use
``index_add_``).

Counts are int64.  The control stands in the program's place to show
that the comparison rejects a lesser answer: ``dtype=torch.float32``
runs the same arithmetic in float32, the next precision below.  Every
count comes with ``log2_peak``, the log2 of the largest total an
intermediate vector or sum reached (taken in float64), so a run can
show that int64 was never near overflow.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .queries import Pattern


class RefGraph:
    """A symmetric CSR on ``device``."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray, device):
        self.device = torch.device(device)
        self.n = int(indptr.shape[0] - 1)
        self.indptr = torch.as_tensor(indptr, dtype=torch.int64,
                                      device=self.device)
        self.indices = torch.as_tensor(indices, dtype=torch.int64,
                                       device=self.device)

    @property
    def m(self) -> int:
        return int(self.indices.shape[0])


class Tally:
    """A running sum in the count's type, with the float64 peak."""

    def __init__(self, dtype: torch.dtype, device):
        self.total = torch.zeros((), dtype=dtype, device=device)
        self.peak = 0.0

    def add(self, x: torch.Tensor) -> None:
        self.total += x.to(self.total.dtype).sum()
        self.peak = max(self.peak, float(self.total))

    def note(self, x: torch.Tensor) -> None:
        self.peak = max(self.peak, float(x.to(torch.float64).sum()))

    def result(self) -> tuple[int, float]:
        return (int(round(float(self.total)))
                if self.total.dtype.is_floating_point else int(self.total),
                math.log2(self.peak) if self.peak > 0 else 0.0)


# -- tree patterns ------------------------------------------------------------

def _segment_sums(g: RefGraph, x: torch.Tensor, tally: Tally) -> torch.Tensor:
    """``y[v] = Σ_{u ∈ N(v)} x[u]`` as differences of a running sum."""
    gathered = x[g.indices]
    tally.note(gathered)
    run = torch.zeros(g.m + 1, dtype=x.dtype, device=x.device)
    torch.cumsum(gathered, 0, out=run[1:])
    return run[g.indptr[1:]] - run[g.indptr[:-1]]


def count_tree(g: RefGraph, pat: Pattern, samples: dict[str, np.ndarray],
               dtype: torch.dtype) -> tuple[int, float]:
    adj: dict[str, list[str]] = {v: [] for v in pat.variables}
    for a, b in pat.edges:
        adj[a].append(b)
        adj[b].append(a)
    tally = Tally(dtype, g.device)

    def mask(var: str) -> torch.Tensor:
        c = torch.ones(g.n, dtype=dtype, device=g.device)
        for rel, v in pat.unary:
            if v == var:
                m = torch.zeros(g.n, dtype=dtype, device=g.device)
                m[torch.as_tensor(samples[rel], device=g.device)] = 1
                c = c * m
        return c

    def up(var: str, parent: str | None) -> torch.Tensor:
        c = mask(var)
        for ch in adj[var]:
            if ch != parent:
                c = c * _segment_sums(g, up(ch, var), tally)
                tally.note(c)
        return c

    tally.add(up(pat.variables[0], None))
    return tally.result()


def count(g: RefGraph, pat: Pattern, samples: dict[str, np.ndarray] | None,
          dtype: torch.dtype = torch.int64) -> tuple[int, float]:
    """``(count, log2_peak)`` of the tree pattern ``pat`` on ``g``."""
    if pat.less:
        raise ValueError(f"no reference count for {pat.name}")
    return count_tree(g, pat, samples or {}, dtype)
