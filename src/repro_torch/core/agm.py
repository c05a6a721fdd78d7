"""AGM bound (Appendix A): optimal fractional edge cover via LP.

``AGM(Q) = min Π_F |R_F|^{x_F}`` over fractional edge covers ``x`` — i.e.
minimize ``Σ_F log2|R_F|·x_F`` subject to ``Σ_{F ∋ v} x_F ≥ 1`` for every
variable ``v`` and ``x ≥ 0``.  Worst-case optimal joins run in
``Õ(N + AGM(Q))``.
"""
from __future__ import annotations

import math

import numpy as np
from scipy.optimize import linprog

from .query import Query


def fractional_edge_cover(q: Query, sizes: dict[str, int]
                          ) -> tuple[np.ndarray, float]:
    """Return (x, log2 AGM).  ``sizes`` maps relation name -> |R|.

    Each *atom* is its own hyperedge (self-joins contribute separately, with
    the same base-relation size).
    """
    variables = q.variables
    atoms = q.atoms
    n, m = len(variables), len(atoms)
    if any(sizes[a.rel] <= 0 for a in atoms):
        # an empty relation annihilates the join
        return np.zeros(m), float("-inf")
    c = np.array(
        [math.log2(sizes[a.rel]) for a in atoms], dtype=np.float64
    )
    # A_ub @ x <= b_ub encodes -(Σ_{F∋v} x_F) <= -1
    A = np.zeros((n, m))
    for j, a in enumerate(atoms):
        for i, v in enumerate(variables):
            if v in a.vars:
                A[i, j] = -1.0
    b = -np.ones(n)
    res = linprog(c, A_ub=A, b_ub=b, bounds=[(0, None)] * m, method="highs")
    if not res.success:  # pragma: no cover - LP on a cover polytope is feasible
        raise RuntimeError(f"AGM LP failed: {res.message}")
    return res.x, float(res.fun)


def agm_bound(q: Query, sizes: dict[str, int]) -> float:
    """The AGM bound in number of tuples (may be large; returns float)."""
    _, log2_bound = fractional_edge_cover(q, sizes)
    return 2.0 ** log2_bound
