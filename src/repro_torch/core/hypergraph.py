"""Query hypergraphs, β-acyclicity, and nested elimination orders (NEO).

The hypergraph of a query has the query variables as vertices and one
hyperedge ``vars(R)`` per atom (§2.1).  β-acyclicity is characterized by the
existence of a *nested elimination order*: an ordering ``u_1, ..., u_n`` such
that ``u_1`` is a *nest point* (the hyperedges containing it form a chain
under ⊆), and after removing ``u_1`` from every hyperedge, ``u_2`` is a nest
point of the residual hypergraph, and so on [Ngo et al., PODS'14].

Minesweeper's GAO must be a NEO (Proposition 4.2): then every principal
filter ``G_i`` in the CDS is a chain.
"""
from __future__ import annotations

from dataclasses import dataclass
from .query import Query


@dataclass(frozen=True)
class Hypergraph:
    vertices: tuple[str, ...]
    edges: tuple[frozenset[str], ...]

    @classmethod
    def of(cls, q: Query) -> "Hypergraph":
        return cls(q.variables, tuple(frozenset(a.vars) for a in q.atoms))


def _edges_with(edges: list[frozenset[str]], v: str) -> list[frozenset[str]]:
    return [e for e in edges if v in e]


def _is_chain(sets: list[frozenset[str]]) -> bool:
    """True iff the sets are totally ordered by inclusion."""
    ss = sorted(set(sets), key=len)
    return all(a <= b for a, b in zip(ss, ss[1:]))


def is_nest_point(edges: list[frozenset[str]], v: str) -> bool:
    return _is_chain(_edges_with(edges, v))


def _eliminate(edges: list[frozenset[str]], v: str) -> list[frozenset[str]]:
    out = []
    for e in edges:
        e2 = e - {v}
        if e2:
            out.append(e2)
    # drop duplicates but keep list type
    return list(dict.fromkeys(out))


def is_neo(hg: Hypergraph, order: tuple[str, ...]) -> bool:
    """Is ``order`` a valid GAO, i.e. a nested elimination order?

    Convention (matches the paper's Table 4): the *last* GAO attribute is
    eliminated first — the GAO is the reverse of the nest-point
    elimination sequence, so the deepest CDS levels are chains.
    """
    if set(order) != set(hg.vertices) or len(order) != len(hg.vertices):
        return False
    edges = list(hg.edges)
    for v in reversed(order):
        if not is_nest_point(edges, v):
            return False
        edges = _eliminate(edges, v)
    return True


def all_neos(hg: Hypergraph, limit: int = 10000) -> list[tuple[str, ...]]:
    """Enumerate NEO GAOs by backtracking (queries are tiny: n ≤ 8).

    Elimination sequences are generated back-to-front and reversed into
    GAOs (see :func:`is_neo`).
    """
    out: list[tuple[str, ...]] = []

    def rec(edges: list[frozenset[str]], remaining: list[str],
            suffix: tuple[str, ...]) -> None:
        if len(out) >= limit:
            return
        if not remaining:
            out.append(tuple(reversed(suffix)))
            return
        for v in remaining:
            if is_nest_point(edges, v):
                rec(_eliminate(edges, v), [u for u in remaining if u != v],
                    suffix + (v,))

    rec(list(hg.edges), list(hg.vertices), ())
    return out


def is_beta_acyclic(hg: Hypergraph) -> bool:
    """β-acyclic ⇔ a NEO exists.  Greedy nest-point elimination is complete
    for β-acyclicity (eliminating any nest point preserves β-acyclicity)."""
    edges = list(hg.edges)
    remaining = list(hg.vertices)
    while remaining:
        for v in remaining:
            if is_nest_point(edges, v):
                edges = _eliminate(edges, v)
                remaining.remove(v)
                break
        else:
            return False
    return True


def adjacency(hg: Hypergraph) -> dict[str, set[str]]:
    adj: dict[str, set[str]] = {v: set() for v in hg.vertices}
    for e in hg.edges:
        for u in e:
            adj[u] |= e - {u}
    return adj
