"""Global attribute order (GAO) selection (paper §4.9).

For β-acyclic queries the GAO must be a NEO; among NEOs the paper picks the
one with the *longest path length* — longer runs of consecutive attributes
that are adjacent in the query graph allow more CDS caching (Table 4 shows
ABCDE beating the other NEOs on 4-path).

For cyclic queries (no NEO exists) we use the standard WCOJ heuristic:
greedily order variables so that each next variable is covered by as many
atoms shared with already-bound variables as possible (maximizes
intersection pruning for the leapfrog), tie-broken by total degree.
"""
from __future__ import annotations

from .hypergraph import Hypergraph, adjacency, all_neos, is_beta_acyclic
from .query import Query


def _path_score(order: tuple[str, ...], adj: dict[str, set[str]]) -> int:
    """Length of the longest run of consecutive order-adjacent variables."""
    best = run = 0
    for u, v in zip(order, order[1:]):
        if v in adj[u]:
            run += 1
            best = max(best, run)
        else:
            run = 0
    return best


def _cyclic_heuristic_order(q: Query) -> tuple[str, ...]:
    hg = Hypergraph.of(q)
    adj = adjacency(hg)
    degree = {v: sum(v in a.vars for a in q.atoms) for v in hg.vertices}
    order: list[str] = []
    remaining = set(hg.vertices)
    while remaining:
        bound = set(order)

        def key(v: str) -> tuple[int, int, str]:
            # atoms that connect v to already-bound variables
            connect = sum(
                1 for a in q.atoms
                if v in a.vars and any(u in bound for u in a.vars)
            )
            return (connect, degree[v], v)

        # lexicographically max (connectivity, degree), stable by name
        nxt = max(sorted(remaining), key=key)
        order.append(nxt)
        remaining.remove(nxt)
    return tuple(order)


def choose_gao(q: Query) -> tuple[str, ...]:
    """GAO: best NEO for β-acyclic queries, WCOJ heuristic otherwise."""
    hg = Hypergraph.of(q)
    if is_beta_acyclic(hg):
        neos = all_neos(hg)
        adj = adjacency(hg)
        # longest-path NEO; stable tie-break by variable-name order
        return max(sorted(neos), key=lambda o: _path_score(o, adj))
    return _cyclic_heuristic_order(q)
