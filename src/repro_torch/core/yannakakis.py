"""Vectorized counting Yannakakis in PyTorch — the port of
``repro.core.yannakakis`` (the Minesweeper analogue for β-acyclic
patterns, paper §4.11).

Bottom-up over the query's variable tree, per node-id count vectors
``c_leaf = [x ∈ v_i]`` and ``c_parent = unary ⊙ ∏_children (A @ c_child)``,
where ``A @ c`` is a CSR gather plus ``index_add_`` in int64 (one SpMV per
query edge); the root vector's sum is the count.  The SpMV is plain
PyTorch: the JAX package computes it with ``segment_sum``, not a Pallas
kernel.

For enumeration the same messages act as semijoin filters
(:meth:`CountingYannakakis.semijoin_reduce`): a value stays active iff
every message into it is nonzero, and the reduced domains guide a
vectorized-LFTJ descent (``results/backward.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from .device_graph import GraphDB
from .hypergraph import Hypergraph, is_beta_acyclic
from .plan import JoinPlan
from .query import Query


class NotTreeShaped(ValueError):
    pass


def variable_tree(query: Query) -> dict[str, list[str]]:
    """Adjacency of the query's variable graph; raises if not a forest."""
    adj: dict[str, list[str]] = {v: [] for v in query.variables}
    seen_edges = set()
    for a in query.atoms:
        if a.arity == 1:
            continue
        if a.arity != 2:
            raise NotTreeShaped("binary atoms only")
        u, v = a.vars
        if u == v:
            raise NotTreeShaped("self loop")
        key = frozenset((u, v))
        if key in seen_edges:
            continue  # parallel atoms collapse (same constraint)
        seen_edges.add(key)
        adj[u].append(v)
        adj[v].append(u)
    # forest check: every connected component must satisfy |E| = |V| - 1
    if query.filters:
        raise NotTreeShaped("filters break tree message passing")
    visited: set[str] = set()
    for root in adj:
        if root in visited:
            continue
        stack = [root]
        comp_nodes = set()
        while stack:
            x = stack.pop()
            if x in comp_nodes:
                continue
            comp_nodes.add(x)
            stack.extend(adj[x])
        comp_e = sum(len(adj[x]) for x in comp_nodes) // 2
        if comp_e != len(comp_nodes) - 1:
            raise NotTreeShaped("variable graph is cyclic")
        visited |= comp_nodes
    return adj


def _spmv(indices, src_ids, c, num_segments: int) -> torch.Tensor:
    """y[x] = Σ_{(x,z) ∈ E} c[z]  — gather + index_add_ over the CSR."""
    y = torch.zeros(num_segments, dtype=c.dtype, device=c.device)
    return y.index_add_(0, src_ids, c[indices])


class CountingYannakakis:
    """Count β-acyclic graph patterns in O(#query-edges) SpMV passes."""

    def __init__(self, query: Query, gdb: GraphDB,
                 root: str | None = None,
                 plan: JoinPlan | None = None):
        hg = Hypergraph.of(query)
        if not is_beta_acyclic(hg):
            raise NotTreeShaped("query is β-cyclic; use vlftj or hybrid")
        self.query = query
        self.gdb = gdb
        self.join_plan = plan
        self.adj = variable_tree(query)
        self.unary_of: dict[str, list[str]] = {v: [] for v in query.variables}
        for a in query.atoms:
            if a.arity == 1:
                self.unary_of[a.vars[0]].append(a.rel)
        if root is None and plan is not None and plan.root is not None:
            root = plan.root
        self.root = root or query.variables[0]
        # enumeration column order: the plan's GAO covers every variable
        # (yannakakis plans carry choose_gao(query)); plan-free
        # construction derives the same order directly
        if plan is not None and set(plan.gao) == set(query.variables):
            self.gao = plan.gao
        else:
            from .gao import choose_gao
            self.gao = choose_gao(query)
        # spmvs is the native counter; rows_expanded / level_rows follow
        # the reference's stats schema (every SpMV propagates one message
        # over the n_nodes id domain; the root tally is the one frontier)
        self.stats = {"spmvs": 0, "rows_expanded": 0, "level_rows": {}}
        self._cross_factor = 1

    def _unary_mask(self, var: str) -> torch.Tensor:
        vec = torch.ones(self.gdb.n_nodes, dtype=torch.int64,
                         device=self.gdb.device)
        for u in self.unary_of[var]:
            vec = vec * self.gdb.dev(f"bitmap:{u}").to(torch.int64)
        return vec

    def message_to_root(self, root: str | None = None) -> torch.Tensor:
        """Per-node-id int64 count vector at the root variable."""
        root = root or self.root
        indices = self.gdb.dev("indices")
        src_ids = self.gdb.dev("src_ids")
        n = self.gdb.n_nodes

        def up(var: str, parent: str | None) -> torch.Tensor:
            c = self._unary_mask(var)
            for ch in self.adj[var]:
                if ch == parent:
                    continue
                c_ch = up(ch, var)
                self.stats["spmvs"] += 1
                self.stats["rows_expanded"] += n
                c = c * _spmv(indices, src_ids, c_ch, n)
            return c

        # product over the root's own component; other components multiply
        # as scalar factors (cross products)
        self.stats["level_rows"][0] = n
        c_root = up(root, None)
        self._cross_factor = 1
        for r in self._component_roots(root):
            if r != root:
                self._cross_factor *= int(up(r, None).sum())
        return c_root

    def _component_roots(self, root: str) -> list[str]:
        roots, visited = [], set()
        order = [root] + [v for v in self.query.variables if v != root]
        for v in order:
            if v in visited:
                continue
            roots.append(v)
            stack = [v]
            while stack:
                x = stack.pop()
                if x in visited:
                    continue
                visited.add(x)
                stack.extend(self.adj[x])
        return roots

    def count(self) -> int:
        c_root = self.message_to_root()
        return int(c_root.sum()) * self._cross_factor

    def semijoin_reduce(self) -> dict[str, np.ndarray]:
        """Active-value masks per variable after full semijoin reduction
        (upward + downward passes), as host bool arrays — the
        enumeration prefilter."""
        indices = self.gdb.dev("indices")
        src_ids = self.gdb.dev("src_ids")
        n = self.gdb.n_nodes
        up_msg: dict[tuple[str, str], torch.Tensor] = {}

        def up(var: str, parent: str | None) -> torch.Tensor:
            c = self._unary_mask(var) > 0
            for ch in self.adj[var]:
                if ch == parent:
                    continue
                m = up(ch, var)
                self.stats["spmvs"] += 1
                self.stats["rows_expanded"] += n
                c = c & (_spmv(indices, src_ids, m.to(torch.int64), n) > 0)
            if parent is not None:
                up_msg[(var, parent)] = c
            return c

        active: dict[str, torch.Tensor] = {}

        def down(var: str, parent: str | None, mask_from_parent):
            c = self._unary_mask(var) > 0
            if mask_from_parent is not None:
                c = c & mask_from_parent
            for ch in self.adj[var]:
                if ch == parent:
                    continue
                c = c & (_spmv(indices, src_ids,
                               up_msg[(ch, var)].to(torch.int64), n) > 0)
            active[var] = c
            for ch in self.adj[var]:
                if ch == parent:
                    continue
                m = _spmv(indices, src_ids, c.to(torch.int64), n) > 0
                down(ch, var, m)

        for r in self._component_roots(self.root):
            up(r, None)
            down(r, None, None)
        return {v: m.cpu().numpy() for v, m in active.items()}

    def enumerate(self, limit: int | None = None) -> np.ndarray:
        """Backward-expansion enumeration: int64 tuples, columns in GAO
        order (``self.output_vars``), rows lex-sorted; ``limit``
        truncates after the ordering.  See
        ``repro_torch.results.backward.yannakakis_rows``."""
        from ..results.backward import yannakakis_rows
        rows, _ = yannakakis_rows(self)
        return rows if limit is None else rows[:limit]

    @property
    def output_vars(self) -> tuple[str, ...]:
        """Column order of :meth:`enumerate`."""
        return self.gao


def yannakakis_count(query: Query, gdb: GraphDB) -> int:
    return CountingYannakakis(query, gdb).count()
