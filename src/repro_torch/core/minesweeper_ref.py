"""Faithful Minesweeper (§4): CDS, gap boxes, moving frontier, Ideas 1-7.

Minesweeper rules out regions of the output space ("gap boxes") certified
empty by index probes, storing them in a Constraint Data Structure (CDS).
``computeFreeTuple`` finds the lexicographically-smallest candidate tuple
not inside any stored gap; probing the inputs around it either certifies an
output tuple or yields new maximal gaps.  For β-acyclic queries with a NEO
GAO this is instance-optimal up to a log factor [Ngo et al., PODS'14].

Implemented ideas from the paper:
  * Idea 1  (point list): intervals kept merged & children inside a newly
    inserted interval pruned.
  * Idea 2  (moving frontier): free tuples advance lexicographically; output
    tuples advance the frontier instead of inserting unit gaps.
  * Idea 3  (geometric certificate): maximal per-relation gap boxes.
  * Idea 4  (avoid repeated seekGap): a per-relation last-constraint cache
    suppresses probes the previous gap already answers (flag-controlled —
    benchmarked in Tables 1-2).
  * Idea 5  (backtracking and truncating): exhausted nodes truncate their
    first non-wildcard ancestor branch.
  * Idea 6  (complete nodes) is subsumed here by the point-list layout:
    merged free-value knowledge accumulates in the chain-bottom node's
    interval list, so once a subtree has been swept, later visits iterate
    its free values via ``next_free`` in O(log) without re-polling the
    chain — the effect Idea 6's completeness flag buys the paper's
    two-list implementation.  (The Idea-6 *caching* speedup is measured
    on the vectorized analogue in ``benchmarks/bench_ideas.py``.)
  * Idea 7  (skipping gaps): for β-cyclic queries only a β-acyclic skeleton
    inserts constraints; other relations' gaps just advance the frontier.
  * Idea 8  (#Minesweeper micro message passing) is realized exactly by
    the vectorized counting engine (``core/yannakakis.py``) — the paper
    itself frames #MS as message passing; counts here come from
    enumeration (this class is the correctness oracle).

Host-only Python; serves as the correctness oracle and the paper-faithful
baseline that ``core/yannakakis.py`` (the vectorized analogue) is compared
against.  The port's copy of ``repro.core.minesweeper_ref``.
"""
from __future__ import annotations

import numpy as np

from .gao import choose_gao
from .hypergraph import Hypergraph, is_beta_acyclic
from .query import Query
from .relation import Database, NEG_INF, POS_INF

STAR = "*"


class IntervalList:
    """Sorted, disjoint *open* integer intervals with merge-on-insert."""

    __slots__ = ("ivs",)

    def __init__(self):
        self.ivs: list[tuple[int, int]] = []

    def insert(self, l: int, r: int) -> None:
        if r - l <= 1:
            return  # an open interval (l, l+1) contains no integer
        out: list[tuple[int, int]] = []
        for (a, b) in self.ivs:
            if a < r and l < b:  # open-overlap -> merge
                l, r = min(l, a), max(r, b)
            else:
                out.append((a, b))
        out.append((l, r))
        out.sort()
        self.ivs = out

    def next_free(self, x: int) -> int:
        """Smallest y >= x with y inside no stored interval (v.Next)."""
        # binary search over sorted disjoint intervals
        ivs = self.ivs
        lo, hi = 0, len(ivs)
        while lo < hi:
            mid = (lo + hi) // 2
            if ivs[mid][1] <= x:
                lo = mid + 1
            else:
                hi = mid
        if lo < len(ivs):
            a, b = ivs[lo]
            if a < x < b:
                return b
        return x

    def covers_all(self) -> bool:
        return self.next_free(NEG_INF + 1) >= POS_INF

    def __len__(self) -> int:
        return len(self.ivs)


class _Node:
    __slots__ = ("children", "intervals", "parent", "label")

    def __init__(self, parent=None, label=None):
        self.children: dict = {}
        self.intervals = IntervalList()
        self.parent = parent
        self.label = label

    def child(self, label, create: bool = False):
        c = self.children.get(label)
        if c is None and create:
            c = _Node(self, label)
            self.children[label] = c
        return c

    def specificity(self) -> int:
        n, node = 0, self
        while node.parent is not None:
            if node.label != STAR:
                n += 1
            node = node.parent
        return n


class Constraint:
    """``⟨c_0,...,c_{d-1}, (l,r), *,...⟩`` — pattern + one open interval."""

    __slots__ = ("pattern", "pos", "l", "r")

    def __init__(self, pattern: tuple, pos: int, l: int, r: int):
        self.pattern = pattern  # length == pos, entries int or STAR
        self.pos = pos
        self.l = l
        self.r = r

    def pattern_matches(self, t) -> bool:
        for p, v in zip(self.pattern, t):
            if p is not STAR and p != v:
                return False
        return True

    def matches(self, t) -> bool:
        return self.pattern_matches(t) and self.l < t[self.pos] < self.r

    def __repr__(self):  # pragma: no cover - debugging aid
        pat = ",".join("*" if p is STAR else str(p) for p in self.pattern)
        return f"<{pat},({self.l},{self.r}),*...>"


def _pattern_of(node: _Node) -> tuple:
    p = []
    while node.parent is not None:
        p.append(node.label)
        node = node.parent
    return tuple(reversed(p))


def _generalizes(p: tuple, q: tuple) -> bool:
    """p generalizes q: same length, p_i == q_i or p_i == '*'."""
    return all(a is STAR or a == b for a, b in zip(p, q))


def _chain_bottom(G: list["_Node"]) -> "_Node | None":
    """If G is a chain under specialization, return its bottom (the node
    every other node generalizes); else None.  Prop 4.2 guarantees a chain
    for β-acyclic queries under a NEO GAO — the soundness condition for
    caching merged intervals at the bottom (Idea 5).  For general posets
    (cyclic queries, filter constraints) caching at a non-bottom node would
    poison sibling prefixes, so the caller skips the cache."""
    pats = [_pattern_of(nd) for nd in G]
    bottom_i = 0
    for i in range(1, len(G)):
        if _generalizes(pats[bottom_i], pats[i]):
            bottom_i = i
    bp = pats[bottom_i]
    for i, p in enumerate(pats):
        if i != bottom_i and not _generalizes(p, bp):
            return None
    return G[bottom_i]


class CDS:
    """The constraint data structure: a tree with one level per GAO attr."""

    def __init__(self, n: int):
        self.n = n
        self.root = _Node()
        self.num_constraints = 0

    def insert(self, c: Constraint) -> None:
        node = self.root
        for label in c.pattern:
            node = node.child(label, create=True)
        node.intervals.insert(c.l, c.r)
        self.num_constraints += 1
        # Idea 1: prune children whose numeric labels fall inside the
        # interval — they are unreachable now.
        dead = [k for k in node.children
                if k is not STAR and c.l < k < c.r]
        for k in dead:
            del node.children[k]

    def spec_node(self, prefix: tuple) -> _Node:
        """The full-equality specialization node for ``prefix`` (§4.8:
        cyclic queries cache into specialization branches)."""
        node = self.root
        for v in prefix:
            node = node.child(v, create=True)
        return node

    def generalizing(self, prefix) -> list[_Node]:
        """All depth-``len(prefix)`` nodes whose pattern generalizes
        ``prefix`` and that carry intervals (the principal filter G_i)."""
        nodes = [self.root]
        for v in prefix:
            nxt = []
            for nd in nodes:
                c = nd.children.get(v)
                if c is not None:
                    nxt.append(c)
                c = nd.children.get(STAR)
                if c is not None:
                    nxt.append(c)
            nodes = nxt
            if not nodes:
                return []
        return [nd for nd in nodes if len(nd.intervals)]


class Minesweeper:
    """Paper-faithful Minesweeper over sorted-array tries."""

    def __init__(self, query: Query, db: Database,
                 gao: tuple[str, ...] | None = None,
                 skip_probes: bool = True,   # Idea 4
                 use_skeleton: bool = True,  # Idea 7
                 plan: "JoinPlan | None" = None,
                 ):
        self.query = query
        self.db = db
        self.join_plan = plan
        if gao is None:
            gao = plan.gao if plan is not None else choose_gao(query)
        self.gao = tuple(gao)
        self.n = len(self.gao)
        self.var_pos = {v: i for i, v in enumerate(self.gao)}
        self.skip_probes = skip_probes
        # GAO-consistent index per atom.
        self.atom_perm = []
        self.atom_gao_pos = []  # GAO coordinate of each index column
        for a in query.atoms:
            perm = tuple(sorted(range(a.arity),
                                key=lambda i: self.var_pos[a.vars[i]]))
            self.atom_perm.append(perm)
            self.atom_gao_pos.append(
                tuple(self.var_pos[a.vars[i]] for i in perm))
        self.indexes = [db.indexed(a.rel, self.atom_perm[ai])
                        for ai, a in enumerate(query.atoms)]
        # Idea 7: β-acyclic skeleton (greedy, unary atoms first).
        self.in_skeleton = [True] * len(query.atoms)
        if use_skeleton and not is_beta_acyclic(Hypergraph.of(query)):
            chosen: list[int] = []
            order = sorted(range(len(query.atoms)),
                           key=lambda ai: (query.atoms[ai].arity, ai))
            for ai in order:
                trial = chosen + [ai]
                hg = Hypergraph(
                    query.variables,
                    tuple(frozenset(query.atoms[i].vars) for i in trial))
                if is_beta_acyclic(hg):
                    chosen.append(ai)
            self.in_skeleton = [ai in chosen
                                for ai in range(len(query.atoms))]
        # filters, applied as implicit constraints on free tuples
        self.filters = [(self.var_pos[f.left], self.var_pos[f.right])
                        for f in query.filters]
        # probes/gaps/... are native; rows_expanded / level_rows source
        # the unified schema (ENGINE_STATS_SOURCE_KEYS): each candidate
        # free tuple is one unit of expansion work, and the final GAO
        # level's observed cardinality is the output count
        self.stats = {"probes": 0, "gaps": 0, "outputs": 0,
                      "free_tuples": 0, "probe_skips": 0,
                      "rows_expanded": 0, "level_rows": {}}
        # Attributes range over the active domain [0, universe): any value
        # >= universe cannot participate in a join output, so the free-tuple
        # search treats it as exhausted.
        self.universe = max(1, db.domain_size)

    # -- gap probing (Idea 3) ------------------------------------------------
    def seek_gap(self, ai: int, t) -> Constraint | None:
        """Maximal gap box around free tuple ``t`` from atom ``ai`` — or
        ``None`` if the projection of ``t`` is present in the relation."""
        self.stats["probes"] += 1
        rel = self.indexes[ai]
        gao_pos = self.atom_gao_pos[ai]
        proj = [t[p] for p in gao_pos]
        lo, hi = rel.root_range()
        for j, v in enumerate(proj):
            l, r = rel.gap_around(lo, hi, j, v)
            if (l, r) != (v, v):
                # gap at column j: equalities before, interval at gao_pos[j]
                pattern: list = [STAR] * gao_pos[j]
                for jj in range(j):
                    pattern[gao_pos[jj]] = proj[jj]
                return Constraint(tuple(pattern), gao_pos[j], l, r)
            lo, hi = rel.child_range(lo, hi, j, v)
        return None

    # -- filter handling -------------------------------------------------
    def _filter_gap(self, t) -> Constraint | None:
        """Treat ``u < v`` symmetry filters as implicit relations: if
        t[v] <= t[u], the box (pattern = t[:u+1] equalities, interval
        (-inf, t[u]+1) at v's coordinate... ) is output-free."""
        for (u, v) in self.filters:
            lo_pos, hi_pos = min(u, v), max(u, v)
            violated = not (t[u] < t[v])
            if violated:
                pattern: list = [STAR] * hi_pos
                pattern[lo_pos] = t[lo_pos]
                if u < v:
                    # need t[v] > t[u]: rule out (-inf, t[u]] at coord v
                    return Constraint(tuple(pattern), v, NEG_INF, t[u] + 1)
                else:
                    # u > v in GAO: need t[u] < t[v] ... rule out values
                    # at coord u in [t[v], +inf)
                    return Constraint(tuple(pattern), u, t[v] - 1, POS_INF)
        return None

    # -- computeFreeTuple (Algorithms 4-6, generic-poset variant) -----------
    def _truncate(self, cds: CDS, node: _Node) -> bool:
        """Algorithm 6: rule out the first non-wildcard branch above
        ``node``.  Returns False if the whole space is exhausted."""
        while node.parent is not None:
            if node.label is not STAR:
                x = node.label
                node.parent.intervals.insert(x - 1, x + 1)
                if node.label in node.parent.children:
                    del node.parent.children[node.label]
                return True
            node = node.parent
        return False

    def _compute_free_tuple(self, cds: CDS, t: list[int]) -> bool:
        """Advance ``t`` (in place) to the next free tuple >= t; False if
        the output space is exhausted."""
        n = self.n
        depth = 0
        guard = 0
        while True:
            guard += 1
            if guard > 10_000_000:  # pragma: no cover
                raise RuntimeError("computeFreeTuple did not terminate")
            G = cds.generalizing(tuple(t[:depth]))
            x = t[depth]
            # fixpoint of next_free across all nodes in G (chain for NEO)
            y = x
            while True:
                y2 = y
                for nd in G:
                    y2 = nd.intervals.next_free(y2)
                if y2 == y:
                    break
                y = y2
            if y >= self.universe:
                y = POS_INF
            # Idea 5: cache merged knowledge into the chain's bottom node.
            # Caching at the bottom is sound only when G is a chain (always
            # the case for NEO GAOs on β-acyclic queries, Prop 4.2); for
            # general posets we cache into the full-equality specialization
            # branch instead (§4.8).
            if G and y > x:
                bottom = _chain_bottom(G) if len(G) > 1 else G[0]
                if bottom is None:
                    bottom = cds.spec_node(tuple(t[:depth]))
                bottom.intervals.insert(x - 1, y if y < POS_INF else POS_INF)
                if bottom.intervals.next_free(0) >= self.universe:
                    if not self._truncate(cds, bottom):
                        return False
                    depth = 0
                    continue
            if y >= POS_INF:
                # backtrack (Algorithm 4 line 6-9)
                if depth == 0:
                    return False
                depth -= 1
                t[depth] += 1
                for i in range(depth + 1, n):
                    t[i] = 0
                continue
            if y > x:
                t[depth] = y
                for i in range(depth + 1, n):
                    t[i] = 0
            if depth == n - 1:
                return True
            depth += 1

    # -- outer loop (Algorithm 3) -------------------------------------------
    def run(self, emit=None) -> int:
        n = self.n
        cds = CDS(n)
        t = [0] * n
        count = 0
        natoms = len(self.query.atoms)
        last_gap: list[Constraint | None] = [None] * natoms
        while self._compute_free_tuple(cds, t):
            self.stats["free_tuples"] += 1
            self.stats["rows_expanded"] += 1
            found_gap = False
            # implicit filter constraints first (cheap)
            fc = self._filter_gap(t)
            if fc is not None:
                cds.insert(fc)
                continue
            advance_to: Constraint | None = None
            for ai in range(natoms):
                prev = last_gap[ai]
                if self.skip_probes and prev is not None:
                    # Idea 4a: the previous gap's right endpoint is a value
                    # known to be *present* — if the gap was at the atom's
                    # last column and t sits exactly on that endpoint with
                    # the same pattern, the projection of t is in R: no gap.
                    if (prev.pos == self.atom_gao_pos[ai][-1]
                            and prev.r < POS_INF
                            and t[prev.pos] == prev.r
                            and prev.pattern_matches(t)):
                        self.stats["probe_skips"] += 1
                        continue
                    # Idea 4b: t still inside the previous gap (possible for
                    # non-skeleton atoms, whose gaps are not in the CDS).
                    if prev.matches(t):
                        self.stats["probe_skips"] += 1
                        found_gap = True
                        if advance_to is None:
                            advance_to = prev
                        continue
                c = self.seek_gap(ai, t)
                if c is None:
                    continue
                last_gap[ai] = c
                found_gap = True
                self.stats["gaps"] += 1
                if self.in_skeleton[ai]:
                    cds.insert(c)
                else:
                    # Idea 7: remember the gap to advance the frontier, but
                    # do not grow the CDS with cyclic-part constraints.
                    advance_to = c
            if advance_to is not None:
                self._advance_past(t, advance_to)
            if not found_gap:
                count += 1
                self.stats["outputs"] += 1
                if emit is not None:
                    emit(tuple(t))
                # Idea 2: move the frontier, do not insert a unit gap.
                t[n - 1] += 1
        self.stats["level_rows"][n - 1] = count
        return count

    def _advance_past(self, t: list[int], c: Constraint) -> None:
        d = c.pos
        if c.r < POS_INF:
            t[d] = c.r
            for i in range(d + 1, self.n):
                t[i] = 0
        else:
            # carry into the previous coordinate
            if d == 0:
                t[0] = POS_INF  # exhausts on next computeFreeTuple
                return
            t[d - 1] += 1
            for i in range(d, self.n):
                t[i] = 0

    def count(self) -> int:
        return self.run()

    def enumerate(self, limit: int | None = None) -> np.ndarray:
        """Output tuples: int64, columns in GAO order
        (``self.output_vars``), rows in lexicographic order; ``limit``
        truncates after the ordering (the shared engine contract — the
        moving frontier advances lexicographically, so emission order is
        already the sorted order)."""
        from .lftj_ref import _Done

        if limit is not None and limit <= 0:
            return np.zeros((0, self.n), dtype=np.int64)
        out: list[tuple[int, ...]] = []

        def emit(t):
            out.append(t)
            if limit is not None and len(out) >= limit:
                raise _Done

        try:
            self.run(emit)
        except _Done:
            pass
        return np.array(out, dtype=np.int64).reshape(-1, self.n)

    @property
    def output_vars(self) -> tuple[str, ...]:
        """Column order of :meth:`enumerate` (the GAO)."""
        return self.gao


def minesweeper_count(query: Query, db: Database,
                      gao: tuple[str, ...] | None = None, **kw) -> int:
    return Minesweeper(query, db, gao, **kw).count()
