"""Backward-expansion enumeration for the message-passing engines (the
port of ``repro.results.backward``).

The counting engines (``core/yannakakis.py``, the tree half of
``core/hybrid.py``) collapse sub-pattern bindings into per-node tallies
on the way *up* the variable tree — which is exactly why they could only
count.  Enumeration runs the passes backward ("Old Techniques for New
Join Algorithms": Yannakakis' downward semijoin pass gives dangling-free
enumeration for the acyclic parts):

* **yannakakis** — the upward messages, re-run as boolean semijoins
  (``CountingYannakakis.semijoin_reduce``), leave per-variable active
  sets in which *every* value extends to a full output tuple.  The
  reduced domains are attached to the query as unary predicates and a
  guided vectorized-LFTJ descent materializes the tuples — every
  frontier row survives to the end, so the expansion does no wasted
  work (the classic zero-dangling-intermediates property).

* **hybrid** — the tree part's root message seeds the cyclic core as in
  counting, the core is enumerated by vectorized LFTJ, and the tree
  bindings behind each attachment value are expanded backward with the
  yannakakis path above, restricted to the attachment values the core
  actually produced.  Core tuples and tree expansions are then glued by
  a segmented product per attachment value — the factorized structure
  (tree bindings depend on the core only through the attachment) is
  what makes the join linear in the output.
"""
from __future__ import annotations

import numpy as np

from ..core.device_graph import GraphDB
from ..core.plan import JoinPlan
from ..core.query import Atom, Query
from ..core.vlftj import VLFTJ
from ..core.yannakakis import CountingYannakakis


def _restricted(query: Query, gdb: GraphDB,
                active: dict[str, np.ndarray],
                tag: str) -> tuple[Query, GraphDB]:
    """Attach per-variable active-value sets as unary predicates.

    The derived :class:`GraphDB` lives on the parent's device and shares
    its CSR and cached device tensors (bitmaps for the new predicates are
    built lazily on a copied cache, so the parent is never polluted)."""
    unary = dict(gdb.unary)
    atoms = list(query.atoms)
    for var, ids in active.items():
        name = f"__{tag}_{var}"
        unary[name] = np.asarray(ids)
        atoms.append(Atom(name, (var,)))
    q2 = Query(tuple(atoms), query.filters, f"{query.name}+{tag}")
    return q2, GraphDB(gdb.csr, unary, device=gdb.device, edges=gdb.edges,
                       _dev=dict(gdb._dev))


def yannakakis_rows(engine: CountingYannakakis
                    ) -> tuple[np.ndarray, tuple[str, ...]]:
    """Backward-expansion enumeration: ``(rows, columns)`` with rows
    int64, lex-sorted, columns = ``engine.gao`` (full variable cover)."""
    gao = engine.gao
    active = {v: np.flatnonzero(m)
              for v, m in engine.semijoin_reduce().items()}
    if any(ids.shape[0] == 0 for ids in active.values()):
        return np.zeros((0, len(gao)), dtype=np.int64), gao
    q2, gdb2 = _restricted(engine.query, engine.gdb, active, "act")
    plan2 = JoinPlan(query=q2, engine="vlftj", gao=gao)
    return VLFTJ(q2, gdb2, plan=plan2).enumerate(), gao


def _group_starts(sorted_keys: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(unique, start, count) over a sorted 1-D key array."""
    if sorted_keys.shape[0] == 0:
        z = np.zeros(0, dtype=np.int64)
        return sorted_keys, z, z
    change = np.empty(sorted_keys.shape[0], dtype=bool)
    change[0] = True
    change[1:] = sorted_keys[1:] != sorted_keys[:-1]
    start = np.flatnonzero(change).astype(np.int64)
    count = np.diff(np.append(start, sorted_keys.shape[0]))
    return sorted_keys[start], start, count


def hybrid_rows(hj) -> tuple[np.ndarray, tuple[str, ...]]:
    """Enumerate a :class:`~repro_torch.core.hybrid.HybridJoin`'s full output:
    ``(rows, columns)``, rows int64 (unsorted — callers order), columns =
    core GAO followed by the tree variables (attachment deduplicated)."""
    plan = hj.join_plan
    d = plan.decomposition
    if d is None:
        # unsupported shape: plain vectorized LFTJ, like count()
        if hj._core_plan is not None:
            ex = VLFTJ(hj.query, hj.gdb, plan=hj._core_plan, **hj.vlftj_kw)
        else:
            ex = VLFTJ(hj.query, hj.gdb, **hj.vlftj_kw)
        return ex.enumerate(), ex.gao
    # 1) tree part: attachment values with at least one tree expansion
    cy = CountingYannakakis(d.tree_query, hj.gdb, root=d.attachment)
    msg = cy.message_to_root(d.attachment).cpu().numpy()
    seeds = np.flatnonzero(msg > 0).astype(np.int32)
    tree_vars_rest: tuple[str, ...] = tuple(
        v for v in d.tree_query.variables if v != d.attachment)
    columns = d.core_gao + tree_vars_rest
    if seeds.shape[0] == 0:
        return np.zeros((0, len(columns)), dtype=np.int64), columns
    # 2) cyclic core, seeded (attachment is the first core-GAO variable)
    core = VLFTJ(d.core_query, hj.gdb, plan=hj._core_plan, **hj.vlftj_kw)
    core_rows = core.enumerate(seeds=seeds)
    if core_rows.shape[0] == 0:
        return np.zeros((0, len(columns)), dtype=np.int64), columns
    # 3) tree bindings behind each attachment value the core produced
    att_vals = np.unique(core_rows[:, 0])
    tq2, tgdb = _restricted(d.tree_query, hj.gdb,
                            {d.attachment: att_vals}, "core")
    tree_rows, tree_gao = yannakakis_rows(
        CountingYannakakis(tq2, tgdb, root=d.attachment))
    # 4) segmented product per attachment value
    aj = tree_gao.index(d.attachment)
    tr = tree_rows[np.argsort(tree_rows[:, aj], kind="stable")]
    uvals, start, count = _group_starts(tr[:, aj])
    gi = np.searchsorted(uvals, core_rows[:, 0])
    sizes = count[gi]
    total = int(sizes.sum())
    reps = np.repeat(np.arange(core_rows.shape[0]), sizes)
    offs = np.repeat(np.cumsum(sizes) - sizes, sizes)
    within = np.arange(total) - offs
    tidx = start[gi][reps] + within
    rest_cols = [c for c, v in enumerate(tree_gao) if v != d.attachment]
    rest_order = [tree_gao[c] for c in rest_cols]
    perm = [rest_order.index(v) for v in tree_vars_rest]
    rows = np.concatenate(
        [core_rows[reps], tr[tidx][:, rest_cols][:, perm]], axis=1)
    return rows, columns
