"""Carry the JAX package's data and plans across to the port.

The two packages never import each other, so what crosses is plain:
numpy arrays, strings and tuples.  :func:`gdb_from_arrays` builds the
port's ``GraphDB``/``HybridGraphDB`` from a reference db's host arrays,
and :func:`plan_from_fields` the port's ``JoinPlan`` from a reference
plan's fields, so both packages can run on the very same data and plan.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.device_graph import GraphDB, HybridGraphDB
from .core.plan import HybridPlan, JoinPlan
from .core.query import Query, parse
from .graphs.csr import CSRGraph
from .graphs.layout import HybridLayout


def gdb_from_arrays(indptr, indices, unary, *, layout_words=None,
                    order=None, min_degree: int | None = None,
                    device: torch.device | str) -> GraphDB:
    """A port graph db over the given CSR arrays and unary id sets.

    With ``layout_words`` (the reference layout's ``(n_hubs, n_words)``
    uint32 bitset rows, hubs being the id prefix) the result is a
    :class:`HybridGraphDB`; ``order`` is its new-id -> old-id map
    (identity when omitted) and ``min_degree`` the layout's hub
    threshold (default: the smallest hub degree).  The arrays are taken
    as they are — a renumbered reference db yields the same renumbered
    port db."""
    indptr = np.asarray(indptr, dtype=np.int64)
    csr = CSRGraph(indptr=indptr, indices=np.asarray(indices, np.int64),
                   n_nodes=indptr.shape[0] - 1)
    unary = {k: np.asarray(v, dtype=np.int64) for k, v in unary.items()}
    if layout_words is None:
        return GraphDB(csr, unary, device=device)
    words = np.asarray(layout_words, dtype=np.uint32)
    n_hubs = words.shape[0]
    if min_degree is None:
        min_degree = int(csr.degrees[:n_hubs].min()) if n_hubs else 0
    layout = HybridLayout(n_nodes=csr.n_nodes, n_hubs=n_hubs,
                          n_words=words.shape[1], min_degree=min_degree,
                          words=words)
    order = (np.arange(csr.n_nodes, dtype=np.int64) if order is None
             else np.asarray(order, dtype=np.int64))
    inv = np.empty_like(order)
    inv[order] = np.arange(order.shape[0])
    return HybridGraphDB(csr=csr, unary=unary, device=device, layout=layout,
                         order=order, new_of_old=inv)


def query_from_text(text: str | Query) -> Query:
    """A port query from ``str(query)`` of either package
    (``"name: edge(a, b), ..., a<b"``)."""
    if isinstance(text, Query):
        return text
    name, _, body = text.partition(": ")
    return parse(body, name)


def plan_from_fields(query, engine: str, gao, *, level_layouts=(),
                     root: str | None = None,
                     decomposition=None) -> JoinPlan:
    """A port plan from a reference plan's fields.

    ``query`` is ``str(plan.query)`` (or a port :class:`Query`);
    ``decomposition`` is ``None`` or ``(str(tree_query), str(core_query),
    attachment, core_gao)``.  Per-level constraint sets are recompiled
    from the query and GAO, as the reference's plan does."""
    hp = None
    if decomposition is not None:
        tree, core, attachment, core_gao = decomposition
        hp = HybridPlan(query_from_text(tree), query_from_text(core),
                        attachment, tuple(core_gao))
    return JoinPlan(query=query_from_text(query), engine=engine,
                    gao=tuple(gao), decomposition=hp, root=root,
                    level_layouts=tuple(level_layouts))
