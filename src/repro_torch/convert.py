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
from .device import resolve_device
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


def transformer_params_from_numpy(params: dict, cfg, *,
                                  device: torch.device | str) -> dict:
    """The port's transformer parameters from the JAX package's, given as
    a dict of numpy arrays (``{k: np.asarray(v) ...}``; an MoE config's
    ``"moe"`` entry a dict of them too; bf16 arrives as
    ``ml_dtypes.bfloat16`` and goes through float32).  Each keeps its
    dtype and shape, but the MoE router is float32 whatever it arrives
    as (the JAX package computes its logits in float32); names and
    shapes must be those of ``models.transformer.init_params`` for
    ``cfg``, at both levels."""
    from .models.transformer import param_shapes

    def convert(tree: dict, shapes: dict, where: str) -> dict:
        if set(tree) != set(shapes):
            raise ValueError(f"{where}parameter names {sorted(tree)} != "
                             f"{sorted(shapes)}")
        out = {}
        for name, a in tree.items():
            if isinstance(shapes[name], dict):
                if not isinstance(a, dict):
                    raise ValueError(f"{where}{name}: a dict of arrays "
                                     "expected")
                out[name] = convert(a, shapes[name], f"{where}{name}/")
                continue
            a = np.asarray(a)
            if tuple(a.shape) != shapes[name]:
                raise ValueError(f"{where}{name}: shape {a.shape} != "
                                 f"{shapes[name]}")
            bf16 = a.dtype.name == "bfloat16"
            t = torch.from_numpy(
                np.array(a, dtype=np.float32 if bf16 else a.dtype))
            dtype = (torch.float32 if name == "router" else
                     torch.bfloat16 if bf16 else t.dtype)
            out[name] = t.to(device=device, dtype=dtype)
        return out

    return convert(params, param_shapes(cfg), "")


def opt_state_from_numpy(state: dict, cfg, *, device: torch.device | str
                         ) -> dict:
    """The port's optimizer state (``train.optimizer.init_opt_state``'s
    layout) from the JAX package's, given as numpy arrays: ``m`` and
    ``v`` trees of the parameters' names and shapes for ``cfg`` (float32,
    kept as they are), and the int32 ``step``."""
    moments = {key: transformer_params_from_numpy(state[key], cfg,
                                                  device=device)
               for key in ("m", "v")}
    return {**moments, "step": torch.tensor(
        int(np.asarray(state["step"])), dtype=torch.int32, device=device)}


def gnn_params_from_numpy(params, *, device: torch.device | str = "cuda"):
    """The port's GNN parameters from the JAX package's
    (``jax.tree.map(np.asarray, params)`` of ``init_gatedgcn``,
    ``init_pna``, ``init_egnn`` or ``init_mace``): the same tree of
    dicts and lists (EGNN's and MACE's ``"layers"`` stay lists), each
    leaf a tensor of its dtype and shape on ``device``.  Raises without
    a card unless ``device`` is the CPU."""
    return _tree_from_numpy(params,
                            resolve_device(device, "gnn_params_from_numpy"))


#: the top-level names of the JAX package's ``init_xdeepfm`` tree
XDEEPFM_PARAM_NAMES = ("embed", "linear", "cin", "mlp", "out_mlp", "out_cin")


def xdeepfm_params_from_numpy(params, *, device: torch.device | str):
    """The port's xDeepFM parameters from the JAX package's
    (``jax.tree.map(np.asarray, init_xdeepfm(key, cfg))``): the same dict
    of ``embed``, ``linear``, the ``cin`` list, the ``mlp`` list of
    ``{"w", "b"}`` and the two output columns, each leaf a float32
    tensor of its shape on ``device``.  Raises without a card unless
    ``device`` is the CPU."""
    if set(params) != set(XDEEPFM_PARAM_NAMES):
        raise ValueError(f"xDeepFM parameter names {sorted(params)} != "
                         f"{sorted(XDEEPFM_PARAM_NAMES)}")
    return _tree_from_numpy(
        params, resolve_device(device, "xdeepfm_params_from_numpy"))


def _tree_from_numpy(node, dev: torch.device):
    """A tree of dicts and lists of numpy arrays as the same tree of
    tensors on ``dev``, each of its array's dtype and shape."""
    if isinstance(node, dict):
        return {k: _tree_from_numpy(v, dev) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_tree_from_numpy(v, dev) for v in node]
    return torch.from_numpy(np.array(node)).to(dev)
