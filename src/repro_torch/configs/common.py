"""What the configurations share: each family's input shapes and
architecture record, as the JAX package's ``repro.configs.common`` gives
them: the LM family (``LM_SHAPES``, ``LMArch`` and :func:`reduced_cfg`,
the small-width copy of an LM config), the GNN family (``GNN_SHAPES``,
``GNNArch``) and the recsys family (``RECSYS_SHAPES``, ``RecsysArch``).
Each record's ``smoke(device="cuda")`` runs its reduced model once on the
card, or on the CPU when the caller asks for it.

Each record's ``cell(shape_name, mesh)`` gives, per input shape, a
dry-run :class:`Cell`: the step function, its abstract arguments
(:func:`sds`: a shape and a dtype, no allocation) and their sharding
specs on a ``launch.mesh.Mesh`` (:func:`named`), with the JAX cell's
kind, skip reason, model FLOPs and donated arguments.
``launch.dryrun`` runs a cell's function once on fake tensors and counts
its cost: on one card the whole program, on a production mesh one
chip's, each argument a DTensor (:func:`place`) laid out by its
:class:`NamedSharding` (``layers.sharding``'s; ``shard_shape`` gives
its local shape, as JAX's does); a step takes its mesh from its
arguments' layout (``layers.sharding.mesh_of``), so one function serves
both.  Specs are tuples whose entries are an axis name, None or a tuple
of axis names, as ``PartitionSpec``s are.  :func:`named` takes a
``DeviceMesh`` as well as a record: ``named(dmesh, param_specs(cfg))``
is the sharding tree ``train.checkpoint``'s ``restore(...,
shardings=)`` lays a checkpoint out by.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..device import resolve_device
from ..layers.sharding import NamedSharding, mesh_of, placements
from ..models import transformer as tfm
from ..models import xdeepfm as xdf
from ..models.gnn import data as gnn_data
from ..models.transformer import TransformerConfig
from ..models.xdeepfm import XDeepFMConfig
from ..train.loop import make_train_step, value_and_grad
from ..train.optimizer import OptimizerConfig
from ..train.tree import tree_map


@dataclass(frozen=True)
class ShapeDtype:
    """An abstract argument: a shape and a torch dtype
    (``jax.ShapeDtypeStruct``).  :meth:`fake` makes a tensor of it under
    a ``FakeTensorMode``, when the dry run asks for one."""

    shape: tuple
    dtype: torch.dtype

    def fake(self, mode) -> torch.Tensor:
        """A tensor of this shape and dtype under ``mode`` (a
        ``FakeTensorMode``: no memory), on the CPU."""
        with mode:
            return torch.empty(self.shape, dtype=self.dtype)


def sds(shape, dtype: torch.dtype) -> ShapeDtype:
    return ShapeDtype(tuple(int(s) for s in shape), dtype)


@dataclass
class Cell:
    arch: str
    shape_name: str
    kind: str                      # train | prefill | decode | forward
    fn: Callable | None
    args: tuple
    in_shardings: Any = None
    out_shardings: Any = None
    note: str = ""
    skip: str | None = None       # reason when the cell is n/a
    model_flops: float = 0.0      # 6·N·D (or family equivalent)
    donate: tuple = ()            # argnums donated (state in == state out)
    # the layers the JAX cell scans (its cost probes extrapolate from 1
    # and 2 of them); the port's eager step runs every layer, so its dry
    # run counts them all and needs no probe
    n_scan: int = 0


def place(local: torch.Tensor, sharding: NamedSharding | None, dmesh,
          global_shape) -> torch.Tensor:
    """``local``, one chip's shard of a ``global_shape`` array, as a
    DTensor on ``dmesh`` laid out as ``sharding`` says (replicated where
    it is None)."""
    from torch.distributed.tensor import DTensor
    spec = () if sharding is None else sharding.spec
    stride = torch.empty(tuple(global_shape), device="meta").stride()
    return DTensor.from_local(local, dmesh, placements(dmesh, spec),
                              run_check=False, shape=tuple(global_shape),
                              stride=stride)


def _is_spec(x) -> bool:
    """A spec is a tuple whose entries are each None, an axis name or a
    tuple of axis names; a tuple holding anything else is a container."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def _canonical(spec: tuple) -> tuple:
    """``spec`` as ``PartitionSpec`` normalizes it: an entry of one axis
    name is that name, an empty entry None."""
    return tuple(e if not isinstance(e, tuple) else
                 None if not e else e[0] if len(e) == 1 else e
                 for e in spec)


def named(mesh, spec_tree):
    """``spec_tree`` with each spec made a :class:`NamedSharding` on
    ``mesh`` (its entries normalized as ``PartitionSpec`` normalizes
    them); None without a mesh."""
    if mesh is None:
        return None

    def walk(node):
        if node is None:
            return None
        if _is_spec(node):
            return NamedSharding(mesh, _canonical(node))
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        raise TypeError(f"named: {node!r} is not a spec")

    return walk(spec_tree)


def _dataxes(mesh):
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def _abstract(make):
    """The tree ``make()`` returns, run on fake tensors (no memory), as
    :class:`ShapeDtype` leaves: ``jax.eval_shape`` of an init."""
    with FakeTensorMode():
        tree = make()
    return tree_map(lambda t: sds(t.shape, t.dtype), tree)


def _abstract_opt(params):
    """``init_opt_state``'s tree for ``params``: float32 moments and an
    int32 step."""
    moment = lambda p: sds(p.shape, torch.float32)
    return {"m": tree_map(moment, params), "v": tree_map(moment, params),
            "step": sds((), torch.int32)}


def _generator():
    return torch.Generator(device="cpu").manual_seed(0)


def _finite(arch_id: str, loss: torch.Tensor, grads) -> None:
    """Raise unless the loss and every gradient leaf are finite."""
    if not bool(torch.isfinite(loss)):
        raise FloatingPointError(f"{arch_id}: loss {loss}")
    for gr in grads:
        if not bool(torch.isfinite(gr).all()):
            raise FloatingPointError(f"{arch_id}: a gradient is not "
                                     "finite")


def reduced_cfg(cfg: TransformerConfig) -> TransformerConfig:
    """The JAX package's ``LMArch.reduced_cfg``: two layers, d_model 64,
    4 heads of 16 dims, at most 4 KV heads, d_ff 128, vocab 512, float32,
    a 64-token cache; an MoE config keeps 8 experts, ``min(2, top_k)``
    picks, expert width 64 and at most one shared expert."""
    moe = cfg.moe
    if moe is not None:
        moe = replace(moe, n_experts=8, top_k=min(2, moe.top_k),
                      d_ff_expert=64,
                      n_shared_experts=min(1, moe.n_shared_experts))
    return replace(
        cfg, n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=max(1, min(4, cfg.n_kv_heads)), d_head=16, d_ff=128,
        vocab_size=512, moe=moe, dtype=torch.float32, fsdp=False,
        seq_shard=False, loss_seq_chunk=0, max_cache_len=64)


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

#: the JAX package's LM input shapes (``repro.configs.common.LM_SHAPES``)
LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


@dataclass
class LMArch:
    """An LM architecture as the JAX package's ``LMArch`` gives it: the
    config, the train step's microbatches,
    whether every layer attends to the whole context (``long_500k`` is
    then skipped), its shapes and the §Perf ``opt_variants`` (extra shape
    name -> ``(base shape, cfg overrides[, extras])``, merged into
    ``shapes``)."""

    arch_id: str
    cfg: TransformerConfig
    microbatches: int = 1
    full_attention: bool = True
    shapes: dict = field(default_factory=lambda: dict(LM_SHAPES))
    opt_variants: dict = field(default_factory=dict)

    family = "lm"

    def __post_init__(self):
        for name, spec in self.opt_variants.items():
            self.shapes[name] = dict(self.shapes[spec[0]], base=spec[0])

    def reduced_cfg(self) -> TransformerConfig:
        return reduced_cfg(self.cfg)

    def cell(self, shape_name: str, mesh) -> Cell:
        cfg = self.cfg
        micro = self.microbatches
        extras = {}
        if shape_name in self.opt_variants:
            spec = self.opt_variants[shape_name]
            cfg = replace(cfg, **spec[1])
            extras = spec[2] if len(spec) > 2 else {}
            micro = extras.get("microbatches", micro)
        c = self._cell_inner(shape_name, mesh, cfg, micro)
        if extras.get("donate") and c.skip is None:
            c.donate = (0, 1) if c.kind == "train" else (1,)
        if c.skip is None and cfg.n_layers > 2:
            c.n_scan = cfg.n_layers
        return c

    def _cell_inner(self, shape_name: str, mesh, cfg: TransformerConfig,
                    microbatches: int) -> Cell:
        sh = self.shapes[shape_name]
        if shape_name == "long_500k" and self.full_attention:
            return Cell(self.arch_id, shape_name, sh["kind"], None, (),
                        skip="pure full-attention arch: 500k decode needs "
                             "sub-quadratic attention (see DESIGN.md)")
        seq, batch = sh["seq"], sh["batch"]
        pspecs = tfm.param_specs(cfg)
        params = _abstract(lambda: tfm.init_params(cfg, _generator(),
                                                   device="cpu"))
        psh = named(mesh, pspecs)
        dax = _dataxes(mesh)
        mf = 6.0 * cfg.n_active_params * batch * seq
        if sh["kind"] == "train":
            opt = _abstract_opt(params)
            opt_sh = named(mesh, {"m": pspecs, "v": pspecs, "step": ()})
            batch_abs = {"tokens": sds((batch, seq), torch.int32),
                         "labels": sds((batch, seq), torch.int32)}
            bsh = named(mesh, {"tokens": (dax, None),
                               "labels": (dax, None)})
            step = make_train_step(
                lambda p, b: tfm.loss_fn(p, b, cfg,
                                         mesh=mesh_of(b["tokens"])),
                OptimizerConfig(), microbatches)
            return Cell(self.arch_id, shape_name, "train", step,
                        (params, opt, batch_abs),
                        in_shardings=(psh, opt_sh, bsh),
                        out_shardings=(psh, opt_sh, None),
                        model_flops=mf)
        if sh["kind"] == "prefill":
            toks = sds((batch, seq), torch.int32)
            csp = tfm.cache_specs(cfg, mesh)
            fn = lambda p, t: tfm.prefill(p, t, cfg, max_len=seq,
                                          mesh=mesh_of(t))
            out_sh = (named(mesh, csp), named(mesh, (dax, None, "model")))
            return Cell(self.arch_id, shape_name, "prefill", fn,
                        (params, toks),
                        in_shardings=(psh, named(mesh, (dax, None))),
                        out_shardings=out_sh,
                        model_flops=2.0 * cfg.n_active_params * batch * seq)
        # decode: one new token against a seq-length cache
        csp = tfm.cache_specs(cfg, mesh)
        kv = sds((cfg.n_layers, batch, cfg.n_kv_heads, seq, cfg.head_dim),
                 cfg.dtype)
        cache = {"k": kv, "v": kv, "len": sds((), torch.int32)}
        toks = sds((batch, 1), torch.int32)
        fn = lambda p, c, t: tfm.decode_step(p, c, t, cfg, mesh=mesh_of(t))
        return Cell(self.arch_id, shape_name, "decode", fn,
                    (params, cache, toks),
                    in_shardings=(psh, named(mesh, csp),
                                  named(mesh, (dax, None))),
                    out_shardings=(named(mesh, (dax, None, "model")),
                                   named(mesh, csp)),
                    model_flops=2.0 * cfg.n_active_params * batch)

    def smoke(self, device: torch.device | str = "cuda") -> dict:
        """The reduced config's loss and gradient on 2 × 16 random
        tokens, a prefill and one decode step: every value finite and
        the logits (2, 1, vocab)."""
        dev = resolve_device(device, "LMArch.smoke")
        cfg = self.reduced_cfg()
        gen = torch.Generator(device=dev).manual_seed(0)
        p = tfm.init_params(cfg, gen, device=dev)
        toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen,
                             device=dev)
        batch = {"tokens": toks, "labels": toks}
        loss, grads = value_and_grad(
            lambda pp, b: tfm.loss_fn(pp, b, cfg), p, batch)
        _finite(self.arch_id, loss, grads)
        cache, logits = tfm.prefill(p, toks, cfg, max_len=32)
        if tuple(logits.shape) != (2, 1, cfg.vocab_size):
            raise ValueError(f"{self.arch_id}: prefill logits "
                             f"{tuple(logits.shape)}")
        lg, _ = tfm.decode_step(p, cache, toks[:, :1], cfg)
        if tuple(lg.shape) != (2, 1, cfg.vocab_size) or not bool(
                torch.isfinite(lg).all()):
            raise FloatingPointError(f"{self.arch_id}: decode logits "
                                     f"{tuple(lg.shape)} not finite")
        return {"loss": float(loss)}


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------

#: the JAX package's GNN input shapes (``repro.configs.common.GNN_SHAPES``):
#: Cora's sizes, Reddit sampled in two hops, ogbn-products, and batches of
#: small molecules (``n_edges`` undirected; the graphs are symmetrized)
GNN_SHAPES = {
    "full_graph_sm": dict(kind="train", n_nodes=2708, n_edges=10556,
                          d_feat=1433),
    "minibatch_lg": dict(kind="train", n_nodes=232965, n_edges=114615892,
                         batch_nodes=1024, fanouts=(15, 10), d_feat=602),
    "ogb_products": dict(kind="train", n_nodes=2449029, n_edges=61859140,
                         d_feat=100),
    "molecule": dict(kind="train", n_nodes=30, n_edges=64, batch=128,
                     d_feat=16),
}


@dataclass
class GNNArch:
    """A GNN architecture as the JAX package's ``GNNArch`` gives it:
    ``make_cfg(d_in, n_classes)``,
    ``init_fn(cfg, generator, device)`` (the port's order, as the
    transformer's ``init_params``), ``loss_fn(params, GraphBatch, cfg)``,
    its shapes and the §Perf ``opt_variants`` (extra shape name ->
    ``(base shape, cfg overrides[, shape extras])``, merged into
    ``shapes``)."""

    arch_id: str
    make_cfg: Callable[[int, int], Any]   # (d_in, n_classes) -> cfg
    init_fn: Callable
    loss_fn: Callable                     # (params, GraphBatch, cfg)
    needs_coords: bool = False
    scan_layers: bool = False             # the JAX package scans layers
    shapes: dict = field(default_factory=lambda: dict(GNN_SHAPES))
    opt_variants: dict = field(default_factory=dict)

    family = "gnn"

    def __post_init__(self):
        for name, spec in self.opt_variants.items():
            extra = spec[2] if len(spec) > 2 else {}
            self.shapes[name] = dict(self.shapes[spec[0]], base=spec[0],
                                     **extra)

    def _batch_abs(self, shape_name: str):
        sh = self.shapes[shape_name]
        if shape_name == "minibatch_lg":
            b, f1, f2 = sh["batch_nodes"], *sh["fanouts"]
            n = b + b * f1 + b * f1 * f2
            e = 2 * (b * f1 + b * f1 * f2)
            n_graphs = 1
        elif shape_name == "molecule":
            n = sh["n_nodes"] * sh["batch"]
            e = 2 * sh["n_edges"] * sh["batch"]
            n_graphs = sh["batch"]
        else:
            n, e = sh["n_nodes"], 2 * sh["n_edges"]
            n_graphs = 1
        # edge arrays shard over (pod, data): pad to the 512 = lcm(32, 16)
        # boundary (dummy self-loops on the sink node, as pad_graph does)
        e = -(-e // 512) * 512
        if sh.get("pad_nodes"):  # node-sharded variants need divisibility
            n = -(-n // 512) * 512
        d = sh["d_feat"]
        batch = {
            "src": sds((e,), torch.int32),
            "dst": sds((e,), torch.int32),
            "node_feat": sds((n, d), torch.float32),
            "labels": sds((n,), torch.int32),
        }
        if self.needs_coords:
            batch["coords"] = sds((n, 3), torch.float32)
            batch["graph_id"] = sds((n,), torch.int32)
        return batch, n, e, n_graphs, d

    def _to_graph(self, batch: dict, n: int, n_graphs: int):
        return gnn_data.GraphBatch(
            src=batch["src"], dst=batch["dst"], n_nodes=n,
            node_feat=batch["node_feat"], labels=batch["labels"],
            coords=batch.get("coords"), graph_id=batch.get("graph_id"),
            n_graphs=n_graphs)

    def cell(self, shape_name: str, mesh) -> Cell:
        cfg0 = self.make_cfg(self.shapes[shape_name]["d_feat"], 16)
        if shape_name in self.opt_variants:
            cfg0 = replace(cfg0, **self.opt_variants[shape_name][1])
        c = self._cell_inner(shape_name, mesh, cfg0)
        if self.scan_layers and getattr(cfg0, "n_layers", 0) > 2:
            c.n_scan = cfg0.n_layers
        return c

    def _cell_inner(self, shape_name: str, mesh, cfg) -> Cell:
        batch_abs, n, e, n_graphs, d = self._batch_abs(shape_name)
        params = _abstract(lambda: self.init_fn(cfg, _generator(),
                                                device="cpu"))
        opt = _abstract_opt(params)
        dax = _dataxes(mesh)
        bsp = {k: ((dax,) if k in ("src", "dst") else ())
               for k in batch_abs}
        step = make_train_step(
            lambda p, b: self.loss_fn(p, self._to_graph(b, n, n_graphs),
                                      cfg), OptimizerConfig())
        rep = tree_map(lambda _: (), params)
        osh = {"m": rep, "v": rep, "step": ()}
        # message FLOPs estimate: edges x d x d per layer x 3 passes (fwd+bwd)
        layers = getattr(cfg, "n_layers", 2)
        dh = getattr(cfg, "d_hidden", 64)
        mf = 6.0 * e * dh * dh * layers
        return Cell(self.arch_id, shape_name, "train", step,
                    (params, opt, batch_abs),
                    in_shardings=(named(mesh, rep), named(mesh, osh),
                                  named(mesh, bsp)),
                    out_shardings=(named(mesh, rep), named(mesh, osh),
                                   None),
                    model_flops=mf)

    def smoke(self, device: torch.device | str = "cuda") -> dict:
        """One loss and gradient of the full-width config on a 64-node
        graph of 4 batched molecules; every value finite."""
        dev = resolve_device(device, "GNNArch.smoke")
        g = gnn_data.random_graph_batch(64, 256, 16, seed=0, coords=True,
                                        n_graphs=4, n_classes=16).to(dev)
        cfg = self.make_cfg(16, 16)
        p = self.init_fn(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
        loss, grads = value_and_grad(
            lambda pp, _: self.loss_fn(pp, g, cfg), p, None)
        _finite(self.arch_id, loss, grads)
        return {"loss": float(loss)}


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------

#: the JAX package's recsys input shapes
#: (``repro.configs.common.RECSYS_SHAPES``)
RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="forward", batch=512),
    "serve_bulk": dict(kind="forward", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1,
                           n_candidates=1_000_000),
}


@dataclass
class RecsysArch:
    """A recsys architecture (xDeepFM) as the JAX package's
    ``RecsysArch`` gives it."""

    arch_id: str
    cfg: XDeepFMConfig
    shapes: dict = field(default_factory=lambda: dict(RECSYS_SHAPES))

    family = "recsys"

    def reduced_cfg(self) -> XDeepFMConfig:
        return replace(self.cfg, vocab_per_field=1000,
                       cin_layers=(16, 16), mlp_dims=(32, 32))

    def cell(self, shape_name: str, mesh) -> Cell:
        sh = self.shapes[shape_name]
        cfg = self.cfg
        params = _abstract(lambda: xdf.init_xdeepfm(cfg, _generator(),
                                                    device="cpu"))
        pspec = tree_map(lambda _: (), params)
        pspec["embed"] = ("model", None)      # row-sharded table
        pspec["linear"] = ("model", None)
        psh = named(mesh, pspec)
        dax = _dataxes(mesh)
        f = cfg.n_sparse
        d = cfg.embed_dim
        cin_fl = sum(cfg.cin_layers) * f * d * 200  # rough per-sample
        if sh["kind"] == "train":
            b = sh["batch"]
            batch_abs = {"ids": sds((b, f), torch.int32),
                         "labels": sds((b,), torch.int32)}
            opt = _abstract_opt(params)
            osh = named(mesh, {"m": pspec, "v": pspec, "step": ()})
            step = make_train_step(
                lambda p, bb: xdf.xdeepfm_loss(p, bb, cfg),
                OptimizerConfig())
            return Cell(self.arch_id, shape_name, "train", step,
                        (params, opt, batch_abs),
                        in_shardings=(psh, osh,
                                      named(mesh, {"ids": (dax, None),
                                                   "labels": (dax,)})),
                        out_shardings=(psh, osh, None),
                        model_flops=6.0 * sh["batch"] * cin_fl)
        if sh["kind"] == "forward":
            b = sh["batch"]
            ids = sds((b, f), torch.int32)
            fn = lambda p, i: xdf.xdeepfm_forward(p, i, cfg)
            return Cell(self.arch_id, shape_name, "forward", fn,
                        (params, ids),
                        in_shardings=(psh, named(mesh, (dax, None))),
                        out_shardings=named(mesh, (dax,)),
                        model_flops=2.0 * b * cin_fl)
        # retrieval: 1 query x 1M candidates
        nc = sh["n_candidates"]
        fn = lambda p, q, c: xdf.retrieval_scores(p, q, c, cfg)
        return Cell(self.arch_id, shape_name, "retrieval", fn,
                    (params, sds((1, f), torch.int32),
                     sds((nc,), torch.int32)),
                    in_shardings=(psh, named(mesh, (None, None)),
                                  named(mesh, (dax,))),
                    out_shardings=named(mesh, (dax,)),
                    model_flops=2.0 * nc * d)

    def smoke(self, device: torch.device | str = "cuda") -> dict:
        """The reduced config's loss and gradient on 32 random rows, and
        one query scored against 100 candidates: every value finite."""
        dev = resolve_device(device, "RecsysArch.smoke")
        cfg = self.reduced_cfg()
        gen = torch.Generator(device=dev).manual_seed(0)
        p = xdf.init_xdeepfm(cfg, gen, device=dev)
        ids = torch.randint(0, cfg.vocab_per_field, (32, cfg.n_sparse),
                            generator=gen, device=dev)
        batch = {"ids": ids,
                 "labels": torch.zeros(32, dtype=torch.int32, device=dev)}
        loss, grads = value_and_grad(
            lambda pp, b: xdf.xdeepfm_loss(pp, b, cfg), p, batch)
        _finite(self.arch_id, loss, grads)
        s = xdf.retrieval_scores(p, ids[:1], torch.arange(100, device=dev),
                                 cfg)
        if not bool(torch.isfinite(s).all()):
            raise FloatingPointError(f"{self.arch_id}: retrieval scores "
                                     "not finite")
        return {"loss": float(loss)}
