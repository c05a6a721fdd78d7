"""What the configurations share: the small-width copy of an LM config,
and the GNN family's shapes and architecture record (``GNNArch``)."""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable

import torch

from ..device import resolve_device
from ..models.transformer import TransformerConfig


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
    """A GNN architecture as the JAX package's ``GNNArch`` gives it, less
    its XLA dry-run cells: ``make_cfg(d_in, n_classes)``,
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

    def smoke(self, device: torch.device | str = "cuda") -> dict:
        """One loss and gradient of the full-width config on a 64-node
        graph of 4 batched molecules; every value finite."""
        from ..models.gnn.data import random_graph_batch
        from ..train.loop import value_and_grad
        dev = resolve_device(device, "GNNArch.smoke")
        g = random_graph_batch(64, 256, 16, seed=0, coords=True, n_graphs=4,
                               n_classes=16).to(dev)
        cfg = self.make_cfg(16, 16)
        p = self.init_fn(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
        loss, grads = value_and_grad(
            lambda pp, _: self.loss_fn(pp, g, cfg), p, None)
        if not bool(torch.isfinite(loss)):
            raise FloatingPointError(f"{self.arch_id}: loss {loss}")
        for gr in grads:
            if not bool(torch.isfinite(gr).all()):
                raise FloatingPointError(f"{self.arch_id}: a gradient is "
                                         "not finite")
        return {"loss": float(loss)}
