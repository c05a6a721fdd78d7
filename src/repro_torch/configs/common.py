"""What the configurations share: each family's input shapes and
architecture record, as the JAX package's ``repro.configs.common`` gives
them less its XLA dry-run cells (``Cell``, ``cell()``): the LM family
(``LM_SHAPES``, ``LMArch`` and :func:`reduced_cfg`, the small-width copy
of an LM config), the GNN family (``GNN_SHAPES``, ``GNNArch``) and the
recsys family (``RECSYS_SHAPES``, ``RecsysArch``).  Each record's
``smoke(device="cuda")`` runs its reduced model once on the card, or on
the CPU when the caller asks for it."""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable

import torch

from ..device import resolve_device
from ..models.transformer import TransformerConfig
from ..models.xdeepfm import XDeepFMConfig


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
    """An LM architecture as the JAX package's ``LMArch`` gives it, less
    its XLA dry-run cells: the config, the train step's microbatches,
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

    def smoke(self, device: torch.device | str = "cuda") -> dict:
        """The reduced config's loss and gradient on 2 × 16 random
        tokens, a prefill and one decode step: every value finite and
        the logits (2, 1, vocab)."""
        from ..models import transformer as tfm
        from ..train.loop import value_and_grad
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
    ``RecsysArch`` gives it, less its XLA dry-run cells."""

    arch_id: str
    cfg: XDeepFMConfig
    shapes: dict = field(default_factory=lambda: dict(RECSYS_SHAPES))

    family = "recsys"

    def reduced_cfg(self) -> XDeepFMConfig:
        return replace(self.cfg, vocab_per_field=1000,
                       cin_layers=(16, 16), mlp_dims=(32, 32))

    def smoke(self, device: torch.device | str = "cuda") -> dict:
        """The reduced config's loss and gradient on 32 random rows, and
        one query scored against 100 candidates: every value finite."""
        from ..models import xdeepfm as xdf
        from ..train.loop import value_and_grad
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
