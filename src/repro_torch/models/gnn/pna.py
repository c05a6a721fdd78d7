"""PNA — Principal Neighbourhood Aggregation [arXiv:2004.05718].  The
port of ``repro.models.gnn.pna``.

Four aggregators (mean, max, min, std) × three degree scalers (identity,
amplification log(d+1)/δ, attenuation δ/log(d+1)) -> 12·d concat ->
linear tower per layer, residual.

Where the port departs from the JAX package: one Python loop over the
stacked weights where the JAX package scans them (``n_layers > 2``) or
unrolls them (the same math).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ...device import resolve_device
from ...layers.common import layernorm, normal_init
from .data import (GraphBatch, as_tensor, edge_ids, gather, node_nll,
                   scatter_max, scatter_mean, scatter_min, scatter_sum)


@dataclass(frozen=True)
class PNAConfig:
    name: str = "pna"
    n_layers: int = 4
    d_hidden: int = 75
    d_in: int = 1433
    n_classes: int = 16
    delta: float = 2.5   # avg log-degree normalizer (dataset statistic)


def init_pna(cfg: PNAConfig, generator: torch.Generator | None = None,
             device: torch.device | str = "cuda") -> dict:
    """The JAX package's names and shapes (normal(0, 0.02) weights from
    ``generator``, a fresh one seeded 0 on ``device`` when omitted;
    LayerNorm scales of 1); not its numbers."""
    dev = resolve_device(device, "init_pna")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    l, d = cfg.n_layers, cfg.d_hidden
    w = lambda *shape: normal_init(generator, shape, device=dev)
    return {
        "enc": w(cfg.d_in, d),
        "pre": w(l, d, d),
        "post": w(l, 12 * d, d),
        "self": w(l, d, d),
        "ln": torch.ones((l, d), dtype=torch.float32, device=dev),
        "dec": w(d, cfg.n_classes),
    }


def pna_forward(params: dict, g: GraphBatch, cfg: PNAConfig) -> torch.Tensor:
    """(N, n_classes) logits, on the device of ``params``."""
    dev = params["enc"].device
    n = g.n_nodes
    src, dst = edge_ids(g, dev)
    h = as_tensor(g.node_feat, torch.float32, dev) @ params["enc"]
    deg = scatter_sum(torch.ones((src.shape[0], 1), dtype=torch.float32,
                                 device=dev), dst, n)
    logd = torch.log(deg + 1.0)
    amp = logd / cfg.delta
    att = cfg.delta / torch.clamp(logd, min=1e-2)   # no gradient: deg

    has_nbr = deg > 0  # segment_max is -inf on isolated nodes: mask them
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(cfg.n_layers):
        msg = gather(h, src) @ params["pre"][i]
        mean = scatter_mean(msg, dst, n)
        mx = torch.where(has_nbr, scatter_max(msg, dst, n), 0.0)
        mn = torch.where(has_nbr, scatter_min(msg, dst, n), 0.0)
        sq = scatter_mean(msg * msg, dst, n)
        # torch.maximum, as jnp.maximum, splits the gradient where the
        # variance is exactly 0 (one neighbour); clamp would pass it all
        std = torch.sqrt(torch.maximum(sq - mean * mean, zero) + 1e-6)
        aggs = torch.cat([mean, mx, mn, std], dim=-1)           # (N, 4d)
        scaled = torch.cat([aggs, aggs * amp, aggs * att], dim=-1)
        h = h + torch.relu(layernorm(
            scaled @ params["post"][i] + h @ params["self"][i],
            params["ln"][i]))
    return h @ params["dec"]


def pna_loss(params: dict, g: GraphBatch, cfg: PNAConfig) -> torch.Tensor:
    return node_nll(pna_forward(params, g, cfg), g.labels)
