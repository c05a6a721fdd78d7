"""GatedGCN [Bresson & Laurent, arXiv:1711.07553 / benchmarking-GNNs
arXiv:2003.00982]: edge-gated message passing with edge-feature updates.
The port of ``repro.models.gnn.gatedgcn``.

    e'_ij = E1 h_i + E2 h_j + E3 e_ij
    η_ij  = σ(e'_ij) / (Σ_k σ(e'_ik) + ε)
    h'_i  = ReLU(LN(h_i + U h_i + Σ_j η_ij ⊙ (V h_j)))

LayerNorm replaces BatchNorm (stateless under jit/pod execution).

Where the port departs from the JAX package: the JAX package scans the
layers with ``lax.scan`` when ``n_layers > 2`` and unrolls them
otherwise; the port runs one Python loop over the stacked weights in both
cases (the same math).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ...device import resolve_device
from ...layers.common import layernorm, normal_init
from .data import GraphBatch, as_tensor, edge_ids, gather, node_nll, scatter_sum


@dataclass(frozen=True)
class GatedGCNConfig:
    name: str = "gatedgcn"
    n_layers: int = 16
    d_hidden: int = 70
    d_in: int = 1433
    d_edge_in: int = 0
    n_classes: int = 16


def init_gatedgcn(cfg: GatedGCNConfig,
                  generator: torch.Generator | None = None,
                  device: torch.device | str = "cuda") -> dict:
    """The JAX package's names and shapes: normal(0, 0.02) weights from
    ``generator`` (a fresh one seeded 0 on ``device`` when omitted) and
    LayerNorm scales of 1.  The numbers are not the JAX package's."""
    dev = resolve_device(device, "init_gatedgcn")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    l, d = cfg.n_layers, cfg.d_hidden
    w = lambda *shape: normal_init(generator, shape, device=dev)
    return {
        "enc": w(cfg.d_in, d),
        "edge_enc": w(max(1, cfg.d_edge_in), d),
        "U": w(l, d, d), "V": w(l, d, d),
        "E1": w(l, d, d), "E2": w(l, d, d), "E3": w(l, d, d),
        "ln_h": torch.ones((l, d), dtype=torch.float32, device=dev),
        "ln_e": torch.ones((l, d), dtype=torch.float32, device=dev),
        "dec": w(d, cfg.n_classes),
    }


def gatedgcn_forward(params: dict, g: GraphBatch,
                     cfg: GatedGCNConfig) -> torch.Tensor:
    """(N, n_classes) logits, on the device of ``params``."""
    dev = params["enc"].device
    n = g.n_nodes
    src, dst = edge_ids(g, dev)
    h = as_tensor(g.node_feat, torch.float32, dev) @ params["enc"]
    if g.edge_feat is not None:
        e = as_tensor(g.edge_feat, torch.float32, dev) @ params["edge_enc"]
    else:
        e = torch.zeros((src.shape[0], cfg.d_hidden), dtype=torch.float32,
                        device=dev)
    for i in range(cfg.n_layers):
        u, v, e1, e2, e3 = (params[k][i] for k in ("U", "V", "E1", "E2",
                                                   "E3"))
        hi, hj = gather(h, dst), gather(h, src)
        e_new = hi @ e1 + hj @ e2 + e @ e3
        gate = torch.sigmoid(e_new)
        denom = scatter_sum(gate, dst, n) + 1e-6
        agg = scatter_sum(gate * (hj @ v), dst, n) / denom
        h = h + torch.relu(layernorm(h @ u + agg, params["ln_h"][i]))
        e = e + torch.relu(layernorm(e_new, params["ln_e"][i]))
    return h @ params["dec"]


def gatedgcn_loss(params: dict, g: GraphBatch,
                  cfg: GatedGCNConfig) -> torch.Tensor:
    return node_nll(gatedgcn_forward(params, g, cfg), g.labels)
