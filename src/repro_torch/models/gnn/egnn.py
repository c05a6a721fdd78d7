"""EGNN — E(n)-equivariant GNN [Satorras et al., arXiv:2102.09844].  The
port of ``repro.models.gnn.egnn``.

    m_ij = φ_e(h_i, h_j, ||x_i − x_j||²)
    x'_i = x_i + (1/deg) Σ_j (x_i − x_j) φ_x(m_ij)
    h'_i = φ_h(h_i, Σ_j m_ij)

Coordinates transform equivariantly under E(n) (rotation/translation);
features are invariant — property-tested under random rotations.  The
``"layers"`` list keeps the JAX package's list of per-layer dicts (the
training tree helpers flatten lists in JAX's order).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ...device import resolve_device
from ...layers.common import normal_init
from .data import (GraphBatch, as_tensor, edge_ids, gather, graph_ids,
                   graph_mse, scatter_mean, scatter_sum)


@dataclass(frozen=True)
class EGNNConfig:
    name: str = "egnn"
    n_layers: int = 4
    d_hidden: int = 64
    d_in: int = 16
    n_out: int = 1


def _mlp_init(generator, dims, dev) -> list:
    return [{"w": normal_init(generator, (dims[i], dims[i + 1]), device=dev),
             "b": torch.zeros((dims[i + 1],), dtype=torch.float32,
                              device=dev)}
            for i in range(len(dims) - 1)]


def _mlp(layers: list, x: torch.Tensor, act=F.silu,
         last_act: bool = False) -> torch.Tensor:
    for i, lp in enumerate(layers):
        x = x @ lp["w"] + lp["b"]
        if i < len(layers) - 1 or last_act:
            x = act(x)
    return x


def init_egnn(cfg: EGNNConfig, generator: torch.Generator | None = None,
              device: torch.device | str = "cuda") -> dict:
    """The JAX package's tree (``enc``, ``dec`` and ``layers``, a list of
    ``phi_e``/``phi_x``/``phi_h`` MLPs of ``w``/``b`` dicts): normal(0,
    0.02) weights from ``generator`` (a fresh one seeded 0 on ``device``
    when omitted), zero biases; not the JAX package's numbers."""
    dev = resolve_device(device, "init_egnn")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    d = cfg.d_hidden
    p = {"enc": normal_init(generator, (cfg.d_in, d), device=dev),
         "dec": _mlp_init(generator, (d, d, cfg.n_out), dev),
         "layers": []}
    for _ in range(cfg.n_layers):
        p["layers"].append({
            "phi_e": _mlp_init(generator, (2 * d + 1, d, d), dev),
            "phi_x": _mlp_init(generator, (d, d, 1), dev),
            "phi_h": _mlp_init(generator, (2 * d, d, d), dev),
        })
    return p


def egnn_forward(params: dict, g: GraphBatch, cfg: EGNNConfig):
    """``(h, x)``: (N, d) invariant features and (N, 3) coordinates, on
    the device of ``params``."""
    dev = params["enc"].device
    n = g.n_nodes
    src, dst = edge_ids(g, dev)
    h = as_tensor(g.node_feat, torch.float32, dev) @ params["enc"]
    x = as_tensor(g.coords, torch.float32, dev)

    for lp in params["layers"]:
        diff = gather(x, dst) - gather(x, src)          # (E, 3)
        dist2 = (diff * diff).sum(dim=-1, keepdim=True)
        m = _mlp(lp["phi_e"], torch.cat(
            [gather(h, dst), gather(h, src), dist2], dim=-1),
            last_act=True)                              # (E, d)
        coef = _mlp(lp["phi_x"], m)                     # (E, 1)
        x = x + scatter_mean(diff * coef, dst, n)
        agg = scatter_sum(m, dst, n)
        h = h + _mlp(lp["phi_h"], torch.cat([h, agg], dim=-1))
    return h, x


def egnn_energy(params: dict, g: GraphBatch, cfg: EGNNConfig) -> torch.Tensor:
    """Invariant per-graph readout (sum-pooled): (n_graphs, n_out)."""
    h, _ = egnn_forward(params, g, cfg)
    out = _mlp(params["dec"], h)                        # (N, n_out)
    return scatter_sum(out, graph_ids(g, out.device), g.n_graphs)


def egnn_loss(params: dict, g: GraphBatch, cfg: EGNNConfig) -> torch.Tensor:
    return graph_mse(egnn_energy(params, g, cfg), g.labels)
