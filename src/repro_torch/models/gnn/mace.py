"""MACE — higher-order equivariant message passing [arXiv:2206.07697].
The port of ``repro.models.gnn.mace``.

Implementation notes:
  * node states are real-spherical-harmonic irreps up to l_max=2 packed as
    a dense (N, C, 9) tensor — contiguous channels instead of e3nn's
    ragged irrep lists;
  * the symmetric product basis (correlation order 3) is built by iterated
    pairwise coupling with the *real Gaunt tensor* G[ab,c] = ∫ Y_a Y_b Y_c dΩ,
    computed **exactly** by a Gauss-Legendre × uniform-φ spherical
    quadrature (exact for the ≤ degree-6 integrands involved; numpy, the
    JAX package's code); intermediate irreps are capped at l ≤ 2 (MACE's
    own practice for its message irreps);
  * radial basis: 8 Gaussian RBFs -> MLP -> per-l radial weights.

Energy readout is rotation-invariant (property-tested); l=1 components
transform equivariantly.

Every switch of the JAX package's ``MACEConfig`` is here, with its
rounding points: ``compute_bf16`` rounds the edge basis, the messages and
their product to bf16 (the A-basis is summed in float32), then rounds
the A-basis and the Gaunt tensor for the couplings and takes the product
basis back to float32.  Where the port departs from the JAX package:

* ``state.at[:, :, 0].set(h0)`` and ``.at[:, :, 0].add(...)`` are built
  out of place (``torch.cat``), which autograd needs; the added term
  reads the state after ``state + m``, as in JAX;
* ``remat`` runs each layer under ``torch.utils.checkpoint``
  (non-reentrant) while gradients are on, where JAX wraps it in
  ``jax.checkpoint``;
* ``shard_couple`` places the node tensors (the state, each A-basis
  component, the A-basis) over the ``model`` axis where they are
  DTensors on a mesh, as JAX's ``_maybe_shard`` constrains them; on one
  card, as in JAX without a mesh, it does nothing;
* the A-basis sums with ``index_add_`` (float atomics on the card) in
  both ``a_basis_mode``s, as the JAX package sums with ``segment_sum``;
  ``csrc/segment_outer.cu`` computes the same sum but has no backward.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...device import resolve_device
from ...layers.common import normal_init
from ...layers.sharding import wsc
from .data import (GraphBatch, as_tensor, edge_ids, gather, graph_ids,
                   graph_mse, scatter_sum)

N_SH = 9  # (l,m) pairs for l <= 2

_C0 = float(0.5 * np.sqrt(1.0 / np.pi))
_C1 = float(np.sqrt(3.0 / (4 * np.pi)))
_C2A = float(0.5 * np.sqrt(15.0 / np.pi))
_C2B = float(0.25 * np.sqrt(5.0 / np.pi))
_C2C = float(0.25 * np.sqrt(15.0 / np.pi))


def real_sph_harm(u: torch.Tensor) -> torch.Tensor:
    """Real orthonormal spherical harmonics l<=2 of unit vectors (E,3)."""
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    return torch.stack([
        torch.full_like(x, _C0),        # (0, 0)
        _C1 * y,                        # (1,-1)
        _C1 * z,                        # (1, 0)
        _C1 * x,                        # (1, 1)
        _C2A * x * y,                   # (2,-2)
        _C2A * y * z,                   # (2,-1)
        _C2B * (3 * z * z - 1.0),       # (2, 0)
        _C2A * x * z,                   # (2, 1)
        _C2C * (x * x - y * y),         # (2, 2)
    ], dim=-1)


def _real_sph_harm_np(u: np.ndarray) -> np.ndarray:
    """Pure-numpy twin of :func:`real_sph_harm`."""
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    return np.stack([
        np.full_like(x, _C0), _C1 * y, _C1 * z, _C1 * x,
        _C2A * x * y, _C2A * y * z, _C2B * (3 * z * z - 1.0),
        _C2A * x * z, _C2C * (x * x - y * y)], axis=-1)


@lru_cache(maxsize=1)
def gaunt_tensor() -> np.ndarray:
    """G[a, b, c] = ∫ Y_a Y_b Y_c dΩ, exact via GL(8) × 16-pt trapezoid."""
    nodes, weights = np.polynomial.legendre.leggauss(8)
    nphi = 16
    phi = 2 * np.pi * np.arange(nphi) / nphi
    u, p = np.meshgrid(nodes, phi, indexing="ij")       # (8, 16)
    w = np.repeat(weights[:, None], nphi, 1) * (2 * np.pi / nphi)
    st = np.sqrt(1 - u ** 2)
    pts = np.stack([st * np.cos(p), st * np.sin(p), u], axis=-1)
    ys = _real_sph_harm_np(pts.reshape(-1, 3)).reshape(8, nphi, N_SH)
    g = np.einsum("ij,ija,ijb,ijc->abc", w, ys, ys, ys)
    g[np.abs(g) < 1e-12] = 0.0
    return g


L_OF = np.array([0, 1, 1, 1, 2, 2, 2, 2, 2])  # l of each SH slot


@dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    n_layers: int = 2
    d_hidden: int = 128      # channels C
    l_max: int = 2
    correlation: int = 3
    n_rbf: int = 8
    d_in: int = 16
    r_cut: float = 3.0
    n_out: int = 1
    # 'outer' scatters the (E, C, 9) message outer product; 'loop' runs 9
    # per-m segment-sums and never materializes it.  bf16 halves
    # message/coupling traffic (f32 accumulation).  couple_chunks splits
    # the Gaunt couplings over node chunks to bound the (chunk, C, 81)
    # intermediate.
    a_basis_mode: str = "outer"
    compute_bf16: bool = False
    couple_chunks: int = 1
    # shard the couplings over a model axis: nothing to do on one card
    shard_couple: bool = False
    remat: bool = False   # recompute each layer in the backward


def init_mace(cfg: MACEConfig, generator: torch.Generator | None = None,
              device: torch.device | str = "cuda") -> dict:
    """The JAX package's tree (``enc``, ``layers``, a list of per-layer
    dicts, and ``readout``): normal(0, 0.02) weights (``w_B`` 0.05) from
    ``generator`` (a fresh one seeded 0 on ``device`` when omitted); not
    the JAX package's numbers."""
    dev = resolve_device(device, "init_mace")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    c = cfg.d_hidden
    w = lambda *shape, std=0.02: normal_init(generator, shape, std,
                                             device=dev)
    p = {"enc": w(cfg.d_in, c), "layers": []}
    for _ in range(cfg.n_layers):
        p["layers"].append({
            # radial: n_rbf -> hidden -> one weight per l
            "rad_w1": w(cfg.n_rbf, 32),
            "rad_w2": w(32, 3),
            "w_msg": w(c, c),
            # channel mixing per correlation order x l
            "w_B": w(cfg.correlation, 3, c, c, std=0.05),
            "w_h": w(c, c),
        })
    p["readout"] = {"w1": w(c, c), "w2": w(c, cfg.n_out)}
    return p


def _rbf(r: torch.Tensor, n: int, r_cut: float) -> torch.Tensor:
    centers = torch.linspace(0.0, r_cut, n, dtype=r.dtype, device=r.device)
    gamma = (n / r_cut) ** 2
    return torch.exp(-gamma * (r[:, None] - centers[None, :]) ** 2)


def _couple(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(N,C,9) x (N,C,9) -> (N,C,9) via the Gaunt tensor:
    ``einsum("ncp,ncq,pqr->ncr")`` as the (N,C,81) outer product times G
    flattened to (81, 9)."""
    outer = (a[..., :, None] * b[..., None, :]).reshape(
        *a.shape[:-1], N_SH * N_SH)
    return outer @ g.reshape(N_SH * N_SH, N_SH)


def _product_basis(a: torch.Tensor, gaunt: torch.Tensor,
                   cfg: MACEConfig) -> list:
    """``[a, a⊗a, (a⊗a)⊗a, ...]`` up to ``cfg.correlation``, over
    ``couple_chunks`` node chunks (``a`` padded to a multiple of them)."""
    def orders(blk):
        bs, cur = [blk], blk
        for _ in range(cfg.correlation - 1):
            cur = _couple(cur, blk, gaunt)
            bs.append(cur)
        return bs

    k = cfg.couple_chunks
    if k <= 1:
        return orders(a)
    n = a.shape[0]
    pad = (-n) % k
    a_p = F.pad(a, (0, 0, 0, 0, 0, pad))
    parts = [torch.stack(orders(a_p[i * (n + pad) // k:
                                    (i + 1) * (n + pad) // k]))
             for i in range(k)]
    return list(torch.cat(parts, dim=1)[:, :n])


def mace_forward(params: dict, g: GraphBatch, cfg: MACEConfig) -> torch.Tensor:
    """The (N, C, 9) irrep state after the last layer, on the device of
    ``params``."""
    dev = params["enc"].device
    n = g.n_nodes
    src, dst = edge_ids(g, dev)
    x = as_tensor(g.coords, torch.float32, dev)
    gaunt = torch.as_tensor(gaunt_tensor(), dtype=torch.float32, device=dev)
    l_of = torch.as_tensor(L_OF, device=dev)

    # initial node irreps: invariant channel in l=0, zero elsewhere
    h0 = as_tensor(g.node_feat, torch.float32, dev) @ params["enc"]  # (N, C)
    state = torch.cat([h0[..., None],
                       h0.new_zeros((n, cfg.d_hidden, N_SH - 1))], dim=-1)
    if cfg.shard_couple:
        state = wsc(state, ("model", None, None))

    diff = gather(x, dst) - gather(x, src)
    r = torch.sqrt((diff * diff).sum(dim=-1) + 1e-12)
    unit = diff / r[:, None]
    ylm = real_sph_harm(unit)                                    # (E, 9)
    rbf = _rbf(r, cfg.n_rbf, cfg.r_cut)                          # (E, nrbf)

    cdt = torch.bfloat16 if cfg.compute_bf16 else torch.float32
    masks = [(l_of == l) for l in range(3)]

    def layer_fn(state, lp):
        rad = F.silu(rbf @ lp["rad_w1"]) @ lp["rad_w2"]          # (E, 3)
        edge_basis = (ylm * rad.index_select(1, l_of)).to(cdt)   # (E, 9)
        # A-basis: invariant message channels spread over edge irreps
        msg = gather(state[:, :, 0] @ lp["w_msg"], src).to(cdt)  # (E, C)
        if cfg.a_basis_mode == "loop":
            # never materialize the (E, C, 9) outer product: one
            # f32-accumulated segment-sum per spherical component
            ams = [scatter_sum((msg * edge_basis[:, m:m + 1]).float(),
                               dst, n) for m in range(N_SH)]
            if cfg.shard_couple:  # keep node tensors model-sharded
                ams = [wsc(am, ("model", None)) for am in ams]
            a = torch.stack(ams, dim=-1)                         # (N, C, 9)
        else:
            a = scatter_sum((msg[:, :, None] * edge_basis[:, None, :])
                            .float(), dst, n)                    # (N, C, 9)
        # product basis, correlation order 1..3 (iterated Gaunt coupling)
        a = a.to(cdt)
        if cfg.shard_couple:
            # node-local math: the model axis contributes HBM bandwidth
            a = wsc(a, ("model", None, None))
        bs = [b.float() for b in _product_basis(a, gaunt.to(cdt), cfg)]
        m = torch.zeros_like(a)
        for order, b in enumerate(bs):
            for l in range(3):
                m = m + torch.einsum("ncp,cd->ndp", b * masks[l],
                                     lp["w_B"][order, l])
        if cfg.shard_couple:
            # the coupling's gradient arrives a partial sum over the data
            # axes (the edges' scatters): reduced here once a layer, where
            # DTensor would reduce-scatter it over the channels inside
            # each einsum (an added site: XLA lays it out itself)
            m = wsc(m, ("model", None, None))
        # update: residual on the full irrep state; invariant mix
        state = state + m
        s0 = state[:, :, 0]
        return torch.cat([(s0 + s0 @ lp["w_h"])[..., None], state[:, :, 1:]],
                         dim=-1)

    remat = cfg.remat and torch.is_grad_enabled()
    for lp in params["layers"]:
        if remat:
            state = checkpoint(layer_fn, state, lp, use_reentrant=False)
        else:
            state = layer_fn(state, lp)
    return state


def mace_energy(params: dict, g: GraphBatch, cfg: MACEConfig) -> torch.Tensor:
    """Invariant per-graph readout (sum-pooled): (n_graphs, n_out)."""
    state = mace_forward(params, g, cfg)
    inv = state[:, :, 0]                                         # (N, C)
    out = F.silu(inv @ params["readout"]["w1"]) @ params["readout"]["w2"]
    return scatter_sum(out, graph_ids(g, out.device), g.n_graphs)


def mace_loss(params: dict, g: GraphBatch, cfg: MACEConfig) -> torch.Tensor:
    return graph_mse(mace_energy(params, g, cfg), g.labels)
