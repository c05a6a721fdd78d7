"""xDeepFM [arXiv:1803.05170]: sparse embeddings + CIN + deep MLP.  The
port of ``repro.models.xdeepfm``: the same config, parameter names and
shapes, float32 throughout.

The hot path is the embedding lookup over 39 categorical fields: one
logical table with each field's rows at an offset (``_field_ids``), read
by :func:`embedding_bag` (a gather, and a segment sum for multi-hot
bags).

CIN (Compressed Interaction Network): x^k_{h} = Σ_{i,j} W^{k,h}_{ij}
(x^{k-1}_i ∘ x^0_j).  The port keeps each layer's state as (B, d, H),
embedding dims before feature maps, so that the (B, d, Hk·F) outer
product reshapes for free into the rows of one (B·d, Hk·F) @ (Hk·F, H)
matrix product: no permuted copy of the largest tensor of the model
(20 GB a layer at 65,536 rows and Hk 200).

Where torch's defaults differ from JAX, the port keeps JAX's:

* every gather reads ids as JAX indexing does (``models.gnn.data.gather``:
  a negative id wraps once, then ids clamp into the table), where torch
  raises; an id at or above ``vocab_per_field`` reads the next field's
  rows, as ``_field_ids``' offsets make it;
* ``embedding_bag``'s bag boundaries drop an out-of-range index, as
  ``.at[].add`` does, so an empty trailing bag is a zero row (torch's
  ``index_add_`` would raise);
* the table's gradient is dense (``index_select``'s backward), and AdamW
  decays every row, as in JAX: no sparse gradient;
* the loss is the JAX package's formula, and its gradient at a logit of
  exactly 0 is JAX's: ``torch.maximum`` splits a tie as ``jnp.maximum``
  does, and ``-|logit|`` is a select whose gradient there is -1, as
  ``jnp.abs``'s is (``torch.abs``'s is 0).

``retrieval_cand`` scoring: one user embedding against 10^6 candidate
item embeddings is one matrix-vector product, not a loop.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device
from ..layers.common import normal_init
from .gnn.data import as_tensor, gather, scatter_sum


@dataclass(frozen=True)
class XDeepFMConfig:
    name: str = "xdeepfm"
    n_sparse: int = 39
    embed_dim: int = 10
    vocab_per_field: int = 100_000   # rows per field table
    cin_layers: tuple = (200, 200, 200)
    mlp_dims: tuple = (400, 400)
    n_dense: int = 0

    @property
    def total_vocab(self) -> int:
        return self.n_sparse * self.vocab_per_field


def init_xdeepfm(cfg: XDeepFMConfig,
                 generator: torch.Generator | None = None,
                 device: torch.device | str = "cuda") -> dict:
    """The JAX package's names and shapes: the tables normal(0, 0.01),
    the CIN and MLP weights normal(0, 0.02), MLP biases 0, all float32,
    drawn from ``generator`` (a fresh one seeded 0 on ``device`` when
    omitted).  The numbers are not the JAX package's."""
    dev = resolve_device(device, "init_xdeepfm")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    f, d = cfg.n_sparse, cfg.embed_dim
    w = lambda *shape, std=0.02: normal_init(generator, shape, std,
                                             device=dev)
    p = {"embed": w(cfg.total_vocab, d, std=0.01),
         "linear": w(cfg.total_vocab, 1, std=0.01),
         "cin": [], "mlp": []}
    prev = f
    for h in cfg.cin_layers:
        p["cin"].append(w(prev * f, h))
        prev = h
    dims = (f * d,) + tuple(cfg.mlp_dims)
    for i in range(len(cfg.mlp_dims)):
        p["mlp"].append({"w": w(dims[i], dims[i + 1]),
                         "b": torch.zeros(dims[i + 1], dtype=torch.float32,
                                          device=dev)})
    p["out_mlp"] = w(cfg.mlp_dims[-1], 1)
    p["out_cin"] = w(sum(cfg.cin_layers), 1)
    return p


def _rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for ids of any shape, read as JAX reads them."""
    return gather(table, ids.reshape(-1)).reshape(
        tuple(ids.shape) + tuple(table.shape[1:]))


def embedding_bag(table: torch.Tensor, ids,
                  offsets=None) -> torch.Tensor:
    """EmbeddingBag: gather + (optional) segment-sum reduction.

    ids: (B, F) one-hot-per-field case -> plain gather (B, F, d);
    with ``offsets`` (n_bags + 1,) bag boundaries over flat ids (T,):
    (n_bags, d) sums.  Row ``i`` of the bag ids is the number of
    boundaries ``offsets[1:-1]`` at or below ``i`` (a boundary outside
    ``[0, T)`` after one wrap of a negative one counts nowhere), and a bag
    id past the last bag drops its row, as JAX's scatter and
    ``segment_sum`` do."""
    ids = as_tensor(ids, torch.int64, table.device)
    if offsets is None:
        return _rows(table, ids)
    emb = _rows(table, ids)                             # (T, d)
    offsets = as_tensor(offsets, torch.int64, table.device)
    t = ids.shape[0]
    starts = offsets[1:-1]
    starts = torch.where(starts < 0, starts + t, starts)
    starts = torch.where((starts >= 0) & (starts < t), starts, t)
    marks = torch.zeros(t + 1, dtype=torch.int64, device=table.device)
    marks.index_add_(0, starts, torch.ones_like(starts))
    bag_id = torch.cumsum(marks[:t], 0)
    return scatter_sum(emb, bag_id, offsets.shape[0] - 1)


def _field_ids(ids: torch.Tensor, cfg: XDeepFMConfig) -> torch.Tensor:
    off = (torch.arange(cfg.n_sparse, dtype=ids.dtype, device=ids.device)
           * cfg.vocab_per_field)[None, :]
    return ids + off


def cin(x0: torch.Tensor, weights: list) -> torch.Tensor:
    """The CIN over x0 (B, d, F), the embeddings with their dims before
    their fields (contiguous): each layer's (B, d, Hk, F) outer product
    is one contiguous tensor, whose (B·d, Hk·F) rows meet the layer's
    (Hk·F, H) weight in one matrix product.  Returns the layers' outputs
    summed over d and concatenated, (B, sum of H)."""
    b, d, _ = x0.shape
    xk = x0
    outs = []
    for w in weights:
        inter = xk[:, :, :, None] * x0[:, :, None, :]  # (B, d, Hk, F)
        xk = (inter.reshape(b * d, -1) @ w).view(b, d, -1)
        outs.append(xk.sum(dim=1))                     # (B, H)
    return torch.cat(outs, dim=-1)


def xdeepfm_forward(params: dict, ids, cfg: XDeepFMConfig) -> torch.Tensor:
    """ids: (B, n_sparse) per-field categorical indices -> logits (B,)."""
    ids = as_tensor(ids, torch.int64, params["embed"].device)
    flat = _field_ids(ids, cfg)
    e = embedding_bag(params["embed"], flat)           # (B, F, d)
    lin = _rows(params["linear"], flat)[..., 0].sum(dim=1)   # (B,)

    cin_vec = cin(e.transpose(1, 2).contiguous(), params["cin"])

    # deep MLP
    b, f, d = e.shape
    h = e.reshape(b, f * d)
    for layer in params["mlp"]:
        h = torch.relu(h @ layer["w"] + layer["b"])

    return (lin + (h @ params["out_mlp"])[:, 0]
            + (cin_vec @ params["out_cin"])[:, 0])


def xdeepfm_loss(params: dict, batch: dict,
                 cfg: XDeepFMConfig) -> torch.Tensor:
    logit = xdeepfm_forward(params, batch["ids"], cfg)
    y = as_tensor(batch["labels"], torch.float32, logit.device)
    # numerically stable BCE-with-logits; -|logit| as a select, whose
    # gradient at 0 is -1 as jnp.abs's is (torch.abs's is 0 there)
    neg_abs = torch.where(logit >= 0, -logit, logit)
    loss = (torch.maximum(logit, logit.new_zeros(())) - logit * y
            + torch.log1p(torch.exp(neg_abs)))
    return loss.mean()


def retrieval_scores(params: dict, query_ids, candidate_ids,
                     cfg: XDeepFMConfig) -> torch.Tensor:
    """Score 1 query against N candidates with one matrix-vector product.

    query_ids: (1, n_sparse); candidate_ids: (N,) item-field indices
    (scored against field 0's table region by convention)."""
    dev = params["embed"].device
    flat = _field_ids(as_tensor(query_ids, torch.int64, dev), cfg)
    q = embedding_bag(params["embed"], flat)           # (1, F, d)
    qv = q.mean(dim=1)[0]                              # (d,)
    cand = _rows(params["embed"],
                 as_tensor(candidate_ids, torch.int64, dev))   # (N, d)
    return cand @ qv                                   # (N,)
