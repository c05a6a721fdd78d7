"""Decoder-only transformer (dense and MoE): forward, the training loss,
prefill and KV-cache decode.

The PyTorch version of ``repro.models.transformer`` for one card, with
the same config fields, parameter names and stacked ``(L, ...)`` layout,
so the JAX package's parameters carry across unchanged
(``convert.transformer_params_from_numpy``):

* GQA attention with RoPE (full, or ChatGLM-style on half the head dims)
  through ``kernels.ops.flash_attention`` in every layer of ``forward``
  and ``prefill``: the hand-written CUDA kernel on the card, its plain
  version on the CPU;
* the projections are plain ``torch`` matrix products (the JAX package
  leaves them to XLA, outside any kernel), with float32 accumulation;
  the gate and up projections keep their float32 results up to the
  activation, as the JAX package does;
* an MoE config (``moe=MoEConfig(...)``) replaces the dense FFN with
  ``layers.moe``'s routed experts in every layer, on one card the JAX
  package's no-mesh path (``_moe_ffn_local``: every expert, ``e_off``
  0, the capacity from the call's own ``B * S`` tokens, so decode at
  batch B drops what the JAX package drops); its parameters are the
  nested ``params["moe"]`` dict of stacked ``(L, ...)`` tensors, and
  ``forward`` returns the mean of the layers' load-balance losses;
* ``decode_step`` attends over the KV cache with the plain
  ``_cached_attention`` (plain jnp in the JAX package too).  It writes the
  new token's K and V into the cache tensors **in place** (the JAX
  package returns new arrays), which saves a copy of the whole cache per
  step; the returned cache holds the same tensors.

Two JAX behaviours are reproduced on purpose: token ids are clamped into
the embedding table (JAX clamps an out-of-range gather, PyTorch raises;
the gradient of such an id is dropped, as JAX's is),
and the decode write position is clamped to ``max_len - 1``
(``jax.lax.dynamic_update_slice`` clamps its start).

``loss_fn`` is the JAX package's: the LM head chunked over the sequence
by ``loss_seq_chunk``, the mean cross-entropy plus 0.01 times the aux
loss, in float32.  With ``remat`` (and grad enabled) every layer of
``forward`` runs under ``torch.utils.checkpoint`` (non-reentrant), as
``jax.checkpoint`` wraps it: the backward recomputes the layer, so the
flash forward kernel runs twice a layer.  On the card the gradient of
attention is the hand-written ``flash_attention_bwd`` kernel
(``kernels.flash_attention.FlashAttention``), and the float32-result
products differentiate as JAX transposes them
(``layers.common._WideProduct``).

With ``mesh`` (a ``DeviceMesh`` whose dims are named ``data`` and
``model``, and ``pod`` on two pods) ``forward``, ``loss_fn``,
``prefill`` and ``decode_step`` run each chip's program of the JAX
package's mesh path on DTensors laid out by ``param_specs`` and the
cells' specs: the sharding constraints of ``repro.models.transformer``
at its sites (``layers.sharding.wsc``: a redistribution of a DTensor,
nothing on a plain tensor) and a few where DTensor needs a layout that XLA's
partitioner picks itself (the cross-entropy's reductions over the
vocabulary, granite's gathered heads, the KV cache), batch over the
data axes, Megatron tensor parallelism over ``model`` (query heads,
FFN width and vocabulary; ``_head_axis`` keeps granite's 24 heads
whole on a 16-way axis; every projection a
``layers.sharding.sharded_product``), each chip projecting only its
own query heads' KV heads where the split divides the KV heads
(:func:`_kv_weights`: its columns of the replicated ``wk``/``wv``), and
taking them from the whole K and V where it does not
(:func:`_kv_for_heads`), and the MoE layers
through ``layers.moe.moe_ffn_mesh`` (the JAX package's ``shard_map``
EP/TP).  ``fsdp`` shards the weights over ``data`` too
(``param_specs``) and ``seq_shard`` the residual stream's sequence over
``model``; ``attn_head_shard`` constrains the queries' heads.  Without a
mesh (one card) every value is the one-card program's.
``layers.moe.moe_ffn`` is the MoE layer over a process group.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..kernels import ops as kops
from ..layers.common import (act_fn, apply_rope, cross_entropy_from_logits,
                             make_norm, normal_init)
from ..layers.common import matmul as _matmul
from ..layers.moe import (MoEConfig, _dispatch_compute, capacity_of,
                          init_moe_params, moe_ffn_mesh, moe_param_shapes,
                          moe_param_specs, shared_experts)
from ..layers.sharding import (axis_size, data_axes, is_dtensor, on_mesh,
                               sharded_product, wsc)
from ..layers.sharding import placements as wsc_placements
from .gnn.data import gather


@dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int | None = None
    rope_frac: float = 1.0
    rope_theta: float = 10_000.0
    act: str = "silu"
    norm: str = "rmsnorm"
    use_bias: bool = False
    tie_embeddings: bool = True
    moe: MoEConfig | None = None
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    fsdp: bool = False
    seq_shard: bool = False
    attn_head_shard: bool = True
    loss_seq_chunk: int = 0
    max_cache_len: int = 32768

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 (padded logits are masked)."""
        if self.vocab_size % 256 == 0:
            return self.vocab_size
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def n_params(self) -> int:
        d, l, v = self.d_model, self.n_layers, self.vocab_size
        hq, hkv, dh = self.n_heads, self.n_kv_heads, self.head_dim
        attn = d * hq * dh * 2 + d * hkv * dh * 2
        if self.moe is None:
            ffn = 3 * d * self.d_ff
        else:
            ffn = (3 * d * self.moe.d_ff_expert * self.moe.n_experts
                   + d * self.moe.n_experts
                   + 3 * d * self.moe.d_ff_expert * self.moe.n_shared_experts)
        emb = v * d * (1 if self.tie_embeddings else 2)
        return l * (attn + ffn + 2 * d) + emb + d

    @property
    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.n_params
        d, l = self.d_model, self.n_layers
        hq, hkv, dh = self.n_heads, self.n_kv_heads, self.head_dim
        attn = d * hq * dh * 2 + d * hkv * dh * 2
        ffn = (3 * d * self.moe.d_ff_expert
               * (self.moe.top_k + self.moe.n_shared_experts)
               + d * self.moe.n_experts)
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return l * (attn + ffn + 2 * d) + emb + d


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

_NORMS = ("ln1", "ln2", "ln_f")


def init_params(cfg: TransformerConfig, generator: torch.Generator | None = None,
                device: torch.device | str = "cuda") -> dict:
    """Random parameters with the JAX package's names and stacked shapes:
    normal(0, 0.02) weights in ``cfg.dtype`` from ``generator`` (a fresh
    one seeded 0 on ``device`` when omitted), float32 norm scales of 1;
    an MoE config's nested ``"moe"`` dict from
    :func:`~repro_torch.layers.moe.init_moe_params` (router in float32,
    each stacked tensor drawn one layer at a time).  The numbers are
    not the JAX package's for any seed."""
    dev = resolve_device(device, "init_params")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    params = {}
    for name, shape in param_shapes(cfg).items():
        if name == "moe":
            params[name] = init_moe_params(generator, cfg.d_model, cfg.moe,
                                           cfg.n_layers, dtype=cfg.dtype,
                                           device=dev)
        elif name in _NORMS:
            params[name] = torch.ones(shape, dtype=torch.float32, device=dev)
        else:
            params[name] = normal_init(generator, shape, dtype=cfg.dtype,
                                       device=dev)
    return params


def param_shapes(cfg: TransformerConfig) -> dict:
    """Parameter name -> shape, as :func:`init_params` makes them; an MoE
    config's ``"moe"`` maps to a dict of its own names and shapes."""
    l, d, v = cfg.n_layers, cfg.d_model, cfg.padded_vocab
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {"embed": (v, d), "ln1": (l, d), "wq": (l, d, hq * dh),
              "wk": (l, d, hkv * dh), "wv": (l, d, hkv * dh),
              "wo": (l, hq * dh, d), "ln2": (l, d), "ln_f": (d,)}
    if cfg.moe is None:
        shapes.update(w_gate=(l, d, cfg.d_ff), w_up=(l, d, cfg.d_ff),
                      w_down=(l, cfg.d_ff, d))
    else:
        shapes["moe"] = moe_param_shapes(d, cfg.moe, l)
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, v)
    return shapes


def param_specs(cfg: TransformerConfig) -> dict:
    """The axes of :func:`param_shapes`' tensors, as tuples of axis names
    or None (``"data"`` = the FSDP shard dim with ``fsdp``, ``"model"`` =
    tensor parallel): the JAX package's ``PartitionSpec``s, entry for
    entry; an MoE config's ``"moe"`` is
    :func:`~repro_torch.layers.moe.moe_param_specs`."""
    dp = "data" if cfg.fsdp else None
    specs = {
        "embed": ("model", dp),
        "ln1": (None, None),
        "wq": (None, dp, "model"),
        "wk": (None, dp, None),   # kv heads may not divide the TP axis
        "wv": (None, dp, None),
        "wo": (None, "model", dp),
        "ln2": (None, None),
        "ln_f": (None,),
    }
    if cfg.moe is None:
        specs["w_gate"] = (None, dp, "model")
        specs["w_up"] = (None, dp, "model")
        specs["w_down"] = (None, "model", dp)
    else:
        specs["moe"] = moe_param_specs(cfg.moe, cfg.fsdp)
    if not cfg.tie_embeddings:
        specs["lm_head"] = (dp, "model")
    return specs


def cache_specs(cfg: TransformerConfig, mesh) -> dict:
    """The KV cache's axes on ``mesh`` (``launch.mesh.Mesh``, or None):
    batch over (pod, data); heads over model where the KV heads divide
    it, else the sequence dim (flash-decoding split-K sharding)."""
    dax = (() if mesh is None else
           tuple(a for a in mesh.axis_names if a in ("pod", "data")))
    if mesh is not None and cfg.n_kv_heads % mesh.shape["model"] == 0:
        kv = (None, dax, "model", None, None)
    else:
        kv = (None, dax, None, "model", None)
    return {"k": kv, "v": kv, "len": ()}


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _head_axis(cfg: TransformerConfig, mesh):
    """'model' when the query-head count divides the TP axis, else None
    (granite's 24 heads on a 16-way axis fall back to flat-dim
    sharding)."""
    if mesh is None:
        return None
    return "model" if cfg.n_heads % axis_size(mesh, ("model",)) == 0 else None


def _unshard_fsdp(w, spec: tuple, cfg: TransformerConfig):
    """With ``fsdp`` on a mesh, weight ``w`` (a DTensor laid out by
    ``spec``) gathered whole over ``data`` for its use, as XLA gathers an
    FSDP weight; the gradient is reduce-scattered back to the shard
    (DTensor's own redistribution, whose backward returns to the input's
    layout).  Anything else is returned as it is."""
    if not cfg.fsdp or not is_dtensor(w) or "data" not in spec:
        return w
    spec = tuple(None if a == "data" else a for a in spec)
    return w.redistribute(w.device_mesh, wsc_placements(w.device_mesh, spec))


def _embed(params: dict, tokens: torch.Tensor, cfg: TransformerConfig):
    """``params["embed"][tokens]`` with JAX's gather semantics: a negative
    id counts from the end, then ids are clamped into the table (7 -> 4
    and -7 -> 0 in a table of 5), where PyTorch would raise; an id outside
    ``[-n, n)`` sends no gradient to the row it reads, as in JAX, and a
    bf16 table's gradient is summed in float32
    (:func:`~repro_torch.models.gnn.data.gather`; on a mesh each chip
    reads its vocabulary rows and the partial rows are summed)."""
    table = _unshard_fsdp(params["embed"], param_specs(cfg)["embed"], cfg)
    rows = gather(table, tokens.long().reshape(-1))
    return rows.reshape(tuple(tokens.shape) + (table.shape[1],)).to(
        cfg.dtype)


def _kv_weights(lp: dict, cfg: TransformerConfig, mesh):
    """``wk`` and ``wv`` as the K and V products take them.  Where the
    model axis divides both the query and the KV heads, each chip's
    columns of the replicated weights (a local slice; the gradient is
    gathered back whole), so a chip projects only the KV heads its own
    query heads attend with; else as they are, and every chip projects
    every KV head."""
    wk, wv = lp["wk"], lp["wv"]
    if (mesh is None or _head_axis(cfg, mesh) is None
            or cfg.n_kv_heads % axis_size(mesh, ("model",))):
        return wk, wv
    from torch.distributed.tensor import Shard

    def cols(w):
        pl = [Shard(1) if name == "model" else p
              for name, p in zip(mesh.mesh_dim_names, w.placements)]
        return w.redistribute(w.device_mesh, pl)
    return cols(wk), cols(wv)


def _kv_for_heads(k, v, cfg: TransformerConfig, mesh):
    """K and V as the query heads' split over ``model`` needs them: where
    the KV heads divide it, each chip's own heads already
    (:func:`_kv_weights`); else each chip takes, from its whole K and V
    (``wk``/``wv`` are replicated, as in the JAX package), the KV heads of
    its own query heads, so the kernel's group is the same on every
    chip."""
    if mesh is None or _head_axis(cfg, mesh) is None:
        return k, v
    m = axis_size(mesh, ("model",))
    hkv = cfg.n_kv_heads
    if hkv % m == 0:
        return k, v
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    rep = m // hkv if m % hkv == 0 else cfg.n_heads // hkv
    per_chip = hkv * rep // m
    dax = data_axes(mesh)
    whole = wsc_placements(mesh, (dax, None, None, None))
    split = wsc_placements(mesh, (dax, "model", None, None))
    grad = [Partial() if n == "model" else p
            for n, p in zip(mesh.mesh_dim_names, whole)]

    def pick(t):
        r = mesh.get_local_rank("model")
        heads = torch.arange(r * per_chip, (r + 1) * per_chip,
                             device=t.device) // rep
        return t.index_select(1, heads)

    take = local_map(pick, out_placements=split, in_placements=(whole,),
                     in_grad_placements=(grad,), device_mesh=mesh,
                     redistribute_inputs=True)
    return take(k), take(v)


def _attention(x, lp, cfg: TransformerConfig, positions, mesh=None):
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dax = data_axes(mesh)
    q = _mm(x, lp["wq"], cfg.dtype, mesh)
    if mesh is not None and _head_axis(cfg, mesh) is None:
        # query heads that do not divide the TP axis: gathered whole
        q = wsc(q, (dax, None, None))
    q = q.reshape(b, s, hq, dh)
    wk, wv = _kv_weights(lp, cfg, mesh)
    k = _mm(x, wk, cfg.dtype, mesh).reshape(b, s, hkv, dh)
    v = _mm(x, wv, cfg.dtype, mesh).reshape(b, s, hkv, dh)
    q = apply_rope(q, positions, cfg.rope_frac, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_frac, cfg.rope_theta)
    # (B, H, S, D) views: the kernel reads them through their strides
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if cfg.attn_head_shard:
        q = wsc(q, (dax, _head_axis(cfg, mesh), None, None))
    ka, va = _kv_for_heads(k, v, cfg, mesh)
    o = kops.flash_attention(q, ka, va, causal=True)          # (B,Hq,S,Dh)
    o = o.transpose(1, 2).reshape(b, s, hq * dh)
    if mesh is not None and _head_axis(cfg, mesh) is None:
        o = wsc(o, (dax, None, None))
    return _mm(o, lp["wo"], cfg.dtype, mesh), (k, v)


def _mm(x, w, out_dtype: torch.dtype, mesh):
    """``layers.common.matmul``; on a mesh, each chip's product of its
    shards (``layers.sharding.sharded_product``)."""
    if mesh is None:
        return _matmul(x, w, out_dtype)
    return sharded_product(x, w, lambda a, b: _matmul(a, b, out_dtype))


def _dense_ffn(x, lp, cfg: TransformerConfig, mesh=None):
    g = _mm(x, lp["w_gate"], torch.float32, mesh)
    u = _mm(x, lp["w_up"], torch.float32, mesh)
    h = (act_fn(cfg.act)(g) * u).to(cfg.dtype)
    h = wsc(h, (data_axes(mesh), None, "model"))
    return _mm(h, lp["w_down"], cfg.dtype, mesh)


def _moe_ffn_local(x, lp, cfg: TransformerConfig):
    """The MoE FFN on one card (the JAX package's no-mesh path): every
    expert, the capacity from this call's ``B * S`` tokens."""
    b, s, d = x.shape
    t = b * s
    out, aux = _dispatch_compute(
        x.reshape(t, d), lp["router"], lp["w_gate"], lp["w_up"],
        lp["w_down"], cfg=cfg.moe, e_off=0,
        n_total_experts=cfg.moe.n_experts, act=cfg.act,
        capacity=capacity_of(cfg.moe, t))
    y = out.reshape(b, s, d).to(cfg.dtype)
    if cfg.moe.n_shared_experts:
        y = y + shared_experts(x, lp, cfg.act).to(y.dtype)
    return y, aux


def _ffn(x, lp, cfg: TransformerConfig, mesh=None):
    """The layer's FFN and its aux loss (None for a dense layer)."""
    if cfg.moe is None:
        return _dense_ffn(x, lp, cfg, mesh), None
    if mesh is None:
        return _moe_ffn_local(x, lp["moe"], cfg)
    return moe_ffn_mesh(x, lp["moe"], cfg.moe, mesh, act=cfg.act,
                        dtype=cfg.dtype)


def _layer(x, lp, cfg: TransformerConfig, positions, mesh=None,
           constrain: bool = True):
    """One block; ``constrain`` places the residual stream and the norms'
    outputs as the JAX training layer does (its prefill layer does not)."""
    norm = make_norm(cfg.norm)
    dax = data_axes(mesh)
    if mesh is not None and cfg.fsdp:
        specs = param_specs(cfg)
        lp = {k: v if k == "moe" else _unshard_fsdp(v, specs[k][1:], cfg)
              for k, v in lp.items()}
    res = (dax, "model", None) if cfg.seq_shard else (dax, None, None)
    on = constrain and mesh is not None
    if on:
        x = wsc(x, res)
    h = norm(x, {"scale": lp["ln1"]})
    if on:
        h = wsc(h, (dax, None, None))
    attn_out, kv = _attention(h, lp, cfg, positions, mesh)
    x = x + (wsc(attn_out, res) if on else attn_out)
    h = norm(x, {"scale": lp["ln2"]})
    if on:
        h = wsc(h, (dax, None, None))
    ff, aux = _ffn(h, lp, cfg, mesh)
    return x + (wsc(ff, res) if on else ff), kv, aux


_LAYER_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2")
_DENSE_KEYS = ("w_gate", "w_up", "w_down")


def _layer_stack(params: dict) -> list:
    """Each layer's parameters, sliced by one ``unbind`` a stacked tensor:
    the backward of ``params[k][i]`` would build a zero tensor of the
    whole ``(L, ...)`` stack for every layer; that of ``unbind`` stacks
    the layers' gradients once."""
    stacks = {k: params[k].unbind(0) for k in _LAYER_KEYS}
    if "moe" in params:
        moe = {k: v.unbind(0) for k, v in params["moe"].items()}
    else:
        stacks.update({k: params[k].unbind(0) for k in _DENSE_KEYS})
    n = len(stacks["wq"])
    layers = [{k: v[i] for k, v in stacks.items()} for i in range(n)]
    if "moe" in params:
        for i, lp in enumerate(layers):
            lp["moe"] = {k: v[i] for k, v in moe.items()}
    return layers


def _positions(b: int, s: int, device, mesh=None) -> torch.Tensor:
    """Each token's position, (B, S); on a mesh (1, S), which every chip
    broadcasts over its own rows."""
    return torch.arange(s, dtype=torch.int32, device=device).expand(
        b if mesh is None else 1, s)


def forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
            mesh=None):
    """Token ids (B, S) -> final hidden states (B, S, d) and the mean of
    the layers' aux losses (0 for a dense model).  ``mesh``: see the
    module's docstring."""
    with on_mesh(params, tokens):
        return _forward(params, tokens, cfg, mesh)


def _forward(params, tokens, cfg: TransformerConfig, mesh):
    b, s = tokens.shape
    x = _embed(params, tokens, cfg)
    x = wsc(x, (data_axes(mesh), None, None))
    positions = _positions(b, s, x.device, mesh)

    def layer(x, lp):
        x, _, aux = _layer(x, lp, cfg, positions, mesh)
        return x, aux

    remat = cfg.remat and torch.is_grad_enabled()
    auxs = []
    for lp in _layer_stack(params):
        if remat:
            x, aux = checkpoint(layer, x, lp, use_reentrant=False)
        else:
            x, aux = layer(x, lp)
        auxs.append(aux)
    x = make_norm(cfg.norm)(x, {"scale": params["ln_f"]})
    if cfg.moe is None:
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    return x, torch.stack(auxs).mean()


def _lm_logits(x, params: dict, cfg: TransformerConfig,
               mesh=None) -> torch.Tensor:
    """float32 logits over the padded vocab; padded ids masked to -1e30
    (on a mesh by a select over the vocabulary, as the JAX package masks
    them, since each chip holds a slice of it)."""
    name = "embed" if cfg.tie_embeddings else "lm_head"
    head = _unshard_fsdp(params[name], param_specs(cfg)[name], cfg)
    head = (head.T if cfg.tie_embeddings else head).to(cfg.dtype)
    logits = _mm(x, head, torch.float32, mesh)
    if cfg.padded_vocab != cfg.vocab_size:
        if mesh is None:
            logits[..., cfg.vocab_size:] = -1e30
        else:
            ids = _vocab_ids(cfg.padded_vocab, logits, mesh)
            logits = torch.where(ids < cfg.vocab_size, logits, -1e30)
    return wsc(logits, (data_axes(mesh), None, "model"))


def _vocab_ids(n: int, like: torch.Tensor, mesh):
    """The ids ``0 .. n-1`` of the last axis of ``like`` (a logits
    DTensor split over ``model`` along it), split alike: each chip makes
    its own slice, nothing moves."""
    from torch.distributed.tensor import distribute_tensor
    ids = torch.arange(n, device=like.device)
    return distribute_tensor(ids, mesh, wsc_placements(mesh, ("model",)),
                             src_data_rank=None)


def _cross_entropy(logits, labels, cfg: TransformerConfig, mesh):
    """Per-token cross-entropy; on a mesh, whose chips each hold a slice
    of the vocabulary, the log-sum-exp as its max and its sum of
    exponentials (each reduced over ``model``) and the label's logit as
    a masked sum over the vocabulary, as XLA partitions the JAX
    package's; the same numbers up to rounding."""
    if mesh is None:
        return cross_entropy_from_logits(logits, labels, cfg.vocab_size)
    rows = (data_axes(mesh), None, None)
    lf = logits.float()
    m = wsc(lf.amax(dim=-1, keepdim=True).detach(), rows)
    total = wsc(torch.exp(lf - m).sum(dim=-1, keepdim=True), rows)
    lse = (m + torch.log(total))[..., 0]
    hit = _vocab_ids(lf.shape[-1], lf, mesh) == labels.long()[..., None]
    pick = wsc((lf * hit.to(lf.dtype)).sum(dim=-1), rows[:2])
    return lse - pick


def loss_fn(params: dict, batch: dict, cfg: TransformerConfig,
            mesh=None) -> torch.Tensor:
    """The training loss of ``batch`` (``tokens`` and ``labels``, (B, S)
    integer tensors): the mean per-token cross-entropy plus 0.01 times
    the aux loss, a float32 scalar.  With ``loss_seq_chunk`` the LM head
    runs over the sequence a chunk at a time (S must be a multiple of
    it when it is shorter than S, as the JAX package's reshape asks).
    ``mesh``: see the module's docstring."""
    with on_mesh(params, batch):
        return _loss(params, batch, cfg, mesh)


def _loss(params, batch, cfg: TransformerConfig, mesh):
    tokens, labels = batch["tokens"], batch["labels"]
    x, aux = _forward(params, tokens, cfg, mesh)
    s = x.shape[1]
    chunk = cfg.loss_seq_chunk or s
    n_chunks = max(1, s // chunk)
    if n_chunks > 1:
        if s % chunk:
            raise ValueError(f"loss_fn: sequence {s} is not a multiple of "
                             f"loss_seq_chunk {chunk}")
        ce = torch.cat([_cross_entropy(
            _lm_logits(x[:, i:i + chunk], params, cfg, mesh),
            labels[:, i:i + chunk], cfg, mesh)
            for i in range(0, s, chunk)], dim=1)
    else:
        ce = _cross_entropy(_lm_logits(x, params, cfg, mesh), labels, cfg,
                            mesh)
    return (ce.mean() + 0.01 * aux).float()


# ---------------------------------------------------------------------------
# serving: prefill + decode with KV cache
# ---------------------------------------------------------------------------

def prefill(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
            max_len: int | None = None, mesh=None):
    """Run the prompt, return (cache, last-position logits).  The cache's
    ``k`` and ``v`` are (L, B, Hkv, max_len, Dh) in ``cfg.dtype``, zero
    past the prompt; ``len`` is the prompt length.  ``mesh``: see the
    module's docstring (the cache laid out as ``cache_specs`` says)."""
    with on_mesh(params, tokens):
        return _prefill(params, tokens, cfg, max_len, mesh)


def _prefill(params, tokens, cfg: TransformerConfig, max_len, mesh):
    b, s = tokens.shape
    ml = max_len or cfg.max_cache_len
    if s > ml:
        raise ValueError(f"prefill: prompt of {s} tokens > max_len {ml}")
    x = _embed(params, tokens, cfg)
    x = wsc(x, (data_axes(mesh), None, None))
    positions = _positions(b, s, x.device, mesh)
    if mesh is None:
        shape = (cfg.n_layers, b, cfg.n_kv_heads, ml, cfg.head_dim)
        ks = torch.zeros(shape, dtype=cfg.dtype, device=x.device)
        vs = torch.zeros(shape, dtype=cfg.dtype, device=x.device)
        for i, lp in enumerate(_layer_stack(params)):
            x, (k, v), _ = _layer(x, lp, cfg, positions)
            ks[i, :, :, :s] = k
            vs[i, :, :, :s] = v
    else:
        # each layer's K and V padded to max_len, stacked, laid out as
        # the cache's specs say (the JAX package pads and stacks them)
        kl, vl = [], []
        for lp in _layer_stack(params):
            x, (k, v), _ = _layer(x, lp, cfg, positions, mesh,
                                  constrain=False)
            pad = (0, 0, 0, ml - s)
            kl.append(torch.nn.functional.pad(k, pad))
            vl.append(torch.nn.functional.pad(v, pad))
        kv_spec = cache_specs(cfg, _record(mesh))["k"]
        ks = wsc(torch.stack(kl), kv_spec)
        vs = wsc(torch.stack(vl), kv_spec)
    x = make_norm(cfg.norm)(x, {"scale": params["ln_f"]})
    logits = _lm_logits(x[:, -1:, :], params, cfg, mesh)
    return {"k": ks, "v": vs, "len": s}, logits


def _record(mesh):
    """A ``DeviceMesh``'s axis names and sizes as ``cache_specs`` reads
    them (a ``launch.mesh.Mesh``)."""
    from ..launch.mesh import make_mesh
    return make_mesh(tuple(mesh.shape), tuple(mesh.mesh_dim_names))


def _cached_attention(q, kc, vc, valid_len: int, cfg: TransformerConfig):
    """q: (B, Hq, 1, Dh) vs cache (B, Hkv, M, Dh) masked to valid_len."""
    b, hq, _, dh = q.shape
    hkv, m = kc.shape[1], kc.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, dh).float()
    logits = torch.einsum("bhgd,bhmd->bhgm", qg, kc.float()) / (dh ** 0.5)
    mask = torch.arange(m, device=q.device) < valid_len
    logits = logits.masked_fill(~mask, -1e30)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgm,bhmd->bhgd", p, vc.float())
    return o.reshape(b, hq, 1, dh).to(cfg.dtype)


def _cached_attention_mesh(q, kc, vc, valid, cfg: TransformerConfig, mesh):
    """:func:`_cached_attention` on a mesh: where the cache's heads split
    over ``model`` each chip attends with its own query and KV heads;
    where its positions split, the token's queries are whole on every
    chip and the scores' softmax spans the chips' positions."""
    dax = data_axes(mesh)
    m = axis_size(mesh, ("model",))
    if cfg.n_kv_heads % m == 0 and cfg.n_heads % m == 0:
        from torch.distributed.tensor.experimental import local_map
        pl = wsc_placements(mesh, (dax, "model", None, None))
        fn = lambda q_, k_, v_, n_: _cached_attention(q_, k_, v_, n_, cfg)
        return local_map(fn, out_placements=pl,
                         in_placements=(pl, pl, pl,
                                        wsc_placements(mesh, ())),
                         device_mesh=mesh, redistribute_inputs=True)(
            q, kc, vc, valid)
    q = wsc(q, (dax, None, None, None))
    return _cached_attention(q, kc, vc, valid, cfg)


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                cfg: TransformerConfig, mesh=None):
    """One token for every sequence: tokens (B, 1) -> (logits, new cache).

    The token's K and V are written into ``cache["k"]``/``cache["v"]`` in
    place at position ``cache["len"]``, clamped into [0, max_len - 1] as
    ``jax.lax.dynamic_update_slice`` clamps it; the returned cache holds
    the same tensors with ``len`` one larger.  ``len`` is a Python int, or
    a 0-d integer tensor (the dry run's cell); either way the slot and the
    positions are device tensors, read on no host.  On a ``mesh`` (see
    the module's docstring) the cache is laid out as ``cache_specs``
    says, and each layer's cache is written as a new tensor by a select
    over its positions, which every chip applies to its own slice of
    them (the JAX package's update also returns new arrays)."""
    with on_mesh(params, tokens):
        return _decode(params, cache, tokens, cfg, mesh)


def _decode(params, cache, tokens, cfg: TransformerConfig, mesh):
    b = tokens.shape[0]
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n = cache["len"]
    ml = cache["k"].shape[3]
    norm = make_norm(cfg.norm)
    x = _embed(params, tokens, cfg)
    nt = (n if isinstance(n, torch.Tensor)
          else torch.full((), n, dtype=torch.int64, device=x.device))
    slot = torch.where(nt < 0, nt + ml, nt).clamp(0, ml - 1).reshape(1)
    slot, valid = slot.long(), nt + 1
    pos = nt.reshape(1, 1).expand(b if mesh is None else 1, 1).to(
        torch.int32)
    at_slot = (None if mesh is None else
               (torch.arange(ml, device=x.device) == slot)[:, None])
    ks_out, vs_out = [], []
    for i, lp in enumerate(_layer_stack(params)):
        kc, vc = cache["k"][i], cache["v"][i]
        h = norm(x, {"scale": lp["ln1"]})
        q = _mm(h, lp["wq"], cfg.dtype, mesh)
        if mesh is not None and _head_axis(cfg, mesh) is None:
            q = wsc(q, (data_axes(mesh), None, None))
        q = q.reshape(b, 1, hq, dh)
        wk, wv = _kv_weights(lp, cfg, mesh)
        k = _mm(h, wk, cfg.dtype, mesh).reshape(b, 1, hkv, dh)
        v = _mm(h, wv, cfg.dtype, mesh).reshape(b, 1, hkv, dh)
        q = apply_rope(q, pos, cfg.rope_frac, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_frac, cfg.rope_theta)
        if mesh is None:
            kc.index_copy_(2, slot, k.transpose(1, 2).to(kc.dtype))
            vc.index_copy_(2, slot, v.transpose(1, 2).to(vc.dtype))
        else:
            kc = torch.where(at_slot, k.transpose(1, 2).to(kc.dtype), kc)
            vc = torch.where(at_slot, v.transpose(1, 2).to(vc.dtype), vc)
            ks_out.append(kc)
            vs_out.append(vc)
        if mesh is None:
            o = _cached_attention(q.transpose(1, 2), kc, vc, valid, cfg)
        else:
            o = _cached_attention_mesh(q.transpose(1, 2), kc, vc, valid,
                                       cfg, mesh)
        o = o.transpose(1, 2).reshape(b, 1, hq * dh)
        x = x + _mm(o, lp["wo"], cfg.dtype, mesh)
        x = x + _ffn(norm(x, {"scale": lp["ln2"]}), lp, cfg, mesh)[0]
    x = make_norm(cfg.norm)(x, {"scale": params["ln_f"]})
    logits = _lm_logits(x, params, cfg, mesh)
    if mesh is None:
        return logits, {"k": cache["k"], "v": cache["v"], "len": n + 1}
    kv_spec = cache_specs(cfg, _record(mesh))["k"]
    return logits, {"k": wsc(torch.stack(ks_out), kv_spec),
                    "v": wsc(torch.stack(vs_out), kv_spec),
                    "len": n + 1}
