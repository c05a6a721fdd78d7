"""Mixture-of-Experts FFN: the port of ``repro.layers.moe``.

Routing and dispatch are computed the way the JAX package computes
them, so the same parameters route the same tokens to the same experts
and drop the same ones:

* float32 router logits; a softmax over every expert for the
  load-balance loss ``E * sum(frac_top1 * mean(probs))``;
* the top ``k`` experts per token, the lower expert first on ties (as
  ``jax.lax.top_k``; :func:`route` takes them from a stable descending
  sort, since ``torch.topk`` promises no order among equal values), and
  a softmax over their ``k`` logits as the gates;
* sort-based dispatch: a stable sort of the ``T * k`` picks by expert,
  each pick's position in its expert's group from the group starts, and
  a capacity mask (``pos < capacity``); picks past it are dropped and
  add zeros at slot ``(0, 0)``, as the JAX scatter does;
* an ``(E_loc, C, d)`` buffer filled by a scatter-add (``index_add_``
  over its flattened rows: each local slot receives one pick and the
  dropped ones add zeros, so the order of the adds changes nothing),
  three batched products with float32 results (gate, up, down: plain
  matrix products, which the JAX package leaves to XLA outside any
  kernel), and the gated scatter-add back into a float32 ``(T, d)``
  result.

:func:`moe_ffn` runs the layer over a ``torch.distributed`` process
group, the counterpart of the JAX function's ``shard_map`` over the
``model`` mesh axis.  Each rank passes its own tokens and its own shard
of the parameters (:func:`shard_moe_params`):

* ``ep``: the rank holds ``E / world`` experts, those at ``e_off =
  rank * E_loc``, and dispatches only the picks of its experts;
* ``tp``: the rank holds a ``d_ff_expert / world`` slice of every
  expert's width (and of the shared experts').

The partial outputs, routed and shared, are summed over the group in
one ``all_reduce``; the aux loss is averaged over the group and, with
``data_group``, over the data ranks too.  The capacity is
``int(capacity_factor * T_local * k / E) + 1`` from the rank's own
tokens.  A CPU tensor needs a gloo group, a CUDA one a NCCL group.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..device import check_group_device, resolve_device
from .common import act_fn, bmm_f32, matmul, normal_init_layers


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    shard_mode: str = "ep"          # "ep" | "tp"
    n_shared_experts: int = 0       # always-on shared experts


def capacity_of(cfg: MoEConfig, n_tokens: int) -> int:
    """Slots per expert for ``n_tokens`` tokens:
    ``int(capacity_factor * n_tokens * top_k / n_experts) + 1``."""
    return int(cfg.capacity_factor * n_tokens * cfg.top_k
               / cfg.n_experts) + 1


def init_moe_params(generator: torch.Generator | None, d_model: int,
                    cfg: MoEConfig, n_layers: int,
                    dtype: torch.dtype = torch.float32,
                    device: torch.device | str = "cuda") -> dict:
    """Stacked ``(L, ...)`` expert parameters with the JAX package's names
    and shapes: normal(0, 0.02) in ``dtype`` from ``generator`` (a fresh
    one seeded 0 on ``device`` when omitted), the router in float32
    whatever ``dtype`` is.  Each tensor is drawn one layer at a time
    (:func:`~repro_torch.layers.common.normal_init_layers`); the numbers
    are not the JAX package's."""
    dev = resolve_device(device, "init_moe_params")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return {name: normal_init_layers(
                generator, shape,
                dtype=torch.float32 if name == "router" else dtype,
                device=dev)
            for name, shape in moe_param_shapes(d_model, cfg,
                                                n_layers).items()}


def moe_param_shapes(d_model: int, cfg: MoEConfig, n_layers: int) -> dict:
    """Parameter name -> stacked shape, as :func:`init_moe_params` makes
    them."""
    l, e, ff = n_layers, cfg.n_experts, cfg.d_ff_expert
    shapes = {"router": (l, d_model, e), "w_gate": (l, e, d_model, ff),
              "w_up": (l, e, d_model, ff), "w_down": (l, e, ff, d_model)}
    if cfg.n_shared_experts:
        sff = ff * cfg.n_shared_experts
        shapes.update(sh_gate=(l, d_model, sff), sh_up=(l, d_model, sff),
                      sh_down=(l, sff, d_model))
    return shapes


def moe_param_specs(cfg: MoEConfig, fsdp: bool = False) -> dict:
    """The axes of the stacked ``(L, ...)`` parameters, as tuples of axis
    names (``"model"``, ``"data"`` with ``fsdp``, or None): the JAX
    package's ``PartitionSpec``s, entry for entry."""
    dp = "data" if fsdp else None
    if cfg.shard_mode == "ep":
        w = (None, "model", dp, None)
        wd = (None, "model", None, dp)
    else:
        w = (None, None, dp, "model")
        wd = (None, None, "model", dp)
    specs = {"router": (None, None, None), "w_gate": w, "w_up": w,
             "w_down": wd}
    if cfg.n_shared_experts:
        specs["sh_gate"] = (None, dp, "model")
        specs["sh_up"] = (None, dp, "model")
        specs["sh_down"] = (None, "model", dp)
    return specs


def shard_moe_params(params: dict, cfg: MoEConfig, rank: int,
                     world: int) -> dict:
    """Rank ``rank``'s shard of the stacked parameters over a model group
    of ``world`` ranks: each tensor's ``"model"`` axis
    (:func:`moe_param_specs`) cut into ``world`` equal blocks, block
    ``rank`` kept (a copy); the router is whole on every rank.  The
    ``"data"`` axis is not cut: :func:`moe_ffn` takes the parameters
    whole along it, as the JAX function's ``in_specs`` gather them."""
    out = {}
    for name, spec in moe_param_specs(cfg).items():
        t = params[name]
        if "model" not in spec:
            out[name] = t
            continue
        axis = spec.index("model")
        if t.shape[axis] % world:
            raise ValueError(f"{name}: axis {axis} of {tuple(t.shape)} "
                             f"does not split over {world} ranks")
        out[name] = t.chunk(world, dim=axis)[rank].contiguous()
    return out


def route(x: torch.Tensor, router: torch.Tensor, top_k: int):
    """float32 router logits ``(T, E)`` of tokens ``x (T, d)``, and each
    token's top ``top_k`` experts ``(T, k)`` (int64) with their logits,
    highest first and the lower expert first among equal logits (the
    order of ``jax.lax.top_k``)."""
    logits = x.float() @ router.float()
    idx = torch.argsort(logits, dim=-1, descending=True,
                        stable=True)[:, :top_k]
    return logits, idx, logits.gather(1, idx)


def _slots(idx, gates, *, n_total_experts: int, e_off: int, e_loc: int,
           capacity: int):
    """Where each of the ``T * k`` picks goes: the picks stably sorted by
    expert, as ``(st, sg, local, slot_e, slot_c)``: the token and gate of
    each sorted pick, whether it is one of this rank's experts within
    capacity (its position in its expert's group below ``capacity``),
    and its buffer slot (``(0, 0)`` where it is not)."""
    t, k = idx.shape
    dev = idx.device
    eflat = idx.reshape(-1)                                    # (T*k,)
    tflat = torch.arange(t, device=dev)[:, None].expand(t, k).reshape(-1)
    order = torch.argsort(eflat, stable=True)
    se, st, sg = eflat[order], tflat[order], gates.reshape(-1)[order]
    starts = torch.searchsorted(
        se, torch.arange(n_total_experts, device=dev))
    pos = torch.arange(t * k, device=dev) - starts[se]
    local = (se >= e_off) & (se < e_off + e_loc) & (pos < capacity)
    slot_e = torch.where(local, se - e_off, 0)
    slot_c = torch.where(local, pos, 0)
    return st, sg, local, slot_e, slot_c


def _dispatch_compute(x, router, w_gate, w_up, w_down, *, cfg: MoEConfig,
                      e_off: int, n_total_experts: int, act: str,
                      capacity: int):
    """Token dispatch and expert FFN for the experts [e_off, e_off+E_loc).

    x: (T, d).  Returns (partial_out (T, d) float32, aux_loss scalar)."""
    t, d = x.shape
    e_loc = w_gate.shape[0]
    k = cfg.top_k
    dev = x.device
    logits, idx, gate_vals = route(x, router, k)
    probs = torch.softmax(logits, dim=-1)                      # (T, E)
    gates = torch.softmax(gate_vals, dim=-1)
    # load-balance aux (on the full router; the same on every rank)
    experts = torch.arange(n_total_experts, device=dev)
    frac = (idx[:, :1] == experts).float().mean(dim=0)
    aux = n_total_experts * torch.sum(frac * probs.mean(dim=0))

    st, sg, local, slot_e, slot_c = _slots(
        idx, gates, n_total_experts=n_total_experts, e_off=e_off,
        e_loc=e_loc, capacity=capacity)
    xg = torch.where(local[:, None], x[st], 0).to(x.dtype)
    # buf[slot_e, slot_c] += xg over the flattened (E_loc * C, d) rows: a
    # local slot gets one pick, every dropped pick adds zeros at row 0, so
    # the sum is exact in any order (index_put_'s accumulating path
    # serializes the dropped picks' repeats of row 0 on the card)
    buf = x.new_zeros((e_loc * capacity, d))
    buf.index_add_(0, slot_e * capacity + slot_c, xg)
    buf = buf.view(e_loc, capacity, d)
    h = bmm_f32(buf, w_gate)
    u = bmm_f32(buf, w_up)
    h = (act_fn(act)(h) * u).to(x.dtype)
    y = bmm_f32(h, w_down)                                     # (E_loc,C,d)
    contrib = y[slot_e, slot_c] * torch.where(local, sg, 0.0)[:, None]
    out = torch.zeros((t, d), dtype=torch.float32, device=dev)
    out.index_add_(0, st, contrib)
    return out, aux


def shared_experts(x: torch.Tensor, lp: dict, act: str) -> torch.Tensor:
    """The always-on shared experts' float32 output for ``x (..., d)``:
    ``act(x @ sh_gate) * (x @ sh_up)`` cast to ``x.dtype``, then
    ``@ sh_down``."""
    g = act_fn(act)(_product(x, lp["sh_gate"]))
    u = _product(x, lp["sh_up"])
    return _product((g * u).to(x.dtype), lp["sh_down"])


def _product(x, w):
    """``matmul(x, w, float32)``; on DTensors each chip's product of its
    shards."""
    from .sharding import is_dtensor, sharded_product
    if is_dtensor(x):
        return sharded_product(x, w,
                               lambda a, b: matmul(a, b, torch.float32))
    return matmul(x, w, torch.float32)


def moe_ffn(x: torch.Tensor, params_layer: dict, cfg: MoEConfig,
            group=None, *, act: str = "silu",
            dtype: torch.dtype = torch.bfloat16, data_group=None):
    """x: (B, S, d), this rank's tokens, the same on every rank of
    ``group`` (its data rank's batch); ``params_layer``: this rank's
    shard of one layer's parameters (:func:`shard_moe_params`, then the
    layer).  Returns ``(y (B, S, d) in dtype, aux)``, the same on every
    rank of ``group`` (None: the default group)."""
    check_group_device(group, x.device, "moe_ffn")
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    b, s, d = x.shape
    wg = params_layer["w_gate"]
    if cfg.shard_mode == "ep":
        e_loc = wg.shape[0]
        if e_loc * world != cfg.n_experts:
            raise ValueError(f"moe_ffn: a rank of {world} holds "
                             f"{cfg.n_experts // world} experts, this "
                             f"shard {e_loc}")
        e_off = rank * e_loc
    else:
        if wg.shape[-1] * world != cfg.d_ff_expert:
            raise ValueError(f"moe_ffn: a rank of {world} holds "
                             f"{cfg.d_ff_expert // world} of each expert's "
                             f"{cfg.d_ff_expert} columns, this shard "
                             f"{wg.shape[-1]}")
        e_off = 0
    t_local = b * s
    xf = x.reshape(t_local, d)
    out, aux = _dispatch_compute(
        xf, params_layer["router"], wg, params_layer["w_up"],
        params_layer["w_down"], cfg=cfg, e_off=e_off,
        n_total_experts=cfg.n_experts, act=act,
        capacity=capacity_of(cfg, t_local))
    # one collective for the routed partial, the shared experts' partial
    # (their width is cut over the group too) and the aux loss
    parts = [out.reshape(-1)]
    if cfg.n_shared_experts:
        parts.append(shared_experts(xf, params_layer, act).reshape(-1))
    parts.append(aux.reshape(1))
    total = torch.cat(parts)
    dist.all_reduce(total, group=group)
    n = t_local * d
    y = total[:n].reshape(b, s, d).to(dtype)
    aux = total[-1] / world
    if data_group is not None:
        dist.all_reduce(aux, group=data_group)
        aux = aux / dist.get_world_size(data_group)
    if cfg.n_shared_experts:
        y = y + total[n:2 * n].reshape(b, s, d).to(y.dtype)
    return y, aux


def moe_ffn_mesh(x, params_layer: dict, cfg: MoEConfig, mesh, *,
                 act: str = "silu", dtype: torch.dtype = torch.bfloat16):
    """The JAX package's ``moe_ffn`` on a mesh: ``x`` (B, S, d), a DTensor
    split over the data axes of ``mesh`` (a ``DeviceMesh`` with a
    ``model`` dim), and one layer's parameters laid out by
    :func:`moe_param_specs`.  Each chip runs :func:`_dispatch_compute`
    on its tokens and its experts (``ep``: ``E / model`` experts from
    ``e_off = model rank * E_loc``; ``tp``: a ``1 / model`` slice of
    every expert's width) through ``local_map``, the counterpart of the
    JAX ``shard_map``, with the capacity of its own ``B * S / data``
    tokens; the routed partial sums are reduced over ``model`` in
    float32 (the ``psum``) and cast to ``dtype``, and the aux loss is
    averaged over the whole mesh (the ``pmean``s; every chip's aux is
    the same over ``model``).  The shared experts
    are tensor parallel over ``model`` outside the map, as in the JAX
    package.  Returns ``(y, aux)``."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    from .sharding import axis_size, data_axes, placements
    dax = data_axes(mesh)
    b, s, d = x.shape
    t_local = (b * s) // axis_size(mesh, dax)
    capacity = capacity_of(cfg, t_local)
    if cfg.shard_mode == "ep":
        wspec = wdspec = ("model", None, None)
    else:
        wspec, wdspec = (None, None, "model"), (None, "model", None)
    x_pl = placements(mesh, (dax, None, None))
    on_model = [n == "model" for n in mesh.mesh_dim_names]
    y_pl = [Partial() if m else p for m, p in zip(on_model, x_pl)]
    # the aux loss as a sum of each chip's share of the mean (a Partial
    # sum's gradient reaches every chip whole, where an average's would
    # not be divided)
    aux_pl = [Partial()] * mesh.ndim
    n_chips = mesh.size()
    w_pl = placements(mesh, wspec)
    wd_pl = placements(mesh, wdspec)
    # gradients: each model rank's experts see part of every token and
    # each data rank part of the tokens, so their shares are partial sums
    x_grad = [Partial() if m else p for m, p in zip(on_model, x_pl)]
    r_grad = [Partial()] * mesh.ndim
    w_grad = [p if m else Partial() for m, p in zip(on_model, w_pl)]
    wd_grad = [p if m else Partial() for m, p in zip(on_model, wd_pl)]

    def f(x_loc, router, wg, wu, wd):
        tl = x_loc.shape[0] * x_loc.shape[1]
        e_off = (mesh.get_local_rank("model") * wg.shape[0]
                 if cfg.shard_mode == "ep" else 0)
        out, aux = _dispatch_compute(
            x_loc.reshape(tl, d), router, wg, wu, wd, cfg=cfg, e_off=e_off,
            n_total_experts=cfg.n_experts, act=act, capacity=capacity)
        return out.reshape(x_loc.shape), aux / n_chips

    y, aux = local_map(
        f, out_placements=(y_pl, aux_pl),
        in_placements=(x_pl, placements(mesh, ()), w_pl, w_pl, wd_pl),
        in_grad_placements=(x_grad, r_grad, w_grad, w_grad, wd_grad),
        redistribute_inputs=True, device_mesh=mesh)(
        x, params_layer["router"], params_layer["w_gate"],
        params_layer["w_up"], params_layer["w_down"])
    y = y.redistribute(mesh, x_pl).to(dtype)
    if cfg.n_shared_experts:
        sh = shared_experts(x, params_layer, act)
        y = y + sh.redistribute(mesh, x_pl).to(y.dtype)
    return y, aux
