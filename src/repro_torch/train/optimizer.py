"""AdamW with a cosine schedule and global-norm clipping: the port of
``repro.train.optimizer``.

The moments are float32 whatever the parameters' dtype, and ``step`` is
an int32 scalar tensor.  The learning rate, the clip scale and the bias
corrections are float32 tensors computed as jnp computes them, and every
element follows the JAX package's arithmetic in the same order.

One divergence, on purpose: :func:`adamw_update` updates the parameters
and the moments **in place** (under ``torch.no_grad()``), where the JAX
package returns new arrays.  A functional update would hold a second
copy of the whole training state (32 GB for stablelm-3b).  The returned
params tree and the state's ``m`` and ``v`` are the tensors passed in;
``step`` is a new tensor.  Large leaves are updated a piece at a time,
so the float32 temporaries stay small.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..layers.sharding import is_dtensor

from .tree import leaves as tree_leaves
from .tree import tree_map

#: elements of one leaf updated at a time (float32 temporaries of 64 MB)
PIECE = 1 << 24


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def lr_at(step, cfg: OptimizerConfig) -> torch.Tensor:
    """The learning rate at ``step`` (an int, or an integer tensor whose
    device the result takes) as a float32 scalar tensor: linear warmup,
    then a cosine decay to ``min_lr_frac * lr``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * torch.clamp((step + 1) / max(1, cfg.warmup_steps),
                                max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init_opt_state(params) -> dict:
    """Zero float32 moments shaped like ``params`` (on their devices) and
    an int32 step of 0."""
    first = tree_leaves(params)[0]
    # zeros_like: a DTensor parameter's moments are laid out as it is
    zeros = lambda p: torch.zeros_like(
        p, dtype=torch.float32, memory_format=torch.contiguous_format)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def _pieces(t: torch.Tensor):
    """``t`` flattened, in views of at most ``PIECE`` elements: views of
    ``t`` itself (a parameter or moment, updated through them; it must be
    contiguous)."""
    return t.view(-1).split(PIECE)


def _read_pieces(t: torch.Tensor):
    """``t`` flattened in pieces for reading: a gradient may be a
    transposed view (a tied embedding's, through the LM head), which is
    copied once."""
    return t.reshape(-1).split(PIECE)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (in float32), the leaves
    summed in JAX's order."""
    total = 0
    for leaf in tree_leaves(tree):
        if is_dtensor(leaf):
            # each chip squares its shard; DTensor sums the shards
            total = total + leaf.float().square().sum()
            continue
        total = total + sum(p.float().square().sum()
                            for p in _read_pieces(leaf))
    return torch.sqrt(total)


def adamw_update(params, grads, state: dict, cfg: OptimizerConfig):
    """One AdamW step: ``(params, state, {"grad_norm", "lr"})``, the
    params and moments updated in place (see the module's docstring)."""
    step = state["step"] + 1
    lr = lr_at(step, cfg)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    stepf = step.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=stepf.device)
    bc1 = 1 - (one * cfg.b1) ** stepf
    bc2 = 1 - (one * cfg.b2) ** stepf
    with torch.no_grad():
        # on a mesh: each chip updates its shard of every leaf with the
        # gradient laid out as the leaf is, and the scalars whole (the
        # step is a DTensor or, as ``init_opt_state`` makes it, plain)
        scale, lr, bc1, bc2 = (t.full_tensor() if is_dtensor(t) else t
                               for t in (scale, lr, bc1, bc2))
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["m"]),
                              tree_leaves(state["v"])):
            if is_dtensor(p):
                g = g.redistribute(p.device_mesh, p.placements).to_local()
                p, m, v = p.to_local(), m.to_local(), v.to_local()
            for pp, gp, mp, vp in zip(_pieces(p), _read_pieces(g),
                                      _pieces(m), _pieces(v)):
                gf = gp.to(torch.float32) * scale
                mp.mul_(cfg.b1).add_((1 - cfg.b1) * gf)
                vp.mul_(cfg.b2).add_((1 - cfg.b2) * gf * gf)
                pf = pp.to(torch.float32)
                delta = (mp / bc1) / (torch.sqrt(vp / bc2) + cfg.eps) \
                    + cfg.weight_decay * pf
                pp.copy_(pf - lr * delta)
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
