"""Data-parallel train steps over a process group, with the gradient
exchange uncompressed or over an int8 wire.  The port of
``repro.dist.compressed_step``.

Every rank of ``group`` holds the whole parameters and optimizer state
and passes the whole batch; it takes its own row block of the batch
(rank ``r`` of ``n`` takes rows ``[r * B / n, (r + 1) * B / n)``, the
block the JAX package's ``shard_map`` gives device ``r`` of the data
axis), back-propagates it, and the gradients are averaged over the
group before the same AdamW update (``train.optimizer.adamw_update``,
in place) runs on every rank.  :func:`make_compressed_train_step`
averages them through
:func:`repro_torch.dist.compression.compressed_psum_tree` (int8
payloads with per-rank error feedback), leaf by leaf in JAX's order.

The error-feedback state is the JAX package's ``(n, ...)`` tree with a
leading data-shard axis, of which each rank holds its own row: leaves of
shape ``(1, ...)``.  It is soft state; :func:`resize_compressed_state`
re-deals a whole ``(n, ...)`` stack (gathered, say, for a checkpoint) to
another shard count as the JAX function does.  The steps run on the
device of the parameters; a CUDA tensor needs a NCCL group, a CPU one a
gloo group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..device import check_group_device
from ..train.loop import value_and_grad
from ..train.optimizer import OptimizerConfig, adamw_update
from ..train.tree import leaves as tree_leaves
from ..train.tree import tree_map, unflatten
from .compression import compressed_psum_tree


def init_compressed_state(params, group=None):
    """Zero error-feedback residues: this rank's row, a float32 ``(1,
    ...)`` copy of each parameter leaf (``group`` is accepted for the
    JAX function's mesh and names the group the row belongs to)."""
    return tree_map(lambda p: torch.zeros((1,) + tuple(p.shape),
                                          dtype=torch.float32,
                                          device=p.device), params)


def resize_compressed_state(err, n_shards: int):
    """Elastic re-deal of a whole ``(n, ...)`` error-feedback stack to
    ``n_shards`` rows: every row receives the old mean residue, so the
    mean over the axis (what the compressed all-reduce folds into the
    next reduction) is unchanged."""
    return tree_map(lambda e: e.mean(dim=0, keepdim=True).repeat_interleave(
        n_shards, dim=0), err)


def _local_block(batch, group):
    n = dist.get_world_size(group)
    r = dist.get_rank(group)

    def block(x):
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} rows does not split "
                             f"over {n} ranks")
        b = x.shape[0] // n
        return x[r * b:(r + 1) * b]

    return tree_map(block, batch)


def _mean_loss(loss: torch.Tensor, group) -> torch.Tensor:
    loss = loss.clone()
    dist.all_reduce(loss, group=group)
    return loss / dist.get_world_size(group)


def make_dp_train_step(loss_fn, opt_cfg: OptimizerConfig, group=None):
    """The uncompressed data-parallel step (float32 all-reduce mean), the
    fair baseline of :func:`make_compressed_train_step`.  Returns
    ``step(params, opt_state, batch) -> (params, opt_state, metrics)``."""

    def step(params, opt_state, batch):
        device = tree_leaves(params)[0].device
        check_group_device(group, device, "make_dp_train_step")
        n = dist.get_world_size(group)
        loss, grads = value_and_grad(loss_fn, params,
                                     _local_block(batch, group))
        mean = []
        for g in grads:
            g = g.to(torch.float32).clone()
            dist.all_reduce(g, group=group)
            mean.append(g / n)
        params, opt_state, om = adamw_update(
            params, unflatten(params, mean), opt_state, opt_cfg)
        return params, opt_state, {"loss": _mean_loss(loss, group), **om}

    return step


def make_compressed_train_step(loss_fn, opt_cfg: OptimizerConfig,
                               group=None):
    """``loss_fn(params, batch) -> scalar``.  Returns ``step(params,
    opt_state, err, batch) -> (params, opt_state, err, metrics)`` with
    the gradients exchanged through the int8 compressed all-reduce with
    error feedback (``err``: this rank's ``(1, ...)`` rows)."""

    def step(params, opt_state, err, batch):
        loss, grads = value_and_grad(loss_fn, params,
                                     _local_block(batch, group))
        local_err = [e[0] for e in tree_leaves(err)]
        reduced, new_err = compressed_psum_tree(grads, local_err, group)
        params, opt_state, om = adamw_update(
            params, unflatten(params, reduced), opt_state, opt_cfg)
        new_err = unflatten(err, [e[None] for e in new_err])
        return params, opt_state, new_err, {
            "loss": _mean_loss(loss, group), **om}

    return step
