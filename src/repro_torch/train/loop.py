"""The training loop: a train step (gradient accumulation and AdamW),
checkpoints and resume, metrics.  The port of ``repro.train.loop``.

Fault tolerance: ``Trainer.run`` can be restarted with ``resume="auto"``
and continues from the newest verified checkpoint (the data pipeline is
a pure function of the step, so no batch is lost or doubled).  The step
is eager PyTorch: each microbatch's forward and backward run in turn,
their float32 gradients are summed, and the optimizer updates the
parameters in place (``train.optimizer``).  ``Trainer`` runs on
``device="cuda"`` unless the caller passes ``"cpu"``.

On a mesh, as the JAX package's ``Trainer`` takes already-sharded
arrays: params given as DTensors stay laid out as they are, each
batch's leading axis is split over the mesh's data axes, the metrics are
read whole, and a resume restores the checkpoint onto the layout of the
Trainer's own state (``CheckpointManager.restore(..., shardings=)``),
whatever mesh saved it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..device import resolve_device
from ..layers.sharding import (data_axes, is_dtensor, mesh_of, on_mesh,
                               placements, sharding_of)
from .checkpoint import CheckpointManager
from .optimizer import OptimizerConfig, adamw_update, init_opt_state
from .tree import leaves as tree_leaves
from .tree import tree_map, unflatten


def value_and_grad(loss_fn: Callable, params, batch):
    """``jax.value_and_grad(loss_fn)(params, batch)``: the loss (detached)
    and the gradient of every leaf of ``params`` in JAX's order, each in
    its leaf's dtype (zeros for a leaf the loss does not reach)."""
    flat = tree_leaves(params)
    with torch.enable_grad():
        req = [p.detach().requires_grad_(True) for p in flat]
        loss = loss_fn(unflatten(params, req), batch)
        # on a mesh, a plain tensor the backward makes (a constant of a
        # derivative) is taken as whole on every chip
        with on_mesh(loss):
            grads = torch.autograd.grad(loss, req, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(flat, grads)]


def _microbatch(x: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """Block ``i`` of ``n`` along ``x``'s leading axis.  A DTensor split
    along that axis is cut on each chip's own rows (its rows' block
    ``i``): every chip's microbatch then stays on it, and the blocks
    together are the batch, as the scan over them is in the JAX
    package's program."""
    if is_dtensor(x):
        from torch.distributed.tensor import DTensor
        loc = x.to_local()
        part = loc.reshape((n, loc.shape[0] // n) + tuple(loc.shape[1:]))[i]
        shape = (x.shape[0] // n,) + tuple(x.shape[1:])
        return DTensor.from_local(
            part, x.device_mesh, x.placements, run_check=False,
            shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride())
    return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))[i]


def make_train_step(loss_fn: Callable, opt_cfg: OptimizerConfig,
                    microbatches: int = 1):
    """``loss_fn(params, batch) -> scalar``.  Returns
    ``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    with ``microbatches`` > 1 the batch's leading axis is cut into that
    many consecutive blocks, their float32 gradients summed and divided
    by the count, and the loss is the blocks' mean; then one AdamW
    update (in place).  ``metrics`` holds float32 scalar tensors."""

    def step(params, opt_state, batch):
        with on_mesh(params, batch):
            return _step(params, opt_state, batch)

    def _step(params, opt_state, batch):
        if microbatches > 1:
            flat = tree_leaves(params)
            gsum = [torch.zeros_like(p, dtype=torch.float32,
                                     memory_format=torch.contiguous_format)
                    for p in flat]
            losses = []
            for i in range(microbatches):
                mb = tree_map(lambda x: _microbatch(x, microbatches, i),
                              batch)
                loss, grads = value_and_grad(loss_fn, params, mb)
                for acc, g in zip(gsum, grads):
                    acc.add_(g.to(torch.float32))
                del grads
                losses.append(loss)
            for acc in gsum:
                acc.div_(microbatches)
            grads, loss = gsum, torch.stack(losses).mean()
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)
        params, opt_state, om = adamw_update(
            params, unflatten(params, grads), opt_state, opt_cfg)
        return params, opt_state, {"loss": loss, **om}

    return step


@dataclass
class Trainer:
    loss_fn: Callable                 # (params, batch) -> scalar
    params: Any
    opt_cfg: OptimizerConfig
    get_batch: Callable               # (step) -> batch tree of arrays
    ckpt_dir: str | None = None
    ckpt_every: int = 100
    microbatches: int = 1
    keep: int = 3
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device, "Trainer")
        self.params = tree_map(
            lambda t: t if is_dtensor(t) else t.to(self.device),
            self.params)
        self.mesh = mesh_of(*tree_leaves(self.params))
        self.opt_state = init_opt_state(self.params)
        self.step_fn = make_train_step(self.loss_fn, self.opt_cfg,
                                       self.microbatches)
        self.ckpt = (CheckpointManager(self.ckpt_dir, keep=self.keep)
                     if self.ckpt_dir else None)
        self.start_step = 0
        self.history: list[dict] = []

    def maybe_resume(self) -> int:
        if self.ckpt is None:
            return 0
        latest = self.ckpt.latest_step()
        if latest is None:
            return 0
        like = {"params": self.params, "opt": self.opt_state}
        state = self.ckpt.restore(latest, like,
                                  shardings=tree_map(sharding_of, like),
                                  device=self.device)
        self.params = state["params"]
        self.opt_state = state["opt"]
        self.start_step = latest
        return latest

    def run(self, n_steps: int, log_every: int = 10,
            resume: str = "auto") -> list[dict]:
        if resume == "auto":
            self.maybe_resume()
        t0 = time.time()
        for step in range(self.start_step, self.start_step + n_steps):
            batch = tree_map(self._put, self.get_batch(step))
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            if (step + 1) % log_every == 0 or step == self.start_step:
                m = {k: float(v.full_tensor() if is_dtensor(v) else v)
                     for k, v in metrics.items()}
                m["step"] = step + 1
                m["wall"] = time.time() - t0
                self.history.append(m)
            if self.ckpt and (step + 1) % self.ckpt_every == 0:
                self.ckpt.save(step + 1, {"params": self.params,
                                          "opt": self.opt_state})
        if self.ckpt:
            self.ckpt.wait()
        return self.history

    def _put(self, x) -> torch.Tensor:
        """A batch array on the Trainer's device; on a mesh, a DTensor
        whose leading axis is split over the data axes (each rank keeps
        its rows of the whole array), as the step's microbatches cut it."""
        t = torch.as_tensor(np.array(x), device=self.device)
        if self.mesh is None:
            return t
        from torch.distributed.tensor import distribute_tensor
        spec = (data_axes(self.mesh),) if t.ndim else ()
        return distribute_tensor(t, self.mesh,
                                 placements(self.mesh, spec),
                                 src_data_rank=None)
