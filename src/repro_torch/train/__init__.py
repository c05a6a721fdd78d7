"""Training (the port of ``repro.train``): AdamW (``optimizer``, updating
in place), the train step and ``Trainer`` (``loop``), checkpoints in the
JAX package's format (``checkpoint``), trees in JAX's leaf order
(``tree``), and the straggler policy (``stragglers``), whose re-deal the
partitioned join also uses."""
from .checkpoint import CheckpointManager
from .loop import Trainer, make_train_step, value_and_grad
from .optimizer import (OptimizerConfig, adamw_update, global_norm,
                        init_opt_state, lr_at)
from .stragglers import StepTimeTracker, reassign_shards

__all__ = ["CheckpointManager", "OptimizerConfig", "StepTimeTracker",
           "Trainer", "adamw_update", "global_norm", "init_opt_state",
           "lr_at", "make_train_step", "reassign_shards", "value_and_grad"]
