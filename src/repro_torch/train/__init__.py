"""Training-side policy of the port.  Only the straggler policy is here
so far (``stragglers``): the partitioned join deals its parts with the
same deterministic re-deal.  The optimizer, loop and checkpointing come
with LM training."""
from .stragglers import StepTimeTracker, reassign_shards

__all__ = ["StepTimeTracker", "reassign_shards"]
