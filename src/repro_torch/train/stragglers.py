"""Straggler detection & mitigation policy (the port's copy of
``repro.train.stragglers``, host Python only).

At pod scale the engine-level mitigation is *static over-partitioning*
(the paper's granularity factor, ``dist/sharded_join.py``); the training
loop adds (1) per-step wall-time tracking with robust outlier detection
and (2) a deterministic work-reassignment plan: because every batch is a
pure function of (step, shard) (`data/pipeline.py`), shards of a detected
straggler can be re-dealt to healthy workers without data loss — the
restarted worker replays nothing and double-computes nothing.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field


@dataclass
class StepTimeTracker:
    """Rolling robust z-score over step wall-times."""

    window: int = 50
    threshold: float = 3.0   # MAD multiples
    times: deque = field(default_factory=lambda: deque(maxlen=200))

    def record(self, seconds: float) -> bool:
        """Record one step; True if this step is a straggler event."""
        hist = sorted(self.times)[-self.window:] if self.times else []
        self.times.append(seconds)
        if len(hist) < 10:
            return False
        med = hist[len(hist) // 2]
        mad = sorted(abs(t - med) for t in hist)[len(hist) // 2]
        return seconds > med + self.threshold * max(mad, 0.05 * med)

    @property
    def median(self) -> float:
        if not self.times:
            return 0.0
        s = sorted(self.times)
        return s[len(s) // 2]


def reassign_shards(n_shards: int, dead: set[int],
                    granularity: int = 1) -> dict[int, list[int]]:
    """Deterministic plan: every worker w owns shards {w, w+W, ...} of the
    over-partitioned space; dead workers' shards are round-robin re-dealt
    to survivors.  Returns worker -> owned shard list."""
    alive = [w for w in range(n_shards) if w not in dead]
    if not alive:
        raise RuntimeError("no workers alive")
    total = n_shards * granularity
    plan: dict[int, list[int]] = {w: [] for w in alive}
    for part in range(total):
        owner = part % n_shards
        if owner in dead:
            owner = alive[part % len(alive)]
        plan.setdefault(owner, []).append(part)
    return plan
