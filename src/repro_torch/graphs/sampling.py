"""Node samples (the paper's selectivity predicates).

The paper samples node predicates ``v1, v2, ...`` with probability ``1/s``
(s = "selectivity"; s=10 keeps ~10%).  The port's copy of
``repro.graphs.sampling.node_sample``: the same seed gives the same ids.
"""
from __future__ import annotations

import numpy as np


def node_sample(n_nodes: int, selectivity: float, seed: int = 0,
                ) -> np.ndarray:
    """Sorted node ids, each kept with probability 1/selectivity."""
    rng = np.random.default_rng(seed)
    keep = rng.random(n_nodes) < (1.0 / selectivity)
    ids = np.flatnonzero(keep).astype(np.int64)
    if ids.size == 0:
        ids = rng.integers(0, n_nodes, size=1).astype(np.int64)
    return ids
