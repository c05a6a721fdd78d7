"""Segmented expansion of per-row extension runs into flat rows (host
numpy).

The port's own copy of ``segment_expand``, which the JAX package keeps
in its ``kernels/segment_outer`` module beside a TPU kernel; here it has
a host module of its own, since it runs no device work.
"""
from __future__ import annotations

import numpy as np


def segment_expand(prefix: np.ndarray, counts: np.ndarray,
                   values: np.ndarray) -> np.ndarray:
    """Unfold per-row extension segments out of rows:

        out = [prefix[i] ++ v  for i, seg in enumerate(segments)
                               for v in seg]

    ``prefix`` (C, k) rows are repeated by ``counts`` (C,) and the
    flattened segment ``values`` (counts.sum(),) become the new last
    column.  Rows stay in segment order, so a lex-sorted prefix with
    ascending per-row segments yields lex-sorted output — the invariant
    :class:`~repro_torch.results.ResultCursor` streams pages under.
    Returns int64.
    """
    prefix = np.asarray(prefix)
    counts = np.asarray(counts, dtype=np.int64)
    values = np.asarray(values)
    reps = np.repeat(np.arange(counts.shape[0]), counts)
    out = np.empty((values.shape[0], prefix.shape[1] + 1), dtype=np.int64)
    out[:, :-1] = prefix[reps]
    out[:, -1] = values
    return out
