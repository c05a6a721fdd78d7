"""Native factorized emission from the vectorized LFTJ (the port of
``repro.results.factorize``).

``FactorizedResult.from_rows`` can trie-compress any engine's flat
output, but that still pays for the flat cross-product first.  This
builder never materializes it: the *penultimate* frontier (every prefix
binding) is trie-compressed directly, and the final GAO level's
surviving extensions — computed chunk-by-chunk with
``VLFTJ.last_level_extensions`` — become the leaf level's
``(values, parent)`` segments.  Peak memory is the penultimate frontier
plus one expansion chunk, the same bound the streaming cursor gives,
while the result supports O(1) ``count()`` and prefix ``project()``
without ever expanding.
"""
from __future__ import annotations

import numpy as np

from ..core.vlftj import VLFTJ
from .result_set import FactorizedResult, FLevel


def factorize_vlftj(ex: VLFTJ) -> FactorizedResult:
    """Factorized output of a vectorized-LFTJ plan, columns = its GAO."""
    k = len(ex.plan)
    if k == 1:
        vals = np.sort(ex._domain_values(ex.plan[0]).astype(np.int64))
        return FactorizedResult(
            ex.gao, (FLevel(vals, np.zeros(vals.shape[0], np.int64)),))
    frontier = np.asarray(
        ex._run(count_only=False, max_levels=k - 1), dtype=np.int64)
    if frontier.shape[0] == 0:
        empty = np.zeros(0, dtype=np.int64)
        return FactorizedResult(
            ex.gao, tuple(FLevel(empty, empty) for _ in range(k)))
    frontier = frontier[np.lexsort(frontier.T[::-1])]
    counts = np.empty(frontier.shape[0], dtype=np.int64)
    tails: list[np.ndarray] = []
    cf = ex.chunk_rows
    for s in range(0, frontier.shape[0], cf):
        chunk = frontier[s:s + cf]
        real = chunk.shape[0]
        if real < cf:
            chunk = np.pad(chunk, ((0, cf - real), (0, 0)))
        valid = np.zeros(cf, dtype=bool)
        valid[:real] = True
        c, vals = ex.last_level_extensions(chunk.astype(np.int32), valid)
        counts[s:s + real] = c[:real]
        tails.append(vals)
    # drop prefixes with no surviving extension, so every trie path ends
    # in a leaf and prefix project() never reports dangling bindings
    live = counts > 0
    frontier, counts = frontier[live], counts[live]
    prefix = FactorizedResult.from_rows(ex.gao[:-1], frontier, sort=False)
    # frontier rows are distinct join results, so the last prefix level
    # has exactly one entry per frontier row — tails parent straight in
    leaf_vals = (np.concatenate(tails) if tails
                 else np.zeros(0, dtype=np.int64))
    parent = np.repeat(np.arange(frontier.shape[0], dtype=np.int64),
                       counts)
    return FactorizedResult(ex.gao,
                            prefix.levels + (FLevel(leaf_vals, parent),))
