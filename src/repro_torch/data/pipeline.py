"""Deterministic data pipelines: the port's own copy of
``repro.data.pipeline`` (numpy only, the same arrays for the same
arguments).

Fault-tolerance contract: a batch is a pure function of (seed, step,
shard), so a restarted/resharded worker regenerates exactly the batches it
owes — no data-loader state in checkpoints beyond the step counter.
File-backed mode memory-maps a token binary and slices it by the same
(step, shard) arithmetic.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def lm_synthetic_batch(step: int, batch: int, seq: int, vocab: int,
                       seed: int = 0, shard: int = 0, n_shards: int = 1):
    """Deterministic (tokens, labels) for (step, shard)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, step, shard]))
    b_local = batch // n_shards
    toks = rng.integers(0, vocab, (b_local, seq + 1), dtype=np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclass
class LMTokenPipeline:
    batch: int
    seq: int
    vocab: int
    seed: int = 0
    token_file: str | None = None   # optional binary int32 token stream

    def __post_init__(self):
        self._mm = (np.memmap(self.token_file, dtype=np.int32, mode="r")
                    if self.token_file else None)

    def get_batch(self, step: int, shard: int = 0, n_shards: int = 1):
        if self._mm is None:
            return lm_synthetic_batch(step, self.batch, self.seq,
                                      self.vocab, self.seed, shard, n_shards)
        b_local = self.batch // n_shards
        span = b_local * (self.seq + 1)
        start = (step * n_shards + shard) * span % max(
            1, self._mm.shape[0] - span)
        chunk = np.asarray(self._mm[start:start + span]).reshape(
            b_local, self.seq + 1)
        return {"tokens": chunk[:, :-1], "labels": chunk[:, 1:]}


def recsys_synthetic_batch(step: int, batch: int, n_sparse: int,
                           vocab_per_field: int, seed: int = 0,
                           shard: int = 0, n_shards: int = 1):
    """Zipf-ish categorical ids + click labels, deterministic per step."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, shard]))
    b_local = batch // n_shards
    u = rng.random((b_local, n_sparse))
    ids = np.minimum((vocab_per_field * u ** 3).astype(np.int64),
                     vocab_per_field - 1)
    labels = (rng.random(b_local) < 0.25).astype(np.int32)
    return {"ids": ids.astype(np.int32), "labels": labels}


@dataclass
class RecSysPipeline:
    batch: int
    n_sparse: int
    vocab_per_field: int
    seed: int = 0

    def get_batch(self, step: int, shard: int = 0, n_shards: int = 1):
        return recsys_synthetic_batch(step, self.batch, self.n_sparse,
                                      self.vocab_per_field, self.seed,
                                      shard, n_shards)
