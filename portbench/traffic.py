"""The general traffic generator: one mix file of parameters in, each
client's request stream out.

A mix (``mixes/<name>.json``) states:

* ``shapes``: the patterns, in equal shares: each client's stream is a
  sequence of rounds, a round being every shape once in an order drawn
  from the seed, so every seed sends the same work in another order;
* ``selectivity``: the unary samples' selectivity;
* ``samples``: where a request's sample seed comes from.  ``"pool"``:
  the run draws ``pool_size`` sample seeds from its seed, the server's
  warm graphs for all of them are built in set-up, and each request
  draws its own from the pool; ``"session"``: each round is one
  analyst's session over a sample of its own, so every round brings a
  fresh sample seed (drawn from the run's seed) that the server has not
  seen, and its warm graph is built inside the window;
* ``clients``: closed-loop clients, each sending its next request when
  the reply to its last one arrives, each its own tenant of the quantum
  scheduler (``QuantumScheduler.submit``/``step``);
* ``engine``: the engine each request asks for (``"auto"``: the
  planner's choice).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

KEYS = ("shapes", "selectivity", "samples", "clients", "engine")


@dataclass
class Request:
    """One request of one client, and what became of it."""

    client: int
    shape: str
    sample_seed: int
    t_due: float = 0.0
    t_done: float | None = None
    count: int | None = None
    engine: str | None = None
    error: str | None = None


def check_mix(mix: dict) -> dict:
    missing = [k for k in KEYS if k not in mix]
    if missing:
        raise ValueError(f"mix lacks {missing}")
    if mix["samples"] not in ("pool", "session"):
        raise ValueError(f"unknown samples {mix['samples']!r}")
    if mix["samples"] == "pool" and mix.get("pool_size", 0) < 1:
        raise ValueError("a pool of samples needs pool_size >= 1")
    return mix


def warm_samples(mix: dict, seed: int) -> list[int]:
    """The sample seeds whose warm graphs set-up builds: the pool, or
    for sessions one seed that no session draws."""
    rng = np.random.default_rng([seed, 1])
    size = mix["pool_size"] if mix["samples"] == "pool" else 1
    return [int(s) for s in rng.integers(0, 1 << 31, size=size)]


class Stream:
    """The endless request stream of one client."""

    def __init__(self, mix: dict, seed: int, client: int, pool: list[int]):
        self.mix, self.client, self.pool = mix, client, pool
        self.rng = np.random.default_rng([seed, 2, client])
        self.round: list[str] = []
        self.session = 0

    def next(self) -> Request:
        if not self.round:
            shapes = self.mix["shapes"]
            self.round = [shapes[i]
                          for i in self.rng.permutation(len(shapes))]
            if self.mix["samples"] == "session":
                # above the warm seeds' range, so never one of them
                self.session = int(self.rng.integers(1 << 31, 1 << 32))
        shape = self.round.pop(0)
        if self.mix["samples"] == "pool":
            sample = self.pool[int(self.rng.integers(len(self.pool)))]
        else:
            sample = self.session
        return Request(self.client, shape, sample)


def streams(mix: dict, seed: int) -> tuple[list[Stream], list[int]]:
    warm = warm_samples(mix, seed)
    return [Stream(mix, seed, c, warm) for c in range(mix["clients"])], warm
