"""Distributed execution: sharded WCOJ, collective overlap, compression
(the port of ``repro.dist``).

The paper's evaluation runs worst-case-optimal joins across parallel
workers; EmptyHeaded-style systems get their order-of-magnitude wins from
partitioned execution of the same plans.  This package is that layer for
the port, over ``torch.distributed`` where the JAX package uses a mesh:

* **SPMD rank sharding** (``sharded_join``): one expansion level or
  counting SpMV running identically on every rank of a process group,
  frontier/edge rows split into rank blocks, one ``all_reduce`` per
  step (NCCL on the cards, gloo on the CPU).
* **Host work partitioning** (``sharded_join.PartitionedJoin``): the
  paper's granularity-factor over-partitioning — the first GAO level's
  seed domain is dealt into ``n_workers x granularity`` cost-balanced
  parts, scheduled statically, and executed on a real
  ``concurrent.futures`` pool (``pool.WorkerPool`` — threads for any
  payload holding a tensor),
  so a straggling worker delays at most one small part (see
  ``train.stragglers`` for the re-deal policy).  The query server routes
  large graphs' ``vlftj`` plans here.
* **Adaptive skew handling** (``rebalance``): per-shard frontier cost is
  re-measured at every GAO level boundary and, past a skew threshold,
  frontier rows are re-dealt with the same snake deal the first-level
  partitioner uses — a power-law hub discovered mid-join no longer pins
  one worker (``AdaptiveJoin``, ``FrontierRebalancer``).
* **Sharded CSR** (``sharded_csr.ShardedGraphDB``): a row-partitioned
  graph for joins too large to replicate per card; remote adjacency
  arrives over the same ring the all-reduce uses.

``overlap`` and ``compression`` serve the training side: a ring
all-reduce, chunked reduce/apply overlap, and int8-quantized all-reduce
with per-rank error feedback, wired into a data-parallel train step by
``compressed_step``.
"""
from . import (compressed_step, compression, overlap, pool, rebalance,
               sharded_csr, sharded_join)
from .compressed_step import (init_compressed_state,
                              make_compressed_train_step,
                              make_dp_train_step, resize_compressed_state)
from .compression import compressed_psum_leaf, compressed_psum_tree
from .overlap import overlapped_reduce_apply, ring_all_reduce, ring_schedule
from .pool import WorkerPool, pick_backend
from .rebalance import AdaptiveJoin, FrontierRebalancer, adaptive_count
from .sharded_csr import (ShardedGraphDB, sharded_count,
                          spmd_sharded_join_step)
from .sharded_join import PartitionedJoin, spmd_join_step, spmd_spmv_step

__all__ = [
    "compressed_step", "init_compressed_state",
    "make_compressed_train_step", "make_dp_train_step",
    "resize_compressed_state", "compression", "overlap", "pool", "rebalance", "sharded_csr",
    "sharded_join", "compressed_psum_leaf", "compressed_psum_tree",
    "overlapped_reduce_apply", "ring_all_reduce", "ring_schedule",
    "WorkerPool", "pick_backend", "AdaptiveJoin", "FrontierRebalancer",
    "adaptive_count", "ShardedGraphDB", "sharded_count",
    "spmd_sharded_join_step", "PartitionedJoin", "spmd_join_step",
    "spmd_spmv_step",
]
