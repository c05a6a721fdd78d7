"""The router's kernel entries on the cells' paths as custom ops, so that
a DTensor can carry them: each has a CUDA implementation (the
hand-written kernel's wrapper, which launches and counts it), a fake
implementation that checks the shapes and gives the outputs' shapes and
dtypes, and a sharding rule (:func:`register_rules`) that says how a
mesh may lay its arguments out.  ``kernels.ops`` calls them on CUDA
tensors; on the CPU it keeps the plain versions (an op called on CPU
tensors reaches its wrapper, which raises without a card).  A DTensor on a card
runs each op on its local shards, so the kernel launches on one chip's
share; a sharding its rule does not list is redistributed to one it
does, never run on a plain version.

* ``searchsorted_segments`` and ``searchsorted_segments_2level``: the
  sorted values (and the summary) whole on every chip, the rows (bounds
  and queries, and so the results) split.
* ``tile_member_mask``: the graph whole, the rows split.
* ``flash_attention`` (without and with each row's log-sum-exp) and
  ``flash_attention_bwd``: every operand split the same way along the
  batch or the heads (the caller makes the KV heads divide as the query
  heads do), or whole.
"""
from __future__ import annotations

import torch
from torch import Tensor

from . import flash_attention as _fa
from . import intersect as _intersect
from . import ref as _ref
from . import searchsorted as _searchsorted

_NS = "repro_torch"


def _check(cond: bool, op: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{op}: {msg}")


def _check_rows(op: str, queries: Tensor, *bounds: Tensor) -> None:
    _check(queries.dim() == 2, op, "queries must be (R, W)")
    r, w = queries.shape
    for t in bounds:
        _check(t.dim() == 2 and t.shape[0] == r and t.shape[1] in (1, w),
               op, "bounds must be (R, 1) or (R, W)")


# -- searchsorted ------------------------------------------------------------

@torch.library.custom_op(f"{_NS}::searchsorted_segments", mutates_args=())
def searchsorted_segments(values: Tensor, lo: Tensor, hi: Tensor,
                          queries: Tensor, n_iter: int
                          ) -> tuple[Tensor, Tensor]:
    return _searchsorted.searchsorted_segments_cuda(values, lo, hi, queries,
                                                    n_iter)


@searchsorted_segments.register_fake
def _(values, lo, hi, queries, n_iter):
    _check(values.dim() == 1, "searchsorted_segments", "values must be (M,)")
    _check_rows("searchsorted_segments", queries, lo, hi)
    return (queries.new_empty(queries.shape, dtype=torch.int32),
            queries.new_empty(queries.shape, dtype=torch.bool))


@torch.library.custom_op(f"{_NS}::searchsorted_segments_2level",
                         mutates_args=())
def searchsorted_segments_2level(values: Tensor, summary: Tensor,
                                 lo: Tensor, hi: Tensor, queries: Tensor,
                                 stride: int, n1: int, n2: int
                                 ) -> tuple[Tensor, Tensor]:
    # two launches of the one-level kernel with the window arithmetic
    # between them, as the plain version computes it
    pos, found = _ref.searchsorted_segments_2level_ref(
        values, summary, lo, hi, queries, stride, n1, n2,
        search=_searchsorted.searchsorted_segments_cuda)
    return pos.clone() if pos is queries else pos, found


@searchsorted_segments_2level.register_fake
def _(values, summary, lo, hi, queries, stride, n1, n2):
    op = "searchsorted_segments_2level"
    _check(values.dim() == 1 and summary.dim() == 1, op,
           "values and summary must be 1-D")
    _check_rows(op, queries, lo, hi)
    return (queries.new_empty(queries.shape, dtype=torch.int32),
            queries.new_empty(queries.shape, dtype=torch.bool))


# -- the tile mask ---------------------------------------------------------

@torch.library.custom_op(f"{_NS}::tile_member_mask", mutates_args=())
def tile_member_mask(indices: Tensor, lo: Tensor, hi: Tensor, cand: Tensor,
                     check_width: int, lane_len: Tensor | None) -> Tensor:
    return _intersect.tile_member_mask_cuda(indices, lo, hi, cand,
                                            check_width, lane_len)


@tile_member_mask.register_fake
def _(indices, lo, hi, cand, check_width, lane_len):
    op = "tile_member_mask"
    _check(indices.dim() == 1, op, "indices must be (M,)")
    _check(cand.dim() == 2, op, "cand must be (R, W)")
    r = cand.shape[0]
    for t in (lo, hi):
        _check(tuple(t.shape) == (r, 1), op, "lo and hi must be (R, 1)")
    _check(lane_len is None or tuple(lane_len.shape) == (r,), op,
           "lane_len must be (R,)")
    return cand.new_empty(cand.shape, dtype=torch.bool)


# -- flash attention -------------------------------------------------------

def _check_attention(q, k, v) -> None:
    op = "flash_attention"
    _check(q.dim() == 4 and k.dim() == 4 and v.dim() == 4, op,
           "q, k and v must be (B, H, T, D)")
    _check(k.shape == v.shape and k.shape[0] == q.shape[0]
           and k.shape[3] == q.shape[3], op, "k and v do not match q")
    _check(k.shape[1] >= 1 and q.shape[1] % k.shape[1] == 0, op,
           f"{q.shape[1]} query heads over {k.shape[1]} KV heads")


@torch.library.custom_op(f"{_NS}::flash_attention", mutates_args=())
def flash_attention(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                    scale: float | None) -> Tensor:
    return _fa.flash_attention_cuda(q, k, v, causal=causal, scale=scale)


@flash_attention.register_fake
def _(q, k, v, causal, scale):
    _check_attention(q, k, v)
    return q.new_empty(q.shape)


@torch.library.custom_op(f"{_NS}::flash_attention_lse", mutates_args=())
def flash_attention_lse(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                        scale: float | None) -> tuple[Tensor, Tensor]:
    return _fa.flash_attention_cuda(q, k, v, causal=causal, scale=scale,
                                    return_lse=True)


@flash_attention_lse.register_fake
def _(q, k, v, causal, scale):
    _check_attention(q, k, v)
    return (q.new_empty(q.shape),
            q.new_empty(q.shape[:3], dtype=torch.float32))


@torch.library.custom_op(f"{_NS}::flash_attention_bwd", mutates_args=())
def flash_attention_bwd(q: Tensor, k: Tensor, v: Tensor, o: Tensor,
                        do: Tensor, lse: Tensor | None, causal: bool,
                        scale: float | None
                        ) -> tuple[Tensor, Tensor, Tensor]:
    return _fa.flash_attention_bwd_cuda(q, k, v, o, do, causal, scale,
                                        lse=lse)


@flash_attention_bwd.register_fake
def _(q, k, v, o, do, lse, causal, scale):
    _check_attention(q, k, v)
    _check(o.shape == q.shape and do.shape == q.shape, "flash_attention_bwd",
           "o and do must have q's shape")
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


# -- sharding rules --------------------------------------------------------

def register_rules() -> None:
    """Register the ops' DTensor sharding rules (the module's docstring)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    ops = getattr(torch.ops, _NS)
    R = Replicate()

    def rows(n_whole: int, n_rows: int, n_out: int, n_none: int = 0):
        # whole: the first n_whole inputs; split: the next n_rows (and the
        # outputs) along dim 0; n_none trailing optional tensors absent
        tail = [None] * n_none
        return [([R] * n_out, [R] * (n_whole + n_rows) + tail),
                ([Shard(0)] * n_out,
                 [R] * n_whole + [Shard(0)] * n_rows + tail)]

    @register_sharding(ops.searchsorted_segments.default)
    def _ss(values, lo, hi, queries, n_iter):
        return rows(1, 3, 2)

    @register_sharding(ops.searchsorted_segments_2level.default)
    def _ss2(values, summary, lo, hi, queries, stride, n1, n2):
        return rows(2, 3, 2)

    @register_sharding(ops.tile_member_mask.default)
    def _tile(indices, lo, hi, cand, check_width, lane_len):
        if lane_len is None:
            return rows(1, 3, 1, n_none=1)
        return rows(1, 4, 1)

    def attention(n_in: int, n_out: int, q, k, absent=()):
        def spec(p):
            return [None if i in absent else p for i in range(n_in)]
        out = [([R] * n_out, spec(R)), ([Shard(0)] * n_out, spec(Shard(0)))]
        # the heads only where every mesh dim divides the query and the KV
        # heads, so each chip's query heads meet their own KV heads
        if all(q.shape[1] % s == 0 and k.shape[1] % s == 0
               for s in q.mesh.shape):
            out.append(([Shard(1)] * n_out, spec(Shard(1))))
        return out

    @register_sharding(ops.flash_attention.default)
    def _fa(q, k, v, causal, scale):
        return attention(3, 1, q, k)

    @register_sharding(ops.flash_attention_lse.default)
    def _fa_lse(q, k, v, causal, scale):
        return attention(3, 2, q, k)

    @register_sharding(ops.flash_attention_bwd.default)
    def _fa_bwd(q, k, v, o, do, lse, causal, scale):
        return attention(6, 3, q, k, absent=(5,) if lse is None else ())
