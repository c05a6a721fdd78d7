"""Roofline terms on an NVIDIA H100: the port of ``repro.launch.roofline``.

Terms (seconds), per (arch × shape × mesh):
    compute    = Σ over operand types of that type's FLOPs / its peak
    memory     = bytes accessed / HBM bytes/s
    collective = Σ collective operand bytes / (chips × NVLink bytes/s)

The compute term sums over types because the port's products do not all
run at one rate: its training step runs bf16 products on the tensor
cores and the float32 products of ``layers.common._WideProduct``'s
backward on the CUDA cores, where bf16's 989 TFLOP/s would claim a bound
the card cannot reach.  FLOPs, bytes and collectives come from the dry
run's count (``launch.dryrun``); :class:`CollectiveBytes` counts the
``torch.distributed`` collectives a run issues, a DTensor's among them
(its ``_c10d_functional`` ops and its all-to-all); on a mesh they are one
chip's, the operands of its local shards.

The collective term keeps the JAX package's formula
(``repro.launch.roofline``): the summed operand bytes of one chip's
collectives over ``chips`` times one card's link rate, with compute and
memory per chip.  It assumes every collective rides NVLink at 450 GB/s
a card each way on every mesh: on the card (1×1) there is none, on the
16×16 and 2×16×16 meshes the formula spreads each chip's bytes over the
whole mesh's links as the JAX one does.  256 and 512 H100s span 32 and
64 NVLink domains of 8 cards (an HGX H100 board, NVIDIA's HGX data
sheet); the hops between domains run over the scale-out network
(InfiniBand NDR, 50 GB/s a card each way), which the term does not see,
so it is a bound of the NVLink part only.

Peaks of one H100 SXM from NVIDIA's data sheet (dense, without sparsity,
at the full 700 W): 3.35 TB/s of HBM; bf16 and fp16 989, TF32 495, fp32
67 and fp64 34 TFLOP/s; NVLink 900 GB/s a card, 450 GB/s each way.  The
data sheet gives no int32 rate: its 67 TFLOP/s fp32 is 132 SMs x 128 FMA
lanes x 2 FLOP x 1.98 GHz, and the CUDA C++ Programming Guide's
arithmetic throughput table gives compute capability 9.0 64 results per
clock per SM for 32-bit integer add, compare, min/max, shift and logic
(against 128 for fp32), so integer ops peak at 67e12 / 4 per second.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

#: HBM bytes per second of one card
PEAK_BYTES_S = 3.35e12
#: integer operations per second (32-bit add, compare, logic; wider
#: integers are counted at this rate too, which keeps the bound a bound)
PEAK_INT32_OPS_S = 67e12 / 4
#: floating-point peaks: dense bf16, fp16 and TF32 on the tensor cores,
#: fp32 and fp64 on the CUDA cores
PEAK_FLOPS_S = {"bf16": 989e12, "f16": 989e12, "tf32": 495e12,
                "fp32": 67e12, "fp64": 34e12}
#: the peak of each operand type the dry run counts (``int`` covers every
#: integer and boolean type)
PEAK_OPS_S = dict(PEAK_FLOPS_S, int=PEAK_INT32_OPS_S)
#: NVLink bytes per second that one card sends (900 GB/s both ways)
LINK_BYTES_S = 450e9

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

#: op name (without its namespace) -> the JAX collective kind it counts as
_KIND = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute",
    # DTensor's redistribution between two sharded dims
    "shard_dim_alltoall": "all-to-all",
}
_NAMESPACES = ("c10d", "_c10d_functional", "_dtensor")


def _operand_bytes(func, args) -> int:
    """The bytes of a collective's operands: the argument after the
    outputs where the op's first argument is its output, else the first."""
    first = func._schema.arguments[0].name
    operand = args[1] if first.startswith("output") else args[0]
    return sum(t.numel() * t.element_size() for t in tree_leaves(operand)
               if isinstance(t, torch.Tensor))


class CollectiveBytes(TorchDispatchMode):
    """Counts the collectives run under it (``c10d.*``, as
    ``torch.distributed`` issues them, and ``_c10d_functional.*``): per
    kind the summed operand bytes and the calls, as
    :func:`collective_bytes` gives them.  A point-to-point send counts as
    a ``collective-permute``; a receive, a broadcast and a barrier are not
    counted (JAX's HLO scan has no such kinds)."""

    def __init__(self):
        super().__init__()
        self.bytes = dict.fromkeys(COLLECTIVES, 0)
        self.calls = dict.fromkeys(COLLECTIVES, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _has_dtensor(types):
            # DTensor runs the op on its shards and issues the
            # collectives of its redistributions: those pass here
            return NotImplemented
        kind = (_KIND.get(func._schema.name.split("::")[-1])
                if func.namespace in _NAMESPACES else None)
        if kind is not None:
            self.bytes[kind] += _operand_bytes(func, args)
            self.calls[kind] += 1
        return func(*args, **(kwargs or {}))

    def result(self) -> dict:
        """Per kind the summed operand bytes, plus ``n_<kind>`` calls:
        the dict ``repro.launch.roofline.collective_bytes`` gives."""
        return {**self.bytes, **{f"n_{k}": v for k, v in self.calls.items()}}


def _has_dtensor(types) -> bool:
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


def collective_bytes(fn, *args, **kwargs) -> dict:
    """``fn(*args, **kwargs)`` run under :class:`CollectiveBytes`: its
    collectives' summed operand bytes per kind and their calls."""
    with CollectiveBytes() as counter:
        fn(*args, **kwargs)
    return counter.result()


@dataclass
class Roofline:
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_total: float
    chips: int
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float
    useful_ratio: float
    coll_detail: dict
    flops_by_dtype: dict

    @property
    def bound_s(self) -> float:
        """The least time of the step: its largest term."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def to_dict(self):
        return dict(asdict(self), bound_s=self.bound_s)


def roofline_terms(cost: dict, chips: int, model_flops: float = 0.0,
                   coll: dict | None = None) -> Roofline:
    """The terms of one chip's program: ``cost["flops_by_dtype"]`` (type
    -> FLOPs, the types of :data:`PEAK_OPS_S`; without it every FLOP of
    ``cost["flops"]`` counts at the bf16 peak) each over its type's peak,
    ``cost["bytes accessed"]`` over :data:`PEAK_BYTES_S`, and ``coll``'s
    operand bytes over ``chips`` cards' NVLink."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    by_dtype = dict(cost.get("flops_by_dtype") or {"bf16": flops})
    unknown = set(by_dtype) - set(PEAK_OPS_S)
    if unknown:
        raise ValueError(f"roofline_terms: no peak for {sorted(unknown)}")
    coll = coll or {}
    cb = float(sum(v for k, v in coll.items() if not k.startswith("n_")))
    t_c = sum(v / PEAK_OPS_S[k] for k, v in by_dtype.items())
    t_m = byts / PEAK_BYTES_S
    t_x = cb / (chips * LINK_BYTES_S)
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)
    total_flops = flops * chips
    useful = model_flops / total_flops if total_flops else 0.0
    return Roofline(flops, byts, cb, chips, t_c, t_m, t_x, bottleneck,
                    model_flops, useful, coll, by_dtype)
