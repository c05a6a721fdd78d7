"""The dry run: every (arch × shape) cell's cost on one H100, without a
card.  The port of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch a,b] \\
        [--shape s,t] [--mesh card|single|multi|both] \\
        [--out reports/dryrun_torch] [--skip-existing]

For each cell (``configs``' ``cell()``) the arguments are made as fake
tensors on the CPU (``FakeTensorMode``: shapes and dtypes, no memory), so
the kernel router takes the plain versions, as the JAX dry run costs its
``ref`` path; the cell's function runs once under :class:`CostMode`,
which counts

* FLOPs by operand type: ``torch.utils.flop_counter``'s formulas for the
  products, one FLOP per output element for elementwise arithmetic.  A
  product whose operands are all bf16 or f16, or float32 copies of such
  (the plain path widens bf16 operands to multiply them where the card
  multiplies bf16 with a float32 result), counts as that type, on the
  tensor cores; every other product at its operands' type, elementwise
  float arithmetic as ``fp32`` (``fp64`` for float64) and integer and
  boolean arithmetic as ``int``.  Reductions, softmax and other
  non-elementwise ops count no FLOPs;
* bytes as the unfused bound: each op's inputs plus its outputs, the
  elements a tensor spans (a broadcast dim counted once); views count
  nothing;
* the arguments' and outputs' bytes, and the peak bytes of the tensors
  the run makes while they are alive (``temp_bytes``); the ops that
  move the most bytes (``top_bytes_by_op``).

Two of the kernel router's entries are costed as the card runs them, one
op each, in place of their plain versions (:data:`STAND_INS`):
``flash_attention`` as the flash kernels (the plain version holds the
(B, H, Tq, Tk) float32 scores, which the card never stores; and its
backward), and ``tile_member_mask`` as its kernel (the plain version
reads the widest live row on the host, which a fake tensor cannot give).
The other routed kernels are costed on their plain paths.

The collectives it issues are counted by ``roofline.CollectiveBytes``
(none on one card).  Each record holds the JAX record's keys where the
port has the quantity (``status``, ``kind``, ``note``, ``memory``,
``cost``, ``coll``, ``roofline``), ``trace_s`` in place of ``lower_s`` /
``compile_s``, and ``code_bytes`` null: nothing is compiled.  The port is
eager, so the count covers every layer and nothing is extrapolated from
cost probes.  The cost terms are the port's plain path, unfused; they
are not comparable with XLA's numbers.

``--mesh`` takes ``card``, the port's one card (a 1×1 mesh, the
default), ``single`` and ``multi``, the JAX package's 16×16 and 2×16×16
production meshes (records ``…__pod16x16.json`` and
``…__pod2x16x16.json``), and ``both``.  On a production mesh the run is
one chip's program, as XLA's partitioner gives the JAX dry run one
device's: each argument is a DTensor laid out by the cell's
``in_shardings`` over a fake process group of 256 or 512 ranks
(``launch.mesh.device_mesh``), its local shard chip 0's; the models'
sharding constraints place the activations; DTensor runs every op on
the local shards, and :class:`CostMode` counts those local ops (its
FLOPs, bytes and live bytes are chip 0's), not the global ones nor the
ones DTensor's sharding propagation runs on fake global tensors.  The
stand-ins are then the kernels' custom ops, run on each chip's share
under their sharding rules; the collectives DTensor issues (and the
reduction of each output to its ``out_shardings``) are counted by
``CollectiveBytes`` at their local operand sizes.  The argument and
output bytes are one chip's shards.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref
from collections import defaultdict

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..configs import ARCHS
from ..configs.common import Cell, NamedSharding, ShapeDtype, place
from ..kernels import custom as kcustom
from ..kernels import ops as kops
from ..kernels.flash_attention import FlashAttention
from ..layers.sharding import is_dtensor, on_mesh, wsc
from .mesh import device_mesh, make_mesh, make_production_mesh
from .roofline import CollectiveBytes, _has_dtensor, roofline_terms

#: mesh name -> (the mesh, the record files' mesh name)
MESHES = {"card": (make_mesh((1, 1), ("data", "model")), "card"),
          "single": (make_production_mesh(), "pod16x16"),
          "multi": (make_production_mesh(multi_pod=True), "pod2x16x16")}
#: ``--mesh`` choices beyond :data:`MESHES`
MESH_GROUPS = {"both": ("single", "multi")}

#: the ops that move the most bytes, kept in a record's ``cost``
TOP_OPS = 8

_LOW = (torch.bfloat16, torch.float16)
_LOW_NAMES = {torch.bfloat16: "bf16", torch.float16: "f16"}
_EMPTY = ("empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided")


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _span_bytes(t: torch.Tensor) -> int:
    """The bytes of the elements ``t`` spans: a dim of stride 0 (a
    broadcast) counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if size == 0:
            return 0
        if stride != 0:
            n *= size
    return n * t.element_size()


def _elementwise_type(ins: list) -> str:
    for t in ins:
        if t.dtype.is_floating_point:
            return "fp64" if t.dtype == torch.float64 else "fp32"
    return "int"


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def visible_pairs(tq: int, tk: int, causal: bool) -> int:
    """The (query, key) pairs attention scores: the queries are the last
    ``tq`` positions of the ``tk`` keys, and causal query i sees keys up
    to its own position."""
    if not causal:
        return tq * tk
    off = tk - tq
    if off >= 0:
        return tq * off + tq * (tq + 1) // 2
    return tk * (tk + 1) // 2


class _FlashAttention(torch.autograd.Function):
    """The flash kernels' cost: the forward reads q, k and v once and
    writes o (and, where a gradient is wanted, each row's float32
    log-sum-exp), with the two products QK^T and PV over the visible
    pairs; the backward reads q, k, v, o, do and the log-sum-exp and
    writes dq, dk and dv, with five products (QK^T again, dO V^T, P^T dO,
    dS K, dS^T Q).  Products count at q's type, as the kernels multiply.
    The outputs are empty tensors of the right shapes."""

    @staticmethod
    def forward(ctx, cost, q, k, v, causal):
        b, hq, tq, d = q.shape
        ctx.cost, ctx.lse = cost, (b * hq * tq * 4
                                   if any(ctx.needs_input_grad[1:4]) else 0)
        ctx.macs = b * hq * visible_pairs(tq, k.shape[2], causal) * d
        ctx.type = _LOW_NAMES.get(q.dtype) or _elementwise_type([q])
        o = q.new_empty(q.shape)
        cost.add("flash_attention", ctx.type, 4 * ctx.macs,
                 _nbytes(q, k, v, o) + ctx.lse)
        ctx.save_for_backward(q, k, v, o)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = (t.new_empty(t.shape) for t in (q, k, v))
        ctx.cost.add("flash_attention_backward", ctx.type, 10 * ctx.macs,
                     _nbytes(q, k, v, o, do, dq, dk, dv) + ctx.lse)
        return None, dq, dk, dv, None


class _Quiet:
    """Depth of DTensor's sharding propagation, which runs ops of its own
    on fake tensors (each op once at the global shapes to learn its
    output's shape; index arithmetic for uneven and strided shards): no
    chip runs those, so :class:`CostMode` does not count them."""

    depth = 0
    METHODS = ("propagate_op_sharding_non_cached",
               "_propagate_tensor_meta_non_cached")

    @classmethod
    def patch(cls):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        reals = {name: getattr(ShardingPropagator, name)
                 for name in cls.METHODS
                 if hasattr(ShardingPropagator, name)}

        def quiet(real):
            def run(self, *args, **kwargs):
                cls.depth += 1
                try:
                    return real(self, *args, **kwargs)
                finally:
                    cls.depth -= 1
            return run

        for name, real in reals.items():
            setattr(ShardingPropagator, name, quiet(real))
        return lambda: [setattr(ShardingPropagator, name, real)
                        for name, real in reals.items()]


def _card_alltoall():
    """Let a DTensor on a ``"cpu"`` mesh issue the all-to-all a card issues
    (``_dtensor.shard_dim_alltoall``) where DTensor would fall back to an
    all-gather and a chunk for gloo; returns the undo.  A torch without
    the hook keeps its fallback."""
    try:
        from torch.distributed.tensor import placement_types as pt
        from torch.distributed._functional_collectives import (
            _group_or_group_name, _resolve_group)
    except ImportError:
        return lambda: None
    real = getattr(pt, "shard_dim_alltoall", None)
    if real is None or not hasattr(torch.ops, "_dtensor"):
        return lambda: None

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        group = _resolve_group((mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, _group_or_group_name(group))

    pt.shard_dim_alltoall = alltoall
    return lambda: setattr(pt, "shard_dim_alltoall", real)


class CostMode(TorchDispatchMode):
    """Counts the FLOPs by type, the unfused bytes and the live bytes of
    the ops run under it (see the module's docstring).  Enter it inside
    the ``FakeTensorMode`` the arguments were made in; ``arguments`` are
    the run's arguments, whose storages are not counted as live.  While
    it is active the router's :data:`STAND_INS` are swapped in.

    With ``on_mesh`` the arguments are DTensors: an op on DTensors is
    left to DTensor (this mode returns ``NotImplemented``), which runs
    it on the local shards, and those ops, one chip's, are the ones
    counted; the stand-ins are then the kernels' custom ops
    (:data:`MESH_STAND_INS`), run on each chip's share under their
    sharding rules and costed here by name as the kernels run."""

    def __init__(self, arguments=(), on_mesh: bool = False):
        super().__init__()
        self.flops = defaultdict(float)
        self.bytes = 0
        self.bytes_by_op = defaultdict(int)
        self.live = 0
        self.peak = 0
        self.on_mesh = on_mesh
        self._known = weakref.WeakSet()
        # storage -> "bf16" or "f16": the float32 copies of such tensors
        self._widened = weakref.WeakKeyDictionary()
        for t in _tensors(arguments):
            self._known.add(_local(t).untyped_storage())

    def __enter__(self):
        stand_ins = MESH_STAND_INS if self.on_mesh else STAND_INS
        self._routed = {name: getattr(kops, name) for name in stand_ins}
        for name, stand_in in stand_ins.items():
            setattr(kops, name, stand_in.__get__(self))
        self._undo = _Quiet.patch() if self.on_mesh else None
        return super().__enter__()

    def __exit__(self, *exc):
        for name, fn in self._routed.items():
            setattr(kops, name, fn)
        if self._undo is not None:
            self._undo()
        return super().__exit__(*exc)

    def add(self, name: str, flops_type: str, flops: float,
            nbytes: int) -> None:
        """Count one fused op: ``flops`` of ``flops_type`` and ``nbytes``
        moved."""
        self.flops[flops_type] += float(flops)
        self.bytes += nbytes
        self.bytes_by_op[name] += nbytes

    def _flash_attention(self, q, k, v, causal: bool = True, scale=None):
        return _FlashAttention.apply(self, q, k, v, causal)

    def _tile_member_mask(self, indices, lo, hi, cand, check_width: int,
                          lane_len=None):
        """The tile kernel's cost (:func:`_tile_cost`); the mask is an
        empty tensor."""
        found = cand.new_empty(cand.shape, dtype=torch.bool)
        _tile_cost(self, indices, lo, hi, cand, check_width, lane_len, found)
        return found

    def _flash_attention_mesh(self, q, k, v, causal: bool = True,
                              scale=None):
        # the card's autograd Function over the kernels' custom ops, the
        # log-sum-exp kept for a gradient as both routes keep it
        return FlashAttention.apply(q, k, v, causal, scale)

    def _tile_member_mask_mesh(self, indices, lo, hi, cand,
                               check_width: int, lane_len=None):
        return kcustom.tile_member_mask(indices, lo, hi, cand, check_width,
                                        lane_len)

    def _kernel_cost(self, name: str, args, out) -> None:
        """Cost a kernel's custom op (``kernels.custom``) on one chip's
        share as the kernel runs it."""
        if name == "tile_member_mask":
            indices, lo, hi, cand, check_width, lane_len = args
            _tile_cost(self, indices, lo, hi, cand, check_width, lane_len,
                       out)
            return
        q, k, v = args[:3]
        macs = q.shape[0] * q.shape[1] * visible_pairs(
            q.shape[2], k.shape[2], args[6 if name.endswith("bwd") else 3]
        ) * q.shape[3]
        ftype = _LOW_NAMES.get(q.dtype) or _elementwise_type([q])
        if name == "flash_attention_bwd":
            o, do, lse = args[3:6]
            self.add(name, ftype, 10 * macs,
                     _nbytes(q, k, v, o, do, *out)
                     + (0 if lse is None else _nbytes(lse)))
        else:
            self.add(name, ftype, 4 * macs, _nbytes(q, k, v, *_tensors(out)))

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def _product_type(self, ins: list) -> str:
        low = set()
        for t in ins:
            if t.dtype in _LOW:
                low.add(_LOW_NAMES[t.dtype])
            elif t.untyped_storage() in self._widened:
                low.add(self._widened[t.untyped_storage()])
            else:
                return _elementwise_type([t])
        return low.pop() if len(low) == 1 else "fp32"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _Quiet.depth:
            return func(*args, **kwargs)
        if self.on_mesh and _has_dtensor(types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        name = func._schema.name.split("::")[-1]
        if func.namespace == kcustom._NS:
            self._kernel_cost(name, args, out)
        elif func.overloadpacket in flop_registry:
            n = flop_registry[func.overloadpacket](*args, **kwargs,
                                                   out_val=out)
            self.flops[self._product_type(ins)] += float(n)
        elif torch.Tag.pointwise in func.tags and outs:
            self.flops[_elementwise_type(ins)] += float(outs[0].numel())
        if (name == "_to_copy" and ins and ins[0].dtype in _LOW and outs
                and outs[0].dtype == torch.float32):
            self._widened[outs[0].untyped_storage()] = _LOW_NAMES[
                ins[0].dtype]
        in_storages = {id(t.untyped_storage()) for t in ins}
        aliases = not func._schema.is_mutable and all(
            id(t.untyped_storage()) in in_storages for t in outs)
        if (name not in _EMPTY and not aliases
                and func.namespace != kcustom._NS):
            nbytes = sum(_span_bytes(t) for t in ins + outs)
            self.bytes += nbytes
            self.bytes_by_op[name] += nbytes
        for t in outs:
            st = t.untyped_storage()
            if st in self._known:
                continue
            self._known.add(st)
            nbytes = st.nbytes()
            self.live += nbytes
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, nbytes)
        return out


def _tile_cost(cost: CostMode, indices, lo, hi, cand, check_width: int,
               lane_len, found) -> None:
    """The tile kernel's cost: each row's ``check_width`` staged values,
    its bounds, lane count and candidates read, the mask written, and a
    lower bound of ceil(log2(check_width + 1)) int32 compares for every
    lane (a fake tensor has no lane counts, so every lane is live)."""
    rows, w = cand.shape
    extra = (lo, hi) + (() if lane_len is None else (lane_len,))
    cost.add("tile_member_mask", "int",
             rows * w * max(1, check_width).bit_length(),
             rows * check_width * indices.element_size()
             + _nbytes(cand, found, *extra))


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (one chip's), else ``t``."""
    return t.to_local() if is_dtensor(t) else t


#: the router's entries costed as one op each while a CostMode is active
STAND_INS = {"flash_attention": CostMode._flash_attention,
             "tile_member_mask": CostMode._tile_member_mask}
#: the same on a mesh: the kernels' custom ops, which carry DTensors
MESH_STAND_INS = {"flash_attention": CostMode._flash_attention_mesh,
                  "tile_member_mask": CostMode._tile_member_mask_mesh}


def _storage_bytes(tensors) -> int:
    seen = {}
    for t in tensors:
        st = _local(t).untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


def _place_args(cell: Cell, fake, dmesh) -> list:
    """The cell's abstract arguments as fake tensors: whole on one card
    (``dmesh`` None), else each a DTensor on ``dmesh`` whose local shard
    is one chip's, laid out as the cell's ``in_shardings`` say."""
    def walk(arg, sh):
        if isinstance(arg, ShapeDtype):
            if dmesh is None:
                return arg.fake(fake)
            shape = arg.shape if sh is None else sh.shard_shape(arg.shape)
            return place(ShapeDtype(shape, arg.dtype).fake(fake), sh,
                         dmesh, arg.shape)
        if isinstance(arg, dict):
            return {k: walk(v, sh.get(k) if isinstance(sh, dict) else sh)
                    for k, v in arg.items()}
        if isinstance(arg, (list, tuple)):
            subs = (sh if isinstance(sh, (list, tuple))
                    and len(sh) == len(arg) else [sh] * len(arg))
            return type(arg)(walk(a, b) for a, b in zip(arg, subs))
        return arg

    shardings = cell.in_shardings
    if shardings is None:
        shardings = [None] * len(cell.args)
    return [walk(a, s) for a, s in zip(cell.args, shardings)]


def _lay_out(out, shardings):
    """The step's outputs laid out as the cell's ``out_shardings`` say, as
    ``jax.jit`` lays them out (a partial sum reduced, a split gathered);
    a leaf without one, or a plain tensor, as it is."""
    if is_dtensor(out):
        if isinstance(shardings, NamedSharding):
            return wsc(out, shardings.spec)
        return out
    if isinstance(out, dict):
        return {k: _lay_out(v, shardings.get(k) if isinstance(
            shardings, dict) else None) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        subs = (shardings if isinstance(shardings, (list, tuple))
                and len(shardings) == len(out) else [None] * len(out))
        return type(out)(_lay_out(o, s) for o, s in zip(out, subs))
    return out


def measure(cell: Cell, mesh=None) -> dict:
    """Run ``cell.fn`` once on fake tensors of its abstract arguments and
    return ``trace_s``, ``memory``, ``cost``, ``coll`` and ``roofline``.
    ``mesh`` (a ``launch.mesh.Mesh``) of more than one chip runs the
    cell's per-chip program: each argument a DTensor on a fake process
    group of ``mesh.size`` ranks (``launch.mesh.device_mesh``), laid out
    by the cell's ``in_shardings``, and every count one chip's.  Without
    it, or on a 1×1 mesh, the card's whole program."""
    chips = 1 if mesh is None else mesh.size
    dmesh = device_mesh(mesh, "cpu") if chips > 1 else None
    fake = FakeTensorMode()
    args = _place_args(cell, fake, dmesh)
    undo = _card_alltoall() if dmesh is not None else (lambda: None)
    t0 = time.perf_counter()
    try:
        with fake, CollectiveBytes() as coll, CostMode(
                args, on_mesh=dmesh is not None) as cost, on_mesh(args):
            out = _lay_out(cell.fn(*args), cell.out_shardings)
    finally:
        undo()
    trace_s = time.perf_counter() - t0
    counted = {
        "flops": sum(cost.flops.values()),
        "bytes accessed": float(cost.bytes),
        "flops_by_dtype": dict(cost.flops),
        "top_bytes_by_op": dict(sorted(cost.bytes_by_op.items(),
                                       key=lambda kv: -kv[1])[:TOP_OPS]),
    }
    rl = roofline_terms(counted, chips, model_flops=cell.model_flops,
                        coll=coll.result())
    return {
        "trace_s": round(trace_s, 2),
        "memory": {
            "argument_bytes": _storage_bytes(_tensors(args)),
            # a train step's outputs are its arguments, updated in place
            "output_bytes": _storage_bytes(_tensors(out)),
            "temp_bytes": cost.peak,
            "code_bytes": None,
        },
        "cost": counted,
        "coll": coll.result(),
        "roofline": rl.to_dict(),
    }


def _fname(out_dir: str, arch_id: str, shape_name: str,
           mesh_name: str) -> str:
    return os.path.join(out_dir, f"{arch_id}__{shape_name}__{mesh_name}.json")


def run_cell(arch_id: str, shape_name: str, mesh_name: str,
             out_dir: str) -> dict:
    """Cost one cell on ``mesh_name`` (a key of :data:`MESHES`) and write
    its record to ``out_dir``."""
    mesh, rec_name = MESHES[mesh_name]
    rec = {"arch": arch_id, "shape": shape_name, "mesh": rec_name,
           "chips": mesh.size}
    cell = ARCHS[arch_id].cell(shape_name, mesh)
    if cell.skip:
        rec["status"] = "skipped"
        rec["reason"] = cell.skip
    else:
        rec.update({"status": "ok", "kind": cell.kind, "note": cell.note,
                    **measure(cell, mesh)})
    with open(_fname(out_dir, arch_id, shape_name, rec_name), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="dry run of the port's cells")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="card",
                    choices=list(MESHES) + list(MESH_GROUPS))
    ap.add_argument("--out", default="reports/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    meshes = MESH_GROUPS.get(args.mesh, (args.mesh,))
    results = []
    for arch_id in archs:
        arch = ARCHS[arch_id]
        shapes = (list(arch.shapes) if args.shape == "all"
                  else [s for s in args.shape.split(",")
                        if s in arch.shapes])
        for shape_name in shapes:
            for mesh_name in meshes:
                rec_name = MESHES[mesh_name][1]
                fname = _fname(args.out, arch_id, shape_name, rec_name)
                if args.skip_existing and os.path.exists(fname):
                    print(f"[skip existing] {fname}")
                    continue
                tag = f"{arch_id} x {shape_name} x {rec_name}"
                try:
                    rec = run_cell(arch_id, shape_name, mesh_name, args.out)
                except Exception as e:  # noqa: BLE001 - recorded per cell
                    rec = {"arch": arch_id, "shape": shape_name,
                           "mesh": rec_name, "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                    with open(fname, "w") as f:
                        json.dump(rec, f, indent=1)
                results.append(rec)
                _report(tag, rec)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\ndry-run done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    return 0 if n_err == 0 else 1


def _report(tag: str, rec: dict) -> None:
    if rec["status"] == "ok":
        rl = rec["roofline"]
        print(f"[ok] {tag}: trace {rec['trace_s']}s "
              f"flops {rl['flops_per_chip']:.3g} "
              f"bytes {rl['bytes_per_chip']:.3g} "
              f"bottleneck {rl['bottleneck']} "
              f"(c={rl['t_compute']:.2e}s m={rl['t_memory']:.2e}s "
              f"x={rl['t_collective']:.2e}s) "
              f"useful={rl['useful_ratio']:.2f}", flush=True)
    elif rec["status"] == "skipped":
        print(f"[skipped] {tag}: {rec['reason']}", flush=True)
    else:
        print(f"[ERROR] {tag}: {rec['error']}", flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
