"""The port's roofline and dry-run entry point: ``roofline_terms`` against
hand-worked numbers, ``CollectiveBytes`` over torch's fake process group,
the cost counter on small products and on the router's two stand-ins
(flash attention and the tile mask, one op each), and ``python -m
repro_torch.launch.dryrun`` writing its records (``--mesh card``) or
refusing the meshes it cannot cost yet (``single``, ``multi``)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.common import Cell, sds
from repro_torch.launch import roofline
from repro_torch.kernels import ops as kops
from repro_torch.launch.dryrun import CostMode, measure, visible_pairs

ROOT = Path(__file__).resolve().parent.parent


def test_roofline_terms_by_hand():
    """One second of each type's peak, two seconds of HBM bytes, one of
    NVLink over 4 cards: the compute term is the sum of the types'."""
    cost = {"flops": 989e12 + 67e12 + 16.75e12,
            "bytes accessed": 2 * 3.35e12,
            "flops_by_dtype": {"bf16": 989e12, "fp32": 67e12,
                               "int": 16.75e12}}
    coll = {"all-reduce": 4 * 450e9, "n_all-reduce": 3}
    rl = roofline.roofline_terms(cost, 4, model_flops=1e15, coll=coll)
    assert rl.t_compute == pytest.approx(3.0, rel=1e-12)
    assert rl.t_memory == pytest.approx(2.0, rel=1e-12)
    assert rl.t_collective == pytest.approx(1.0, rel=1e-12)
    assert rl.bottleneck == "compute" and rl.bound_s == rl.t_compute
    assert rl.coll_bytes_total == 4 * 450e9
    assert rl.useful_ratio == pytest.approx(1e15 / (4 * cost["flops"]))
    d = rl.to_dict()
    assert d["bound_s"] == rl.bound_s and d["flops_by_dtype"]["int"] > 0
    # without a split every FLOP counts at the bf16 peak, as JAX's one rate
    bare = roofline.roofline_terms({"flops": 989e12, "bytes accessed": 0},
                                   1)
    assert bare.t_compute == pytest.approx(1.0) and bare.t_collective == 0
    assert bare.bottleneck == "compute"
    with pytest.raises(ValueError, match="no peak"):
        roofline.roofline_terms({"flops_by_dtype": {"fp8": 1.0}}, 1)


def test_the_peaks_are_the_h100_data_sheet():
    assert roofline.PEAK_BYTES_S == 3.35e12
    assert roofline.PEAK_FLOPS_S["bf16"] == 989e12
    assert roofline.PEAK_FLOPS_S["tf32"] == 495e12
    assert roofline.PEAK_FLOPS_S["fp32"] == 67e12
    assert roofline.PEAK_INT32_OPS_S == 16.75e12


@pytest.fixture
def fake_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_collective_bytes_over_the_fake_process_group(fake_group):
    import torch.distributed._functional_collectives as fc
    x = torch.ones(1024)
    got = roofline.collective_bytes(dist.all_reduce, x)
    assert got["all-reduce"] == 4096 and got["n_all-reduce"] == 1
    assert sum(v for k, v in got.items() if k != "all-reduce"
               and k != "n_all-reduce") == 0

    def mixed():
        dist.all_gather_into_tensor(torch.empty(4096), x)
        dist.reduce_scatter_tensor(torch.empty(256), x)
        dist.all_to_all_single(torch.empty(1024, dtype=torch.half), x.half())
        fc.wait_tensor(fc.all_reduce(x[:16], "sum", dist.group.WORLD))
        dist.broadcast(x, 0)

    got = roofline.collective_bytes(mixed)
    assert got == {"all-reduce": 64, "all-gather": 4096,
                   "reduce-scatter": 4096, "all-to-all": 2048,
                   "collective-permute": 0, "n_all-reduce": 1,
                   "n_all-gather": 1, "n_reduce-scatter": 1,
                   "n_all-to-all": 1, "n_collective-permute": 0}


def test_cost_mode_counts_products_by_type_and_bytes():
    """A bf16 product, the same on float32 copies of bf16 tensors (the
    plain path's widened product), a float32 product and an int add."""
    fake = FakeTensorMode()
    with fake:
        a = torch.empty(64, 32, dtype=torch.bfloat16)
        b = torch.empty(32, 16, dtype=torch.bfloat16)
        f = torch.empty(16, 8)
        i = torch.empty(100, dtype=torch.int32)
    with fake, CostMode((a, b, f, i)) as cost:
        a @ b
        y = a.float() @ b.float()
        y @ f
        i + i
    prod = 2 * 64 * 32 * 16
    assert cost.flops["bf16"] == 2 * prod
    assert cost.flops["fp32"] == 2 * 64 * 16 * 8
    assert cost.flops["int"] == 100
    # bytes: each op's inputs and outputs; the casts count too
    bf = (64 * 32 + 32 * 16) * 2
    want = (bf + 64 * 16 * 2                      # a @ b
            + bf + (64 * 32 + 32 * 16) * 4        # the two casts
            + (64 * 32 + 32 * 16) * 4 + 64 * 16 * 4   # widened product
            + (64 * 16 + 16 * 8 + 64 * 8) * 4     # y @ f
            + 3 * 100 * 4)                        # i + i
    assert cost.bytes == want
    assert cost.peak > 0


def test_visible_pairs_by_hand():
    assert visible_pairs(4, 4, True) == 1 + 2 + 3 + 4
    assert visible_pairs(2, 5, True) == 4 + 5      # the last two queries
    assert visible_pairs(5, 3, True) == 1 + 2 + 3  # two see no key
    assert visible_pairs(3, 7, False) == 21


def test_cost_mode_costs_flash_attention_as_the_kernels():
    """The router's attention, forward and backward, counts as one op
    each: the two (forward) and five (backward) products over the visible
    pairs at q's type, and q, k, v, o (dq, dk, dv, do) with each row's
    float32 log-sum-exp as bytes; none of the plain version's (B, H, Tq,
    Tk) scores.  The router is restored on exit."""
    routed = kops.flash_attention
    b, hq, hkv, t, d = 2, 4, 2, 64, 16
    fake = FakeTensorMode()
    with fake:
        q = torch.empty(b, hq, t, d, dtype=torch.bfloat16,
                        requires_grad=True)
        k, v = (torch.empty(b, hkv, t, d, dtype=torch.bfloat16,
                            requires_grad=True) for _ in range(2))
    with fake, CostMode((q, k, v)) as cost:
        o = kops.flash_attention(q, k, v, causal=True)
        assert o.shape == q.shape and o.dtype == q.dtype
        o.sum().backward()
    assert kops.flash_attention is routed
    macs = b * hq * visible_pairs(t, t, True) * d
    assert cost.flops["bf16"] == 14 * macs
    qb, kvb, lse = q.numel() * 2, k.numel() * 2, b * hq * t * 4
    assert cost.bytes_by_op["flash_attention"] == 2 * qb + 2 * kvb + lse
    assert cost.bytes_by_op["flash_attention_backward"] == (
        4 * qb + 4 * kvb + lse)
    assert not {"bmm", "_softmax", "masked_fill"} & set(cost.bytes_by_op)
    assert q.grad.shape == q.shape and k.grad.shape == k.shape


def test_cost_mode_costs_the_tile_mask_from_shapes():
    """The tile mask's lane counts are data: the stand-in reads none and
    counts every lane's ceil(log2(check_width + 1)) compares."""
    rows, w, cw = 32, 24, 16
    fake = FakeTensorMode()
    with fake:
        indices = torch.empty(1000, dtype=torch.int32)
        lo, hi = (torch.empty(rows, 1, dtype=torch.int32) for _ in range(2))
        cand = torch.empty(rows, w, dtype=torch.int32)
        lanes = torch.empty(rows, dtype=torch.int32)
    with fake, CostMode((indices, lo, hi, cand, lanes)) as cost:
        found = kops.tile_member_mask(indices, lo, hi, cand, cw, lanes)
    assert found.shape == (rows, w) and found.dtype == torch.bool
    assert cost.flops["int"] == rows * w * 5
    assert cost.bytes == rows * cw * 4 + (3 * rows + rows * w) * 4 + (
        rows * w)


def test_measure_a_cell():
    cell = Cell("t", "s", "forward", lambda x, w: torch.relu(x @ w),
                (sds((128, 64), torch.float32), sds((64, 32),
                                                    torch.float32)),
                model_flops=2.0 * 128 * 64 * 32)
    rec = measure(cell)
    assert rec["cost"]["flops_by_dtype"]["fp32"] == 2 * 128 * 64 * 32 + (
        128 * 32)
    assert rec["memory"]["argument_bytes"] == (128 * 64 + 64 * 32) * 4
    assert rec["memory"]["output_bytes"] == 128 * 32 * 4
    assert rec["memory"]["code_bytes"] is None
    assert rec["roofline"]["bottleneck"] in ("compute", "memory")
    assert rec["coll"]["n_all-reduce"] == 0


def _dryrun(tmp_path, *argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
         "--out", str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=600)


def test_dryrun_cli_writes_ok_records(tmp_path):
    got = _dryrun(tmp_path, "--mesh", "card", "--arch", "wcoj,xdeepfm")
    assert got.returncode == 0, got.stderr[-2000:]
    recs = [json.loads(p.read_text()) for p in sorted(tmp_path.iterdir())]
    assert len(recs) == 10 + 4
    for r in recs:
        assert r["status"] == "ok", r
        assert r["cost"]["flops"] > 0 and r["cost"]["bytes accessed"] > 0
        assert r["mesh"] == "card" and r["chips"] == 1
        assert r["roofline"]["t_memory"] > 0
    assert "14 ok, 0 skipped, 0 errors" in got.stdout


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_dryrun_cli_refuses_the_production_meshes(tmp_path, mesh):
    """``--mesh single`` and ``multi``, refused (exit 2) until the port had
    per-chip programs, now write one record a cell, one chip's program
    of 256 or 512 (the test keeps its name)."""
    got = _dryrun(tmp_path, "--mesh", mesh, "--arch", "xdeepfm")
    assert got.returncode == 0, got.stderr[-2000:]
    name, chips = {"single": ("pod16x16", 256),
                   "multi": ("pod2x16x16", 512)}[mesh]
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == sorted(f"xdeepfm__{s}__{name}.json" for s in
                           ("train_batch", "serve_p99", "serve_bulk",
                            "retrieval_cand"))
    for p in tmp_path.iterdir():
        r = json.loads(p.read_text())
        assert r["status"] == "ok" and r["mesh"] == name, r
        assert r["chips"] == r["roofline"]["chips"] == chips
        assert r["cost"]["flops"] > 0 and r["memory"]["argument_bytes"] > 0
        assert r["roofline"]["t_memory"] > 0
    assert "4 ok, 0 skipped, 0 errors" in got.stdout
