"""What a profile window's post-processing costs on the host, and whether
``chip_smoke.device_totals`` gives the sums ``key_averages()`` gives.

    python3 tools/profile_sum_cost.py [--launches 20000,100000]

On one CUDA device, for each count of launches: that many small
elementwise kernels under ``torch.profiler`` tracing the device only,
then the seconds of the window's exit, of ``device_totals`` (the raw
Kineto events summed by name) and of ``key_averages()``, and each
kernel's launches and device microseconds by both.  Then the same two
on a window of the port's own kernels (the tensor-core flash forward
and backward, bf16, B 1 x 32 heads x T 1024 x D 80, built from this
checkout's sources), with the count of raw names that arrive mangled
and ``device_ms`` of the backward's three kernels.  Then the windows'
first launches (``--edge-windows`` windows each way, with and without
``chip_smoke.open_window`` first): the profiler started, 5 float32
2048 x 2048 products launched and synchronized, the profiler stopped;
the products each window recorded (all 5, where none is lost), and
the first recorded start and last recorded end against the host's
clock (``time.time_ns``) just before the first launch and after the
synchronize.  A window that comes
back without device activity is run again (``chip_smoke.PROFILE_TRIES``
windows at most), as ``chip_smoke.traced`` does.  Exits 1 where the two
disagree, in names, launches or a relative 1e-9 of the time, or where
every try of a window came back empty.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--launches", default="20000,100000")
    ap.add_argument("--edge-windows", type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("profile_sum_cost: no CUDA device", file=sys.stderr)
        return 2
    print(torch.__version__, torch.cuda.get_device_name(0))
    from repro_torch.kernels import flash_attention as fa
    x = torch.ones(1024, device="cuda")

    def window(fn, what: str) -> bool:
        for i in range(cs.PROFILE_TRIES):
            torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prof.__exit__(None, None, None)
            t1 = time.perf_counter()
            raw = {e.key: (e.count, cs.device_us(e))
                   for e in cs.device_totals(prof)}
            t2 = time.perf_counter()
            if raw:
                break
            print(f"{what}: no device activity on try {i + 1}")
        else:
            return False
        avg = {e.key: (e.count, cs.device_us(e))
               for e in prof.key_averages() if cs.device_us(e)}
        t3 = time.perf_counter()
        mangled = sum(e.name().startswith("_Z")
                      for e in prof.profiler.kineto_results.events())
        print(f"{what}: exit {t1 - t0:.3f} s, device_totals "
              f"{t2 - t1:.3f} s, key_averages {t3 - t2:.3f} s; raw "
              f"events with a mangled name {mangled}")
        ok = True
        for key in sorted(set(raw) | set(avg)):
            a, b = raw.get(key, (0, 0.0)), avg.get(key, (0, 0.0))
            same = a[0] == b[0] and abs(a[1] - b[1]) <= 1e-9 * max(b[1], 1)
            ok &= same
            print(f"  {key[:90]}: device_totals {a}, key_averages {b}"
                  f"{'' if same else '  DIFFER'}")
        return ok

    ok = True
    for n in (int(v) for v in args.launches.split(",")):
        ok &= window(lambda: [x.add_(1) for _ in range(n)],
                     f"launches {n}")
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(1, 1024, 32, 80, generator=g, device="cuda")
               .to(torch.bfloat16).transpose(1, 2) for _ in range(3))
    o, lse = fa.flash_attention_cuda(q, k, v, True, return_lse=True)
    do = torch.randn(o.shape, generator=g, device="cuda").to(o.dtype)
    run = lambda: fa.flash_attention_bwd_cuda(q, k, v, o, do, lse=lse)
    ok &= window(lambda: (fa.flash_attention_cuda(q, k, v, True,
                                                  return_lse=True),
                          run()), "flash forward and backward")
    print(f"device_ms of the backward: "
          f"{cs.device_ms(run, 5, *cs.FLASH_BWD_TC_KERNELS):.5f} ms")
    edges(args, torch, profile, ProfilerActivity)
    return 0 if ok else 1


def edges(args, torch, profile, ProfilerActivity) -> None:
    """The windows' first launches, as the module's docstring says."""
    from torch.autograd import DeviceType
    a = torch.randn(2048, 2048, device="cuda")
    b = torch.randn(2048, 2048, device="cuda")
    a @ b
    torch.cuda.synchronize()
    for opened in (False, True):
        counts, lead_us, tail_us = [], [], []
        for _ in range(args.edge_windows):
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
            if opened:
                cs.open_window()
            t0 = time.time_ns()
            for _ in range(5):
                a @ b
            torch.cuda.synchronize()
            t1 = time.time_ns()
            prof.__exit__(None, None, None)
            dev = [e for e in prof.profiler.kineto_results.events()
                   if e.device_type() != DeviceType.CPU
                   and cs.OPENING_KERNEL not in e.name()]
            counts.append(len(dev))
            if dev:
                lead_us.append((min(e.start_ns() for e in dev) - t0) / 1e3)
                tail_us.append((t1 - max(e.end_ns() for e in dev)) / 1e3)
        print(f"open_window {opened}: products recorded per window "
              f"{counts}; first "
              f"start - host launch us {[round(v) for v in lead_us]}; "
              f"host after sync - last end us {[round(v) for v in tail_us]}")


if __name__ == "__main__":
    sys.exit(main())
