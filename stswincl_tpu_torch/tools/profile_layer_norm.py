"""Rows 14 and 15 (`csrc/add_layernorm.cu`) timed four ways, beside
`F.layer_norm`, at the shapes of `chip_smoke.py` phases 2d and 2e.

    python3 -m stswincl_tpu_torch.tools.profile_layer_norm [--reps 50]

At a few tens of microseconds of work a call, how a kernel is timed
decides what the number says. For each call it prints:
  - single ms: the median of `--reps` single calls, each between two CUDA
    events (as `chip_smoke.py`'s `ms`): the host's time to reach the
    launch counts whenever it exceeds the card's idle gap;
  - device ms: the mean over `--reps` back-to-back calls between two CUDA
    events (`profile_swin_kernels.device_ms`, `chip_smoke.py`'s
    `device_ms`): the card stays busy as long as the host keeps ahead;
  - kernel ms: the CUDA kernels' own device time under `torch.profiler`,
    a call's mean (None where the profiler records no device time);
  - host us: the host's wall time for one call, launches queued and
    nothing awaited, the mean over `--reps` calls;
beside the bound (the bytes read and written once over 3.35 TB/s: the
operations are far below the fp32 peak). Row 15 at (163840, 512), (40960,
1024) and (40960, 2048) against `F.layer_norm` (fp32 weights on the bf16
x where PyTorch takes them, else cast to bf16); row 14 at (163840, 512)
and (40960, 1024), the norm alone and with the sum. Seeded normal inputs;
scale and shift drawn away from 1 and 0. Prints the card's name and power
limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import torch
import torch.nn.functional as F

from stswincl_tpu_torch.ops.add_layernorm import add_layer_norm
from stswincl_tpu_torch.ops.layernorm import fused_layer_norm
from stswincl_tpu_torch.tools.profile_swin_kernels import (PEAK_BYTES,
                                                           device_ms)

ROW15 = ((163840, 512), (40960, 1024), (40960, 2048))
ROW14 = ((163840, 512), (40960, 1024))


def single_ms(fn, reps: int) -> float:
    """Median ms of one call between two CUDA events."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_ms(fn, reps: int):
    """Mean device ms of the CUDA kernels of one call, by `torch.profiler`;
    None where it records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us += getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0))
    return us / reps / 1e3 if us else None


def host_us(fn, reps: int) -> float:
    """Mean host wall time of one call, nothing awaited (the launch queue
    holds far more than `reps` launches)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def measure(name: str, fn, nbytes: float, reps: int) -> dict:
    row = {"call": name, "single_ms": single_ms(fn, reps),
           "device_ms": device_ms(fn, reps), "kernel_ms": kernel_ms(fn, reps),
           "host_us": host_us(fn, reps),
           "bound_ms": nbytes / PEAK_BYTES * 1e3}
    k = row["kernel_ms"]
    print(f"  {name:40s} single {row['single_ms']:.4f} ms  device "
          f"{row['device_ms']:.4f} ms  kernel "
          f"{'None' if k is None else f'{k:.4f}'} ms  host "
          f"{row['host_us']:.1f} us  bound {row['bound_ms']:.4f} ms",
          flush=True)
    return row


def main(argv=None) -> list:
    """Time every call; returns one dict a call."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_layer_norm: needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"{smi} | {args.reps} calls a timing", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, k=1.0):
        return torch.randn(shape, generator=gen, device=dev) * k

    rows = []
    for R, C in ROW15:
        x = randn(R, C).to(bf)
        scale, shift = 1.0 + randn(C, k=0.5), randn(C, k=0.5)
        try:
            F.layer_norm(x, (C,), scale, shift, 1e-5)
            lib_w = (scale, shift)
        except RuntimeError:
            lib_w = (scale.to(bf), shift.to(bf))
        nbytes = 2 * R * C * 2 + 2 * C * 4
        rows.append(measure(f"row 15 ({R}, {C})", lambda: fused_layer_norm(
            x, scale, shift), nbytes, args.reps))
        rows.append(measure(f"F.layer_norm ({R}, {C})", lambda: F.layer_norm(
            x, (C,), *lib_w, 1e-5), nbytes, args.reps))
        del x
    for R, C in ROW14:
        x, y = randn(R, C).to(bf), randn(R, C).to(bf)
        scale, shift = 1.0 + randn(C, k=0.1), randn(C, k=0.1)
        rows.append(measure(
            f"row 14 ({R}, {C}) norm only", lambda: add_layer_norm(
                x, y, scale, shift, return_sum=False), 3 * R * C * 2
            + 2 * C * 4, args.reps))
        rows.append(measure(
            f"row 14 ({R}, {C}) with the sum", lambda: add_layer_norm(
                x, y, scale, shift), 4 * R * C * 2 + 2 * C * 4, args.reps))
        del x, y
    torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
