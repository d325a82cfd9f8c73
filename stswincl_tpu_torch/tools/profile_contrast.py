"""Where a stage-2 (inter-video contrastive) pretraining step's time goes on
the GPU.

    python3 -m stswincl_tpu_torch.tools.profile_contrast [--bs 4]
        [--steps 4] [--attn-impl auto]

Trains ContrastEncoder(12, swin_dim=512, depths (3, 3), bf16 compute,
fp32 parameters, seeded random weights) with the stage-2 step
(`train/train_contrast.py`: the EMA of the key parameters, the six-view
key pass, the two query views and their class-sum loss, one backward,
LARS on `ContrastTrainConfig`'s schedule) on a seeded batch of six views
of 4 frames at 256x448, and runs `torch.profiler` over steady-state steps.
Prints the host time per step, the device's busy and idle share of that
window, the device time per group (the port's CUDA kernels, cuDNN
convolutions, the contrastive loss, LARS, the EMA, everything else) and
per kernel name, the peak memory, the card's name, power limit, clock and
temperature; then, with CUDA events outside the profiler, the device time
of the EMA, the key pass, the query forward with the loss, the backward
and the optimizer step. The host time is taken with and without the
profiler (whose per-op cost the step's many small host ops feel). Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

from stswincl_tpu_torch.configs import ContrastTrainConfig
from stswincl_tpu_torch.models import ContrastEncoder
from stswincl_tpu_torch.models.init import init_weights
from stswincl_tpu_torch.models.swin import ATTN_IMPLS
from stswincl_tpu_torch.tools.profile_train import _group
from stswincl_tpu_torch.train import train_contrast as tc
from stswincl_tpu_torch.train.optim import (LARS, make_lars, scale_lr_linear,
                                            warmup_cosine_schedule)

# device time of the kernels launched inside these ranges (record_function)
RANGES = {"contrast_loss": "the contrastive loss (fp32 bmm, elementwise)",
          "lars_step": "LARS",
          "ema_update": "the EMA of the key parameters"}


def _annotated(name, fn):
    def wrapped(*args, **kw):
        with torch.profiler.record_function(name):
            return fn(*args, **kw)
    return wrapped


def seeded_batch(bs: int, hw, seed: int = 1):
    """Six views of 4 frames (bs, 6, 4, H, W, 3) and blocky labels
    (bs, 6, H, W): one class in [0, 12) per 32x32 block, a colour per
    class under noise."""
    rng = np.random.default_rng(seed)
    h, w = hw
    blocks = rng.integers(0, 12, (bs, 6, h // 32, w // 32))
    labels = np.repeat(np.repeat(blocks, 32, axis=2), 32, axis=3)
    palette = rng.uniform(-1.0, 1.0, (12, 3)).astype(np.float32)
    noise = rng.standard_normal((bs, 6, 4, h, w, 3)).astype(np.float32)
    return palette[labels][:, :, None] + 0.3 * noise, labels


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bs", type=int, default=4)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--attn-impl", default="auto", choices=ATTN_IMPLS,
                    help="the swin blocks' attention route")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_contrast: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = ContrastTrainConfig()
    hw = tuple(cfg.data.crop_hw)
    model = ContrastEncoder(12, swin_dim=512, swin_depths=(3, 3),
                            dtype=torch.bfloat16, input_hw=hw,
                            attn_impl=args.attn_impl)
    init_weights(model, torch.Generator().manual_seed(0))
    model.to(dev)
    total = cfg.num_epochs * 100
    schedule = warmup_cosine_schedule(
        scale_lr_linear(cfg.base_lr, args.bs), cfg.warmup_epochs * 100,
        total, warmup_multiplier=cfg.warmup_multiplier)
    state = tc.ContrastTrainState.create(model, lambda p: make_lars(
        p, schedule, weight_decay=cfg.weight_decay,
        trust_coefficient=cfg.lars_trust_coef))
    step = tc.make_contrast_train_step(state, 12, total, cfg.momentum)
    clips, labels = seeded_batch(args.bs, hw)
    clips = torch.from_numpy(clips).to(dev)
    labels = torch.from_numpy(labels).to(dev).long()
    for _ in range(2):  # warm-up
        step(clips, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        step(clips, labels)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    patches = [(tc, "class_sum_contrastive_loss", "contrast_loss"),
               (LARS, "step", "lars_step"), (tc, "ema_update", "ema_update")]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    for obj, attr, name in patches:
        setattr(obj, attr, _annotated(name, getattr(obj, attr)))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                step(clips, labels)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
    # a range (ours, or the optimizer's own "Optimizer.step#...") also
    # shows on the device as an annotation spanning its kernels: only
    # device events whose name no host event carries are kernels
    averages = prof.key_averages()
    host = {e.key for e in averages
            if e.device_type == torch.autograd.DeviceType.CPU}
    kernels = defaultdict(float)
    for e in averages:
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.key not in host):
            kernels[e.key] += e.self_device_time_total / 1e3  # ms
    ranges = defaultdict(float)
    for e in prof.events():
        if (e.name in RANGES
                and e.device_type == torch.autograd.DeviceType.CPU):
            ranges[e.name] += e.device_time_total / 1e3
    busy = sum(kernels.values())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    n = args.steps
    print(f"{smi} | attn_impl {args.attn_impl} | bs {args.bs}, six views of "
          f"4 frames at {hw[0]}x{hw[1]} | {n} contrast steps | after them: "
          f"SM clock, power draw, temperature {clocks}")
    print(f"host time {plain_ms:.2f} ms/step without the profiler "
          f"({args.bs / plain_ms * 1e3:.2f} samples/s), {wall_ms / n:.2f} "
          f"under it; device busy {busy / n:.2f} ms/step, idle share "
          f"{1 - busy / wall_ms:.3f} of the profiled window, "
          f"{1 - busy / n / plain_ms:.3f} of the unprofiled step; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated")
    groups = defaultdict(float)
    for k, ms in kernels.items():
        groups[_group(k)] += ms
    # the ranges' kernels are cuBLAS products and elementwise work: taken
    # out of those groups and shown on their own
    rest = ("cuBLAS GEMM (linears, fp32 attention-backward products)",
            "other (BatchNorm, elementwise, reductions, copies)")
    for name, label in RANGES.items():
        ms = ranges.get(name, 0.0)
        groups[label] = ms
        take = min(ms, groups[rest[1]])
        groups[rest[1]] -= take
        groups[rest[0]] -= ms - take
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {ms / n:9.3f} ms/step  {ms / busy:6.1%}  {g}")
    if not ranges:
        print("  (the profiler gave no device time under the ranges: the "
              "loss, LARS and EMA groups are not measured)")
    print("top kernels by device time:")
    for k, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:30]:
        print(f"  {ms / n:9.3f} ms/step  {ms / busy:6.1%}  {k[:110]}")

    # the step's parts in its own order, CUDA events
    parts = defaultdict(list)
    for _ in range(n):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        m = tc.contrast_momentum(state.step, total, cfg.momentum)
        ev[0].record()
        tc.ema_update(state.key, state.query, m)
        ev[1].record()
        keys = tc.key_pass(state.key, clips)
        ev[2].record()
        state.opt.zero_grad(set_to_none=True)
        loss, _ = step.loss(clips, labels, keys)
        ev[3].record()
        loss.backward()
        ev[4].record()
        state.opt.step()
        ev[5].record()
        state.step += 1
        torch.cuda.synchronize()
        for name, a, b in zip(("EMA", "key pass (6 views)",
                               "query forward + loss (2 views)", "backward",
                               "optimizer (LARS)"), ev, ev[1:]):
            parts[name].append(a.elapsed_time(b))
    print(f"device time by part (median of {n} steps, CUDA events): "
          + ", ".join(f"{k} {sorted(v)[len(v) // 2]:.2f} ms"
                      for k, v in parts.items()))


if __name__ == "__main__":
    main()
