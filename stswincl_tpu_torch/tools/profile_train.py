"""Where a stage-1 training step's time goes on the GPU.

    python3 -m stswincl_tpu_torch.tools.profile_train [--bs 8] [--steps 4]
        [--attn-impl auto] [--whole-block]

Trains TswinPlus(num_classes=12, swin_dim=512, depths (3, 3), bf16
compute, fp32 parameters, seeded random weights) with the stage-1 step
(Adam 3e-4, OHEM 0.7) on a seeded batch of 512x640 clips, and runs
`torch.profiler` over steady-state steps. Prints the host time per step,
the device's busy and idle share of that window, the device time per
group (the port's CUDA kernels, cuDNN convolutions, the optimizer,
everything else) and per kernel name, the peak memory, the card's name,
power limit, clock and temperature; then, with CUDA events outside the
profiler, the device time of the forward (to the loss), the backward and
the optimizer step. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

from stswincl_tpu_torch.models import TswinPlus
from stswincl_tpu_torch.models.init import init_weights
from stswincl_tpu_torch.models.swin import ATTN_IMPLS
from stswincl_tpu_torch.train.optim import make_adam
from stswincl_tpu_torch.train.train_seg import make_seg_train_step

# the shared GEMM serves K1-K3 and K5-K6 alike, so kernel names cannot
# split forward from backward: the CUDA-event split below does
PORT_KERNELS = ("gemm_kernel", "gemm_sm90_kernel",
                "window_attention_mma_kernel",
                "window_attention_bwd_kernel", "wgrad_kernel",
                "ln_rows_kernel", "epi_bwd_ln", "colsum_kernel",
                "patch_merge_ln_kernel", "whole_block_kernel")


def _group(name: str) -> str:
    if any(k in name for k in PORT_KERNELS):
        return "port CUDA kernels"
    low = name.lower()
    if any(k in low for k in ("conv", "cudnn", "implicit", "fprop", "wgrad",
                              "dgrad")):
        return "cuDNN convolution (forward and backward)"
    if "multi_tensor" in low or "adam" in low:
        return "optimizer (Adam)"
    if any(k in low for k in ("gemm", "nvjet", "cublas", "sm90_xmma")):
        return "cuBLAS GEMM (linears, fp32 attention-backward products)"
    return "other (BatchNorm, elementwise, reductions, copies)"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bs", type=int, default=8)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--attn-impl", default="auto", choices=ATTN_IMPLS,
                    help="the swin blocks' attention route (TswinPlus "
                    "attn_impl)")
    ap.add_argument("--whole-block", action="store_true",
                    help="W-MSA blocks through the whole-block kernel "
                    "(TswinPlus whole_block, Pallas row 16)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    model = TswinPlus(num_classes=12, swin_dim=512, swin_depths=(3, 3),
                      dtype=torch.bfloat16, input_hw=(512, 640),
                      attn_impl=args.attn_impl, whole_block=args.whole_block)
    init_weights(model, torch.Generator().manual_seed(0))
    model.to(dev)
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.uniform(
        -1, 1, (args.bs, 4, 512, 640, 3)).astype(np.float32)).to(dev)
    blocks = rng.integers(-1, 12, (args.bs, 8, 10))
    labels = torch.from_numpy(np.repeat(np.repeat(blocks, 64, 1), 64, 2)
                              ).to(dev).long()
    step = make_seg_train_step(model, make_adam(model.parameters()))
    for _ in range(2):  # warm-up
        step(images, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(images, labels)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = defaultdict(float)
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] += e.self_device_time_total / 1e3  # ms
    busy = sum(kernels.values())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"{smi} | attn_impl {args.attn_impl} | whole_block "
          f"{args.whole_block} | bs {args.bs} | "
          f"{args.steps} train steps | after them: "
          f"SM clock, power draw, temperature {clocks}")
    print(f"host time {wall_ms / args.steps:.2f} ms/step "
          f"({args.bs * args.steps / wall_ms * 1e3:.2f} clips/s under the "
          f"profiler); device busy {busy / args.steps:.2f} ms/step, idle "
          f"share {1 - busy / wall_ms:.3f}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated")
    groups = defaultdict(float)
    for k, ms in kernels.items():
        groups[_group(k)] += ms
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {ms / args.steps:9.3f} ms/step  {ms / busy:6.1%}  {g}")
    print("top kernels by device time:")
    for k, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:30]:
        print(f"  {ms / args.steps:9.3f} ms/step  {ms / busy:6.1%}  {k[:110]}")

    # forward / backward / optimizer, CUDA events, the step's own order
    parts = defaultdict(list)
    for _ in range(args.steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        step.opt.zero_grad(set_to_none=True)
        ev[0].record()
        loss = step.loss(images, labels)
        ev[1].record()
        loss.backward()
        ev[2].record()
        step.opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        for name, a, b in zip(("forward", "backward", "optimizer"), ev,
                              ev[1:]):
            parts[name].append(a.elapsed_time(b))
    print("device time by part (median of "
          f"{args.steps} steps, CUDA events): " + ", ".join(
              f"{k} {sorted(v)[len(v) // 2]:.2f} ms" for k, v in parts.items()))


if __name__ == "__main__":
    main()
