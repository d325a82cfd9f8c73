"""Where a serving step's time goes on the GPU.

    python3 -m stswincl_tpu_torch.tools.profile_serving [--bs 2] [--steps 6]
        [--attn-impl auto] [--whole-block]

Serves TswinPlus(num_classes=12, swin_dim=512, depths (3, 3), bf16, seeded
random weights) through StreamingSegmenter at 512x640 -> 1024x1280 and
runs `torch.profiler` over steady-state `predict_next` steps. Prints the
host time per step, the device's busy and idle share of that window, the
device time per kernel name and per group (the port's CUDA kernels, cuDNN
convolutions, everything else), and the card's name and power limit.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from collections import defaultdict

import torch

from stswincl_tpu_torch.models import TswinPlus
from stswincl_tpu_torch.models.init import init_weights
from stswincl_tpu_torch.models.swin import ATTN_IMPLS
from stswincl_tpu_torch.pipelines.streaming import StreamingSegmenter

PORT_KERNELS = ("gemm_kernel", "gemm_sm90_kernel",
                "window_attention_mma_kernel", "ln_rows_kernel",
                "patch_merge_ln_kernel", "upsample_argmax_kernel",
                "whole_block_kernel")


def _group(name: str) -> str:
    if any(k in name for k in PORT_KERNELS):
        return "port CUDA kernels"
    low = name.lower()
    if any(k in low for k in ("conv", "cudnn", "implicit", "fprop")):
        return "cuDNN convolution"
    if any(k in low for k in ("gemm", "nvjet", "cublas", "sm90_xmma")):
        return "cuBLAS GEMM (the linears of the non-K1 routes)"
    return "other (elementwise, copies, reductions)"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bs", type=int, default=2)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--attn-impl", default="auto", choices=ATTN_IMPLS,
                    help="the swin blocks' attention route (TswinPlus "
                    "attn_impl)")
    ap.add_argument("--whole-block", action="store_true",
                    help="W-MSA blocks through the whole-block kernel "
                    "(TswinPlus whole_block, Pallas row 16)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    model = TswinPlus(num_classes=12, swin_dim=512, swin_depths=(3, 3),
                      dtype=torch.bfloat16, input_hw=(512, 640),
                      attn_impl=args.attn_impl, whole_block=args.whole_block)
    init_weights(model, torch.Generator().manual_seed(0))
    model.to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(1)
    frames = torch.rand((args.bs, 6 + args.steps, 512, 640, 3),
                        generator=gen, device=dev) * 2 - 1
    seg = StreamingSegmenter(model, out_hw=(1024, 1280))
    cache, _ = seg.init_and_predict(frames[:, 0:4])
    for i in (4, 5):  # warm-up
        cache, _ = seg.predict_next(cache, frames[:, i])
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(6, 6 + args.steps):
            cache, _ = seg.predict_next(cache, frames[:, i])
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
    print(f"{smi} | attn_impl {args.attn_impl} | whole_block "
          f"{args.whole_block} | bs {args.bs} | "
          f"{args.steps} predict_next steps")
    print(f"host time {wall_ms / args.steps:.2f} ms/step "
          f"({args.bs * args.steps / wall_ms * 1e3:.2f} frames/s under the "
          f"profiler); device busy {busy / args.steps:.2f} ms/step, idle "
          f"share {1 - busy / wall_ms:.3f}")
    groups = defaultdict(float)
    for k, ms in kernels.items():
        groups[_group(k)] += ms
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {ms / args.steps:9.3f} ms/step  {ms / busy:6.1%}  {g}")
    print("top kernels by device time:")
    for k, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:25]:
        print(f"  {ms / args.steps:9.3f} ms/step  {ms / busy:6.1%}  {k[:110]}")


if __name__ == "__main__":
    main()
