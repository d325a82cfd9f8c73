"""Device time of the swin block's kernels at the batch-8 block shapes.

    python3 -m stswincl_tpu_torch.tools.profile_swin_kernels [--reps 20]

Counterpart of `tools/profile_swin_kernels.py`. At stage 1, the blocks
of a batch of 8 clips see (16, 2, 64, 80, 512): 163840 token rows, C 512;
at stage 2 (16, 2, 32, 40, 1024): 40960 rows, C 1024; hidden 4C, 4 heads.
Times K1 (`swin_block_attention`), K2 (`swin_block_epilogue`), the
attention step alone (row 10, `windowed_attention_image`, the core K1 runs
between its two products), Pallas row 13 (`add_ln_mlp`) and row 14
(`add_layer_norm` without the sum) with CUDA events around `--reps`
launches after two warm-up launches, on seeded inputs drawn as the JAX
tool draws them (uniform [0, 1), weights times 0.02). Prints each time
beside its bound, the least time the card could take for the same work
(the larger of the operations over the H100's dense bf16 peak, 989
TFLOP/s, and the bytes read and written once over its memory rate, 3.35
TB/s), the kernel's share of that bound, and the card's name and power
limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from stswincl_tpu_torch.ops.add_layernorm import add_layer_norm
from stswincl_tpu_torch.ops.add_ln_mlp import add_ln_mlp, swin_block_epilogue
from stswincl_tpu_torch.ops.block_attention import (swin_block_attention,
                                                    windowed_attention_image)

PEAK_BF16 = 989e12  # FLOP/s, H100 SXM, dense
PEAK_BYTES = 3.35e12  # bytes/s, H100 SXM HBM3
STAGES = {  # tag: (Bw, T, H, W, C, heads, ws)
    "stage1": (16, 2, 64, 80, 512, 4, 8),
    "stage2": (16, 2, 32, 40, 1024, 4, 4),
}


def device_ms(fn, reps: int) -> float:
    """Mean ms of one call over `reps` back-to-back calls, CUDA events."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def report(name: str, ms: float, flops: float, nbytes: float) -> None:
    """One kernel's time beside its bound and its share of it."""
    ops_ms, bytes_ms = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    print(f"  {name:26s} {ms:7.3f} ms, bound {bound_ms:6.3f} ms ({by}): "
          f"{bound_ms / ms:6.1%} of the bound", flush=True)


def stage(tag, Bw, T, H, W, C, heads, ws, reps, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def rand(*shape, k=1.0, dtype=bf):
        return (torch.rand(shape, generator=gen, device=dev) * k).to(dtype)

    rows, TN, hidden = Bw * T * H * W, T * ws * ws, 4 * C
    zeros = lambda *s: torch.zeros(s, device=dev)  # noqa: E731
    x = rand(Bw, T, H, W, C)
    xt, yt = rand(rows, C), rand(rows, C)
    qkv = rand(Bw, T, H, W, 3 * C)
    bias_t = zeros(heads, TN, TN)
    attn_args = (x, rand(3 * C, C, k=0.02), zeros(3 * C), rand(C, C, k=0.02),
                 zeros(C), bias_t, None, heads, (C // heads) ** -0.5, ws)
    mlp_w = (rand(hidden, C, k=0.02), zeros(hidden), rand(C, hidden, k=0.02),
             zeros(C))
    scale, bias = torch.ones(C, device=dev), zeros(C)
    epi_args = (x, rand(Bw, T, H, W, C), scale, bias, *mlp_w, scale, bias)
    calls = {
        "K1 attention sub-block": lambda: swin_block_attention(*attn_args),
        "K2 epilogue": lambda: swin_block_epilogue(*epi_args),
        "attention step (row 10)": lambda: windowed_attention_image(
            qkv, bias_t, None, heads, (C // heads) ** -0.5, ws),
        "add+LN+MLP (row 13)": lambda: add_ln_mlp(xt, yt, scale, bias,
                                                  *mlp_w),
        "final add+LN (row 14)": lambda: add_layer_norm(
            xt, yt, scale, bias, return_sum=False)}
    for name, fn in calls.items():
        out = fn()
        for t in (out if isinstance(out, tuple) else (out,)):
            if t is not None and not torch.isfinite(t).all():
                raise RuntimeError(f"{tag} {name}: non-finite output")
    attn_step = (4 * rows * TN * C, 4 * rows * C * 2 + heads * TN * TN * 4)
    work = {  # (flops, bytes): inputs read once, outputs written once
        "K1 attention sub-block": (
            8 * rows * C * C + attn_step[0],
            2 * rows * C * 2 + 4 * C * C * 2 + 4 * C * 4
            + heads * TN * TN * 4),
        "K2 epilogue": (4 * rows * C * hidden,
                        3 * rows * C * 2 + 2 * C * hidden * 2
                        + (hidden + 5 * C) * 4),
        "attention step (row 10)": attn_step,
        "add+LN+MLP (row 13)": (4 * rows * C * hidden,
                                4 * rows * C * 2 + 2 * C * hidden * 2),
        "final add+LN (row 14)": (10 * rows * C, 3 * rows * C * 2)}
    print(f"{tag} ({rows} tokens, C={C}):", flush=True)
    for name, fn in calls.items():
        report(name, device_ms(fn, reps), *work[name])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_swin_kernels: needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"{smi} | {args.reps} launches a kernel", flush=True)
    for tag, shape in STAGES.items():
        stage(tag, *shape, args.reps, dev)
    torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
