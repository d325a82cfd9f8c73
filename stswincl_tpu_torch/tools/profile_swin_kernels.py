"""Device time of the swin block's kernels at the batch-8 block shapes.

    python3 -m stswincl_tpu_torch.tools.profile_swin_kernels [--reps 20]

Counterpart of `tools/profile_swin_kernels.py`. At stage 1, the blocks
of a batch of 8 clips see (16, 2, 64, 80, 512): 163840 token rows, C 512;
at stage 2 (16, 2, 32, 40, 1024): 40960 rows, C 1024; hidden 4C, 4 heads.
Times K1 (`swin_block_attention`), Pallas row 13 (`add_ln_mlp`) and row
14 (`add_layer_norm` without the sum) with CUDA events around `--reps`
launches after two warm-up launches, on seeded inputs drawn as the JAX
tool draws them (uniform [0, 1), weights times 0.02). Prints each time
with its share of the H100's dense bf16 peak (989 TFLOP/s) or, for row
14, of its memory rate (3.35 TB/s), and the card's name and power limit.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from stswincl_tpu_torch.ops.add_layernorm import add_layer_norm
from stswincl_tpu_torch.ops.add_ln_mlp import add_ln_mlp
from stswincl_tpu_torch.ops.block_attention import swin_block_attention

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


def stage(tag, Bw, T, H, W, C, heads, ws, reps, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def rand(*shape, k=1.0, dtype=bf):
        return (torch.rand(shape, generator=gen, device=dev) * k).to(dtype)

    rows, TN = Bw * T * H * W, T * ws * ws
    zeros = lambda *s: torch.zeros(s, device=dev)  # noqa: E731
    x = rand(Bw, T, H, W, C)
    xt, yt = rand(rows, C), rand(rows, C)
    attn_args = (x, rand(3 * C, C, k=0.02), zeros(3 * C), rand(C, C, k=0.02),
                 zeros(C), zeros(heads, TN, TN), None, heads,
                 (C // heads) ** -0.5, ws)
    mlp_w = (rand(4 * C, C, k=0.02), zeros(4 * C), rand(C, 4 * C, k=0.02),
             zeros(C))
    scale, bias = torch.ones(C, device=dev), zeros(C)
    outs = {"attention": swin_block_attention(*attn_args),
            "add_ln_mlp": add_ln_mlp(xt, yt, scale, bias, *mlp_w),
            "add_layer_norm": add_layer_norm(xt, yt, scale, bias,
                                             return_sum=False)}
    for name, out in outs.items():
        for t in (out if isinstance(out, tuple) else (out,)):
            if t is not None and not torch.isfinite(t).all():
                raise RuntimeError(f"{tag} {name}: non-finite output")
    del outs
    t_attn = device_ms(lambda: swin_block_attention(*attn_args), reps)
    t_alm = device_ms(lambda: add_ln_mlp(xt, yt, scale, bias, *mlp_w), reps)
    t_ln = device_ms(lambda: add_layer_norm(xt, yt, scale, bias,
                                            return_sum=False), reps)
    attn_flops = 2 * rows * (C * 4 * C) + 2 * rows * TN * C * 2
    mlp_flops = 2 * rows * C * 4 * C * 2
    ln_bytes = 3 * rows * C * 2  # x, y read; the norm written
    print(f"{tag} ({rows} tokens, C={C}):", flush=True)
    print(f"  attention kernel (K1): {t_attn:7.3f} ms "
          f"({attn_flops / (t_attn * 1e-3) / PEAK_BF16:6.1%} of bf16 peak)",
          flush=True)
    print(f"  add+LN+MLP (row 13):   {t_alm:7.3f} ms "
          f"({mlp_flops / (t_alm * 1e-3) / PEAK_BF16:6.1%} of bf16 peak)",
          flush=True)
    print(f"  final add+LN (row 14): {t_ln:7.3f} ms "
          f"({ln_bytes / (t_ln * 1e-3) / PEAK_BYTES:6.1%} of the memory "
          "rate)", flush=True)


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
