"""Where K5 fp32's attention backward spends its time: the device time of
each of its kernels (the query pass, the dbias partials' fixed-order sum,
the key pass), by name, at the shapes phase 7 (a) runs it.

    python3 -m stswincl_tpu_torch.tools.profile_attn_bwd [--calls 5]

`ops.block_attention.attn_bwd_f32` on seeded fp32 qkv (std 2), dattn, a
relative bias and a mask of a third of -100 entries, at stage 1's window
(TN 128 x hd 128, (16, 2, 64, 80, 512)), stage 2's (TN 32 x hd 256, (16,
2, 32, 40, 1024)) and `swin_dim` 128's (hd 32, both windows): after three
warm-up calls, `torch.profiler` over `--calls` calls, each kernel's device
time a call. Prints the card's name and power limit first. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from stswincl_tpu_torch import kernels
from stswincl_tpu_torch.ops import block_attention as att

# (label, batch, C, H, W, ws) at 4 heads and 2 frames, as phase 7 (a)
CASES = (("stage 1", 16, 512, 64, 80, 8), ("stage 2", 16, 1024, 32, 40, 4),
         ("hd 32, TN 128", 16, 128, 64, 80, 8),
         ("hd 32, TN 32", 16, 128, 32, 40, 4))


def main(argv=None) -> None:
    from torch.profiler import ProfilerActivity, profile
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_attn_bwd: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    kernels.load()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    heads, T = 4, 2
    for label, n, C, h, w, ws in CASES:
        TN, R = T * ws * ws, n * T * h * w
        qkv = torch.randn(R, 3 * C, generator=gen, device=dev) * 2
        dattn = torch.randn(R, C, generator=gen, device=dev)
        bias = torch.randn(heads, TN, TN, generator=gen, device=dev)
        n_win = (h // ws) * (w // ws)
        mask = torch.where(torch.rand(n_win, TN, TN, generator=gen,
                                      device=dev) < 1 / 3, -100.0, 0.0)
        call = (qkv, dattn, bias, mask, heads, (C // heads) ** -0.5, TN)
        for _ in range(3):
            att.attn_bwd_f32(*call)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.calls):
                att.attn_bwd_f32(*call)
            torch.cuda.synchronize()
        print(f"{label}: TN {TN}, hd {C // heads}, {R} rows", flush=True)
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0))
            if t > 0:
                print(f"  {t / args.calls / 1e3:.3f} ms a call "
                      f"({e.count // args.calls} a call) {e.key[:90]}",
                      flush=True)
        del qkv, dattn, bias, mask, call
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
