"""Where K6 fp32 (Pallas rows 7 and 9, `stswin_block_epilogue_bwd_f32`)
spends its time: the device time of each of its kernels, by name, at the
training shapes phase 7 (a) runs it.

    python3 -m stswincl_tpu_torch.tools.profile_k6_f32 [--calls 5]

`ops.add_ln_mlp.swin_block_epilogue_bwd_f32` on seeded fp32 x, y, g and
the weights phase 7 (a) draws, at row 7's shape (16, 2, 64, 80, 512),
hidden 2048, m recomputed, and row 9's (16, 2, 32, 40, 1024), hidden
4096, with row 8's saved m (`swin_block_epilogue_f32(m_out=True)`), each
with shift 0 and with the SW-MSA shift (ws / 2): after two warm-up calls,
`torch.profiler` over `--calls` calls, each kernel's device time and
launches a call, and their sum. Prints the card's name and power limit
first. Needs a CUDA card. Run as `PYTHONPATH=<other checkout> python3
<this file>` it profiles another checkout's K6 (a before / after split).
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from stswincl_tpu_torch import kernels
from stswincl_tpu_torch.ops import add_ln_mlp as epi

# (row, batch, C, H, W, ws) at 2 frames, as phase 7 (a)
CASES = (("row 7", 16, 512, 64, 80, 8), ("row 9", 16, 1024, 32, 40, 4))


def _inputs(gen, dev, n, C, h, w):
    """x, y, g and K6's seven parameters (s2, b2, w1, b1, w2, bw2, s1),
    drawn as phase 7 (a) draws them, with b1n for the forward."""
    hidden = 4 * C

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def uniform(*shape, fan_in, gain=1.0):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1)
                * gain * fan_in ** -0.5)

    x, y, g = (randn(n, 2, h, w, C) for _ in range(3))
    p = [1.0 + randn(C, scale=0.1), randn(C, scale=0.1),
         uniform(hidden, C, fan_in=C, gain=2.0), uniform(hidden, fan_in=C),
         uniform(C, hidden, fan_in=hidden, gain=2.0),
         uniform(C, fan_in=hidden), 1.0 + randn(C, scale=0.1),
         randn(C, scale=0.1)]
    return x, y, g, p


def main(argv=None) -> None:
    from torch.profiler import ProfilerActivity, profile
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_k6_f32: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    kernels.load()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for row, n, C, h, w, ws in CASES:
        x, y, g, p = _inputs(gen, dev, n, C, h, w)
        for shift in (0, ws // 2):
            kw = dict(gelu_exact=True, shift=shift, ws=ws)
            m = None
            if epi.mlp_output_saved(C, 4 * C, torch.float32):
                with torch.no_grad():
                    m = epi.swin_block_epilogue_f32(x, y, *p, **kw,
                                                    m_out=True)[1]

            def call():
                return epi.swin_block_epilogue_bwd_f32(x, y, g, m, *p[:7],
                                                       **kw)
            for _ in range(2):
                call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(args.calls):
                    call()
                torch.cuda.synchronize()
            print(f"{row}: {tuple(x.shape)}, hidden {4 * C}, shift {shift}, "
                  f"m {'saved' if m is not None else 'recomputed'}",
                  flush=True)
            total = 0.0
            for e in sorted(prof.key_averages(), key=lambda e: -getattr(
                    e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))):
                t = getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
                if t > 0:
                    total += t / args.calls / 1e3
                    print(f"  {t / args.calls / 1e3:8.3f} ms a call "
                          f"({e.count / args.calls:g} a call) "
                          f"{e.key[:110]}", flush=True)
            print(f"  {total:8.3f} ms a call in all", flush=True)
            del m
            torch.cuda.empty_cache()
        del x, y, g, p
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
