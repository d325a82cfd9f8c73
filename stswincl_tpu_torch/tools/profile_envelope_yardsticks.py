"""Yardsticks beside the fp32 forms at the widened envelope, timed on the
GPU: cuBLAS fp32 on the products of K1, K2, K5 and K6 at the narrow
widths, and the bf16 forms at the windows past the fp32 resident
instances.

    python3 -m stswincl_tpu_torch.tools.profile_envelope_yardsticks \
        [--out f.json]

(a) At C 32, 64, 96 and 192 (4 heads) on the serving shapes (4, 2, 64,
80, C) ws 8 and (4, 2, 32, 40, C) ws 4 (`chip_smoke.py` phase 2i's):
cuBLAS fp32 (`torch.matmul`, TF32 off) on each form's products, summed
in one call: K1 the qkv and proj products; K2 fc1 and fc2; K5 dattn, dx,
dwqkv and dwproj; K6 row 7 fc1, m, dh, dn2, dw1 and dw2, row 9 the same
without m. (b) At phase 2k's windows (`chip_smoke.F32_STREAMED`): the
bf16 forms on the same shapes, K1 (W-MSA and SW-MSA), rows 10 and 11
(masked), K5's attention backward alone (`attn_bwd`, masked) and K5
(SW-MSA). Each the CUDA-event median of 5 single calls after two
warm-ups. Prints the card's name and power limit first, and writes
{"results": {name: [{"case", "ms"}]}} to --out. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import torch


def _median_ms(fn, reps=5):
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


def cublas_products(dev, results) -> None:
    """(a): the fp32 forms' products on cuBLAS fp32 at the narrow widths."""
    gen = torch.Generator(device=dev).manual_seed(24)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    for C in (32, 64, 96, 192):
        for lead in ((4, 2, 64, 80), (4, 2, 32, 40)):
            R, hidden = lead[0] * lead[1] * lead[2] * lead[3], 4 * C
            x, g, y = randn(R, C), randn(R, C), randn(R, C)
            qkv, h = randn(R, 3 * C), randn(R, hidden)
            wq, wp = randn(3 * C, C), randn(C, C)
            w1, w2 = randn(hidden, C), randn(C, hidden)
            case = f"{(*lead, C)}"

            def k1():
                return x @ wq.t(), y @ wp.t()

            def k2():
                return x @ w1.t(), h @ w2.t()

            def k5():
                return g @ wp, qkv @ wq, qkv.t() @ x, g.t() @ y

            def k6(m=True):
                hh = x @ w1.t()
                out = [hh @ w2.t()] if m else []
                d = g @ w2
                return out + [d @ w1, d.t() @ x, g.t() @ hh]
            for name, fn in (("swin_block_attention_f32", k1),
                             ("swin_block_epilogue_f32", k2),
                             ("swin_block_attention_bwd_f32", k5),
                             ("swin_block_epilogue_bwd_f32 row 7", k6),
                             ("swin_block_epilogue_bwd_f32 row 9",
                              lambda: k6(False))):
                row = {"case": case, "ms": _median_ms(fn)}
                results.setdefault(f"cuBLAS fp32 {name}", []).append(row)
                print(f"  cuBLAS fp32 products of {name:34s} {case:22s} "
                      f"{row['ms']:.4f} ms", flush=True)


# phase 2k's windows (`chip_smoke.F32_STREAMED`): label -> (x's shape,
# heads, ws)
F32_STREAMED = {
    "TN128 hd152": ((4, 2, 64, 80, 608), 4, 8),
    "TN128 hd192": ((4, 2, 64, 80, 768), 4, 8),
    "TN128 hd256": ((4, 2, 64, 80, 512), 2, 8),
    "TN128 hd288": ((2, 2, 64, 80, 1152), 4, 8),
    "TN144 hd64": ((4, 4, 48, 60, 256), 4, 6),
    "TN176 hd208": ((1, 11, 32, 40, 1664), 8, 4),
    "TN32 hd384": ((4, 2, 32, 40, 1536), 4, 4),
    "TN32 hd512": ((4, 2, 32, 40, 1024), 2, 4),
    "TN32 hd576": ((2, 2, 32, 40, 2304), 4, 4),
    "TN32 hd1200": ((2, 2, 32, 40, 2400), 2, 4),
}


def bf16_forms(dev, results) -> None:
    """(b): the bf16 forms at phase 2k's windows."""
    from stswincl_tpu_torch.ops import attention as attn_ops
    from stswincl_tpu_torch.ops import block_attention as att
    from stswincl_tpu_torch.ops.gemm import window_rows
    from stswincl_tpu_torch.ops.window import (partition_qkv,
                                               shifted_window_attention_mask)

    gen = torch.Generator(device=dev).manual_seed(25)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def uniform(*shape, fan_in, gain=1.0, dtype=bf16):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1)
                * gain * fan_in ** -0.5).to(dtype)

    for label, (shape, heads, ws) in F32_STREAMED.items():
        B, T, h, w, C = shape
        TN, hd = T * ws * ws, C // heads
        R, shift, scale = B * T * h * w, ws // 2, hd ** -0.5
        x, g = randn(*shape), randn(*shape)
        wq = uniform(3 * C, C, fan_in=C, gain=3.0)
        bq = uniform(3 * C, fan_in=C, dtype=torch.float32)
        wp = uniform(C, C, fan_in=C, gain=2.0)
        bp = uniform(C, fan_in=C, dtype=torch.float32)
        bias = randn(heads, TN, TN, dtype=torch.float32)
        mask = torch.from_numpy(shifted_window_attention_mask(
            h, w, ws, shift)).repeat(1, T, T).to(dev)
        qkv_img = randn(B, T, h, w, 3 * C, scale=2.0)
        q, k, v = partition_qkv(qkv_img, heads, ws).contiguous()
        with torch.no_grad():
            _, qkv, attn = att._forward_kernel(x, wq, bq, wp, bp, bias, mask,
                                               heads, scale, ws, shift)
            dattn = (g.reshape(R, C)[window_rows(R, (T, h, w, ws, 0), dev)]
                     .float() @ wp.float()).to(bf16)
        fns = (
            ("swin_block_attention shift=0", lambda: att.swin_block_attention(
                x, wq, bq, wp, bp, bias, None, heads, scale, ws, 0)),
            (f"swin_block_attention shift={shift}",
             lambda: att.swin_block_attention(x, wq, bq, wp, bp, bias, mask,
                                              heads, scale, ws, shift)),
            ("windowed_attention_image masked",
             lambda: att.windowed_attention_image(qkv_img, bias, mask, heads,
                                                  scale, ws)),
            ("fused_window_attention masked",
             lambda: attn_ops.fused_window_attention(q, k, v, bias, mask,
                                                     scale)),
            ("attn_bwd masked", lambda: att.attn_bwd(
                qkv, dattn, attn, bias, mask, heads, scale, TN)),
            (f"swin_block_attention_bwd shift={shift}",
             lambda: att.swin_block_attention_bwd(
                 x, g, qkv, attn, wq, wp, bias, mask, heads, scale, ws,
                 shift)))
        for name, fn in fns:
            row = {"case": f"{label} {shape}", "ms": _median_ms(fn)}
            results.setdefault(name, []).append(row)
            print(f"  bf16 {name:36s} {label:12s} {shape} {row['ms']:.3f} ms",
                  flush=True)
        del x, g, qkv, attn, dattn, qkv_img, q, k, v
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_envelope_yardsticks: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    results = {}
    cublas_products(dev, results)
    bf16_forms(dev, results)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
