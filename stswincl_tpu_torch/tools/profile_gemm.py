"""Device time of the Hopper GEMM of K1 and K2 at their products' shapes.

    python3 -m stswincl_tpu_torch.tools.profile_gemm [--reps 20]

`ops.gemm.linear_sm90` (`csrc/gemm_sm90.cu`) alone at the four products of
each swin stage at the serving batch (bs 2: 40960 token rows at C 512,
10240 at C 1024): K1's qkv (A gathered through the window partition, W-MSA
and SW-MSA shift; and, for reference, A read straight by 2-D TMA), K1's
proj (C scattered back to the image), K2's fc1 + GELU and fc2 + the fp32
residual, beside `torch.matmul` on the same bf16 operands (cuBLAS, no
bias, no row map: the yardstick). The residual case adds into its out
tensor on every timed call, as K2 does once. Mean ms over `--reps` back-to-back
calls after three warm-up calls (CUDA events), TFLOP/s and share of the
H100's dense bf16 peak (989 TFLOP/s), each within 1e-2 of the plain twin.
Prints the card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from stswincl_tpu_torch.ops.gemm import linear_sm90, linear_sm90_ref

PEAK_BF16 = 989e12  # FLOP/s, H100 SXM, dense
STAGES = {"stage1": (512, 64, 80, 8), "stage2": (1024, 32, 40, 4)}


def device_ms(fn, reps: int) -> float:
    """Mean ms of one call over `reps` back-to-back calls, CUDA events."""
    for _ in range(3):
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


def products(C, h, w, ws, batch=2):
    """(name, M, N, K, keyword arguments) of K1's and K2's products."""
    M, grid = 2 * batch * 2 * h * w, (2, h, w, ws)
    return [("K1 qkv, W-MSA gather", M, 3 * C, C, dict(a_map=(*grid, 0))),
            ("K1 qkv, SW-MSA gather", M, 3 * C, C,
             dict(a_map=(*grid, ws // 2))),
            ("K1 qkv, A by 2-D TMA", M, 3 * C, C, {}),
            ("K1 proj, C scattered", M, C, C, dict(c_map=(*grid, 0))),
            ("K2 fc1 + GELU", M, 4 * C, C, dict(act="erf")),
            ("K2 fc2 + residual", M, C, 4 * C, dict(epi="resid_f32"))]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_gemm: needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"{smi} | {args.reps} calls a case", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for tag, (C, h, w, ws) in STAGES.items():
        for name, M, N, K, kw in products(C, h, w, ws):
            a = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
            wt = (torch.randn((N, K), generator=gen, device=dev)
                  * K ** -0.5).to(torch.bfloat16)
            bias = torch.randn(N, generator=gen, device=dev) * 0.1
            if kw.get("epi") == "resid_f32":
                kw = dict(kw, out=torch.randn((M, N), generator=gen,
                                              device=dev))
            want = linear_sm90_ref(a, wt, bias, **kw)
            fl = 2 * M * N * K
            row = {"case": f"{tag} {name} ({M}, {N}, {K})"}
            got = linear_sm90(a, wt, bias, **dict(
                kw, out=kw["out"].clone() if "out" in kw else None))
            err = ((got.float() - want.float()).norm()
                   / want.float().norm()).item()
            if err > 1e-2:
                raise RuntimeError(f"{row['case']}: relative error {err}")
            row["rel_err"] = err
            row["ms"] = device_ms(lambda: linear_sm90(a, wt, bias, **kw),
                                  args.reps)
            row["matmul_ms"] = device_ms(lambda: torch.matmul(a, wt.t()),
                                         args.reps)
            print(f"  {row['case']:44s} " + "  ".join(
                f"{label} {row[k]:.3f} ms {fl / row[k] / 1e9:4.0f} TFLOP/s "
                f"({fl / (row[k] * 1e-3) / PEAK_BF16:.1%})"
                for label, k in (("Hopper GEMM", "ms"),
                                 ("torch.matmul", "matmul_ms"))),
                  flush=True)
            rows.append(row)
            del a, wt, want
    torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
