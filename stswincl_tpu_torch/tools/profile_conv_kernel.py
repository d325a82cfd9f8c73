"""Device time of the fused conv kernel (Pallas row 17) against cuDNN at
the ResNet dilated-stage shapes.

    python3 -m stswincl_tpu_torch.tools.profile_conv_kernel [--reps 20]

Counterpart of `tools/profile_conv_kernel.py`: its six shapes at N 4 and
32 (layer5 512 -> 512 and 256 -> 512 at dilation 4 and layer4 256 -> 256
and 128 -> 256 at dilation 2, on 64x80; layer1 64 -> 64 on 128x160 and
layer2 128 -> 128 on 64x80 at dilation 1), each with the residual and
the ReLU, on seeded inputs drawn as the JAX tool draws them (normal x and
residual, normal weights times 0.02, scale 1, shift 0). For each shape it
times row 17 (`ops/conv.conv3x3_bn_act`) and cuDNN in its place:
`F.conv2d` in bf16, channels_last, the scale folded into the weight and
the shift as its bias, then the residual add and the ReLU. Each time is
the mean over `--reps` calls between CUDA events after two warm-up calls
(`profile_swin_kernels.device_ms`), printed with its share of the H100's
dense bf16 peak (989 TFLOP/s). One call before the timing holds the
kernel against the cuDNN form (both bf16; relative difference at most
TOL_REL). A shape outside `ops.conv.supports` prints "out of envelope".
With `--gemm`, each shape also times the same product as a plain GEMM on
an im2col'd A (M = N*H*W rows of K = 9*Cin64, seeded): the Hopper GEMM
(`ops.gemm.linear_sm90`, A by 2-D TMA) and `torch.matmul`, which tells
what the implicit gather costs the conv from what the GEMM costs. Prints
the card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess

import torch
import torch.nn.functional as F

from stswincl_tpu_torch.ops.conv import K_TILE, conv3x3_bn_act, supports
from stswincl_tpu_torch.ops.gemm import linear_sm90
from stswincl_tpu_torch.tools.profile_swin_kernels import PEAK_BF16, device_ms

TOL_REL = 1e-2  # ||kernel - cuDNN|| / ||cuDNN||, both bf16 with fp32 sums
UNTIMED_CALLS = 3  # of the kernel a shape: the check and two warm-ups
SHAPES = (  # name, H, W, Cin, Cout, dilation (with the residual, ReLU)
    ("layer5 512->512 d4", 64, 80, 512, 512, 4),
    ("layer5 256->512 d4", 64, 80, 256, 512, 4),
    ("layer4 256->256 d2", 64, 80, 256, 256, 2),
    ("layer4 128->256 d2", 64, 80, 128, 256, 2),
    ("layer1  64->64  d1", 128, 160, 64, 64, 1),
    ("layer2 128->128 d1", 64, 80, 128, 128, 1),
)
BATCHES = (4, 32)


def cudnn_conv_bn_act(x, w, scale, shift, dilation, relu=True,
                      residual=None):
    """The same function as `conv3x3_bn_act` on cuDNN: one bf16
    channels_last conv with the scale folded into the weight and the shift
    as its bias, then the residual add and the ReLU. NHWC in and out."""
    wf = (w.float() * scale[:, None, None, None]).to(
        x.dtype, memory_format=torch.channels_last)
    y = F.conv2d(x.permute(0, 3, 1, 2), wf, shift.to(x.dtype),
                 padding=dilation, dilation=dilation).permute(0, 2, 3, 1)
    if residual is not None:
        y = y + residual
    return y.relu() if relu else y


def bench_gemm(M, K, cout, reps, dev, gen) -> str:
    """The conv's product as a plain GEMM on an (M, K) A: the Hopper GEMM
    and torch.matmul, ms and share of the bf16 peak."""
    a = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    wt = (torch.randn((cout, K), generator=gen, device=dev)
          * 0.02).to(torch.bfloat16)
    flops = 2 * M * K * cout
    g = device_ms(lambda: linear_sm90(a, wt), reps)
    m = device_ms(lambda: torch.matmul(a, wt.t()), reps)
    return (f" | as a GEMM: Hopper {g:7.3f} ms "
            f"({flops / (g * 1e-3) / PEAK_BF16:6.1%}), torch.matmul "
            f"{m:7.3f} ms ({flops / (m * 1e-3) / PEAK_BF16:6.1%})")


def bench_shape(name, N, H, W, cin, cout, d, reps, dev, gemm=False) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    x = torch.randn((N, H, W, cin), generator=gen, device=dev).to(bf)
    w = (torch.randn((cout, cin, 3, 3), generator=gen, device=dev)
         * 0.02).to(bf)
    scale = torch.ones(cout, device=dev)
    shift = torch.zeros(cout, device=dev)
    res = torch.randn((N, H, W, cout), generator=gen, device=dev).to(bf)
    flops = 2 * N * H * W * cin * cout * 9
    row = {"shape": f"{name} N{N}", "flops": flops,
           "in_envelope": supports(tuple(x.shape), tuple(w.shape), d, 1)}

    def cudnn():
        return cudnn_conv_bn_act(x, w, scale, shift, d, residual=res)

    def kernel():
        return conv3x3_bn_act(x, w, scale, shift, dilation=d, residual=res)

    if row["in_envelope"]:
        got, want = kernel().float(), cudnn().float()
        rel = ((got - want).norm() / want.norm()).item()
        if not (torch.isfinite(got).all() and rel <= TOL_REL):
            raise RuntimeError(f"{row['shape']}: kernel vs cuDNN relative "
                               f"difference {rel} > {TOL_REL}")
        row["rel_vs_cudnn"] = rel
        row["kernel_ms"] = device_ms(kernel, reps)
        ks = (f"kernel {row['kernel_ms']:7.3f} ms "
              f"({flops / (row['kernel_ms'] * 1e-3) / PEAK_BF16:6.1%} of "
              f"bf16 peak, rel vs cuDNN {rel:.1e})")
    else:
        ks = "kernel   (out of envelope)" + " " * 42
    row["cudnn_ms"] = device_ms(cudnn, reps)
    gs = ""
    if gemm and row["in_envelope"]:
        del x, res
        gs = bench_gemm(N * H * W, 9 * -(-cin // K_TILE) * K_TILE, cout,
                        reps, dev, gen)
    print(f"{row['shape']:26s} {ks}   cuDNN {row['cudnn_ms']:7.3f} ms "
          f"({flops / (row['cudnn_ms'] * 1e-3) / PEAK_BF16:6.1%}){gs}",
          flush=True)
    return row


def main(argv=None) -> list:
    """Time every shape; returns one dict a shape."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--gemm", action="store_true",
                    help="also time each product as a plain GEMM")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_conv_kernel: needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"{smi} | {args.reps} calls a timing", flush=True)
    rows = [bench_shape(name, N, H, W, cin, cout, d, args.reps, dev,
                        args.gemm)
            for N in BATCHES for name, H, W, cin, cout, d in SHAPES]
    torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
