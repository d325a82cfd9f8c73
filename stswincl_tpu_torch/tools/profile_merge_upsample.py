"""K3 (the patch merge, `csrc/patch_merge.cu`) and K4 (the upsample +
argmax, `csrc/upsample_argmax.cu`) timed at the model's shapes.

    python3 -m stswincl_tpu_torch.tools.profile_merge_upsample [--reps 30]

The script reaches the package by import, so it can also time another
checkout's kernels: `PYTHONPATH=<checkout> python3 <this file>`.

For each call, as `profile_layer_norm` prints them: the median of single
calls between CUDA events (`single`, host launch time included), the mean
of back-to-back calls (`device`), the kernels' own device time under
`torch.profiler` (`kernel`) and the host's wall time a call, beside the
bound (the larger of the operations over the dense peak for their type
and the bytes over 3.35 TB/s, each input read and each output written
once). Calls:
  - K3 forward at the serving shape (8, 64, 80, 512) and the stage-1
    training shape (32, 64, 80, 512), bf16, seeded; then, at the training
    shape, K3's forward and backward through autograd (x bf16, w an fp32
    parameter), with the backward's CUDA kernels by name and device time
    (its products' names say whether they ran in bf16 or fp32);
  - K4 at (2, 12, 64, 80) -> (2, 1024, 1280) on the EndoVis protocol's
    composed matrices, bf16 and `exact`, the spans passed where the
    wrapper takes them; its bound counts the products the matrices'
    nonzero spans need.
Prints the card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import inspect
import subprocess
from collections import defaultdict

import torch

from stswincl_tpu_torch.ops.patch_merge import patch_merge
from stswincl_tpu_torch.ops.resize import composed_matrices
from stswincl_tpu_torch.ops.upsample_argmax import upsample_argmax
from stswincl_tpu_torch.tools.profile_layer_norm import (host_us, kernel_ms,
                                                         single_ms)
from stswincl_tpu_torch.tools.profile_swin_kernels import (PEAK_BF16,
                                                           PEAK_BYTES,
                                                           device_ms)

PEAK_F32 = 67e12  # H100 SXM, fp32 outside the tensor cores
K3_SHAPES = {"serve": (8, 64, 80, 512), "train": (32, 64, 80, 512)}
K4_CASE = ((2, 12, 64, 80), (512, 640), (1024, 1280))


def bound_ms(flops: float, nbytes: float, peak: float) -> float:
    return max(flops / peak, nbytes / PEAK_BYTES) * 1e3


def k3_work(BT: int, H: int, W: int, C: int) -> tuple:
    """(flops, bytes) of K3's forward: the 4C -> 2C product; x read, the
    output written, scale, bias and w read."""
    R = BT * (H // 2) * (W // 2)
    return (2 * R * 4 * C * 2 * C,
            BT * H * W * C * 2 + R * 2 * C * 2 + 8 * C * C * 2 + 8 * C * 4)


def spans(m: torch.Tensor) -> torch.Tensor:
    """[lo, hi) of each row's nonzeros, (rows, 2) int32 (the wrapper's
    `interp_spans`, written out so that this script runs on a checkout
    without it)."""
    n = m.shape[1]
    col = torch.arange(n, device=m.device)
    nz = m != 0
    hi = torch.where(nz, col + 1, 0).amax(dim=1)
    lo = torch.minimum(torch.where(nz, col, n).amin(dim=1), hi)
    return torch.stack([lo, hi], dim=1).to(torch.int32)


def k4_work(shape, sh, sw) -> tuple:
    """(flops, bytes) of K4 on logits of `shape` (B, NC, h, w) from the
    matrices' spans sh (OH, 2), sw (OW, 2): the nonzero products of the
    cheaper order of the two interpolation products (mh @ x on every input
    column, then each output over its column's span, or the other way
    round); the logits, both (dense) matrices and their spans read once,
    the int32 prediction written once."""
    B, NC, h, w = shape
    OH, OW = sh.shape[0], sw.shape[0]
    lh = int((sh[:, 1] - sh[:, 0]).sum())
    lw = int((sw[:, 1] - sw[:, 0]).sum())
    macs = B * NC * min(w * lh + OH * lw, h * lw + OW * lh)
    nbytes = (B * NC * h * w + OH * h + OW * w) * 4 + (OH + OW) * 8 \
        + B * OH * OW * 4
    return 2 * macs, nbytes


def measure(name: str, fn, bound: float, reps: int) -> dict:
    row = {"call": name, "single_ms": single_ms(fn, reps),
           "device_ms": device_ms(fn, reps), "kernel_ms": kernel_ms(fn, reps),
           "host_us": host_us(fn, reps), "bound_ms": bound}
    k = row["kernel_ms"]
    print(f"  {name:44s} single {row['single_ms']:.4f} ms  device "
          f"{row['device_ms']:.4f} ms  kernel "
          f"{'None' if k is None else f'{k:.4f}'} ms  host "
          f"{row['host_us']:.1f} us  bound {bound:.4f} ms", flush=True)
    return row


def kernels_by_name(fn, reps: int) -> list:
    """(name, mean device ms a call) of every CUDA kernel `fn` runs, by
    `torch.profiler`, largest first."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = defaultdict(float)
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us[e.key] += getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0))
    return sorted(((k, v / reps / 1e3) for k, v in us.items()),
                  key=lambda kv: -kv[1])


def main(argv=None) -> list:
    """Time every call; returns one dict a call."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_merge_upsample: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"{smi} | {args.reps} calls a timing", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, k=1.0, o=0.0):
        return torch.randn(shape, generator=gen, device=dev) * k + o

    rows = []
    for tag, (BT, H, W, C) in K3_SHAPES.items():
        x = randn(BT, H, W, C).to(bf)
        scale, bias = randn(4 * C, k=0.1, o=1.0), randn(4 * C, k=0.1)
        w = (randn(2 * C, 4 * C) * (4 * C) ** -0.5).to(bf)
        fl, nb = k3_work(BT, H, W, C)
        rows.append(measure(f"K3 {tag} {(BT, H, W, C)}", lambda: patch_merge(
            x, scale, bias, w), bound_ms(fl, nb, PEAK_BF16), args.reps))
        if tag == "train":
            xg = x.clone().requires_grad_()
            sg, bg = (t.clone().requires_grad_() for t in (scale, bias))
            wg = w.float().requires_grad_()
            g = randn(BT, H // 2, W // 2, 2 * C).to(bf)

            def fwd_bwd():
                torch.autograd.grad(patch_merge(xg, sg, bg, wg),
                                    (xg, sg, bg, wg), g)
            # the backward adds dn and dW (two products as large as the
            # forward's); g and dx as large as the output and x, and the
            # weights' gradients as large as the weights
            rows.append(measure(f"K3 {tag} forward + backward", fwd_bwd,
                                bound_ms(3 * fl, 2 * nb, PEAK_BF16),
                                max(args.reps // 3, 3)))
            out = patch_merge(xg, sg, bg, wg)
            bwd = lambda: torch.autograd.grad(out, (xg, sg, bg, wg), g,
                                              retain_graph=True)
            named = kernels_by_name(bwd, 3)
            print(f"  K3 {tag} backward, CUDA kernels by device ms a call "
                  f"(total {sum(v for _, v in named):.4f} ms):", flush=True)
            for k, v in named:
                print(f"    {v:8.4f} ms  {k[:110]}", flush=True)
            rows[-1]["backward_kernels"] = named
            del xg, wg, out
        del x
    torch.cuda.empty_cache()

    shape, mid, out_hw = K4_CASE
    lcf = randn(*shape)
    mh, mw = (m.to(dev) for m in composed_matrices(shape[2], shape[3], mid,
                                                   out_hw))
    sh, sw = spans(mh), spans(mw)
    fl, nb = k4_work(shape, sh, sw)
    kw = ({"spans": (sh, sw)} if "spans" in inspect.signature(
        upsample_argmax).parameters else {})
    for exact in (False, True):
        rows.append(measure(
            f"K4 {shape} -> {out_hw} exact={exact}",
            lambda: upsample_argmax(lcf, mh, mw, exact, **kw),
            bound_ms(fl, nb, PEAK_F32 if exact else PEAK_BF16), args.reps))
    return rows


if __name__ == "__main__":
    main()
