"""The swin kernels at the default model's shapes, in both dtypes: a digest
of each kernel's outputs on seeded inputs and its time; then the steps
they serve.

    python3 -m stswincl_tpu_torch.tools.kernel_bits [--out f.json]
    python3 -m stswincl_tpu_torch.tools.compare_checkouts runs/parent \
        --script stswincl_tpu_torch/tools/kernel_bits.py

(the second form runs this script on another checkout's kernels and on
this one's in turns, other / this / this / other: every digest must be
the same in every turn, and the times sit side by side; the script uses
only entry points the port has had since its bf16 backwards took every
window, so an older checkout runs it too).

`TswinPlus`'s defaults: C 512 / 1024, 4 heads (hd 128 / 256), windows of
TN 128 (ws 8, T 2) and 32 (ws 4). Serving shapes (4, 2, 64, 80, C) and
(4, 2, 32, 40, 2C): K1 (W-MSA and SW-MSA), K2 (row 2, row 3 shifted, row
8's m), rows 10 and 11 (masked), row 16 (W-MSA), K3 at (8, 64, 80, 512)
and K4 (bf16 and exact) on (2, 12, 64, 80) -> 1024x1280. Training shapes
(16, 2, 64, 80, C) and (16, 2, 32, 40, 2C): K5 (SW-MSA, from K1's
scratch), K6 (row 7 at stage 1 shifted, row 9 at stage 2 with row 8's
m), and `wgrad_sm90` alone (stage 1's dwqkv). Each kernel runs in bf16
and in its fp32 form where it has one (TF32 off), on inputs drawn from a
seeded generator; a row holds the SHA-256 of its outputs' bytes, the
CUDA-event median of 10 single calls after two warm-ups (`ms`) and the
mean of 20 back-to-back calls (`device_ms`, the card's time without the
host's between calls). Then the steps they serve
(`profile_bwd_bf16.steps`): a stage-1 train step at batch 8 in bf16 and
in fp32 and a bf16 `predict_next` at bs 2. Writes
{"results": {name: [{"case", "ms", "device_ms", "sha"}]}, "failed": []}
to --out;
prints the card's name and power limit first. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
from collections import defaultdict

import torch

from stswincl_tpu_torch.tools.profile_swin_kernels import device_ms

# the steps and the single-call timer from this file's sibling, also when
# PYTHONPATH puts another checkout's package first
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from profile_bwd_bf16 import _median_ms, steps  # noqa: E402


def _digest(outs) -> str:
    h = hashlib.sha256()
    for t in outs:
        if t is not None:
            h.update(t.detach().contiguous().view(torch.uint8).cpu()
                     .numpy().tobytes())
    return h.hexdigest()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bits: needs a CUDA card")
    from stswincl_tpu_torch.ops import add_ln_mlp as epi
    from stswincl_tpu_torch.ops import attention as attn_ops
    from stswincl_tpu_torch.ops import block_attention as att
    from stswincl_tpu_torch.ops import gemm, patch_merge, swin_block
    from stswincl_tpu_torch.ops.resize import composed_matrices
    from stswincl_tpu_torch.ops.upsample_argmax import upsample_argmax
    from stswincl_tpu_torch.ops.window import (partition_qkv,
                                               shifted_window_attention_mask)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    bf16, f32 = torch.bfloat16, torch.float32
    results = defaultdict(list)

    def record(name, case, fn):
        out = fn()
        outs = out if isinstance(out, (tuple, list)) else (out,)
        row = {"case": case, "sha": _digest(outs), "ms": _median_ms(fn),
               "device_ms": device_ms(fn, 20)}
        results[name].append(row)
        print(f"{name} {case}: {row['ms']:.4f} ms, back to back "
              f"{row['device_ms']:.4f} ms, sha {row['sha'][:16]}",
              flush=True)
        torch.cuda.empty_cache()

    heads = 4
    for dtype in (bf16, f32):
        sfx = "" if dtype == bf16 else "_f32"
        gen = torch.Generator(device=dev).manual_seed(17)

        def randn(*shape, scale=1.0, dt=dtype):
            return (torch.randn(shape, generator=gen, device=dev)
                    * scale).to(dt)

        def uniform(*shape, fan_in, dt=dtype, gain=1.0):
            return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1)
                    * gain * fan_in ** -0.5).to(dt)

        for stage, (h, w, C, ws) in (("s1", (64, 80, 512, 8)),
                                     ("s2", (32, 40, 1024, 4))):
            T, hidden, TN = 2, 4 * C, 2 * ws * ws
            scale = (C // heads) ** -0.5
            mask = torch.from_numpy(shifted_window_attention_mask(
                h, w, ws, ws // 2)).repeat(1, T, T).to(dev)
            wts = (uniform(3 * C, C, fan_in=C, gain=3.0),
                   uniform(3 * C, fan_in=C, dt=f32),
                   uniform(C, C, fan_in=C, gain=2.0),
                   uniform(C, fan_in=C, dt=f32))
            bias = randn(heads, TN, TN, dt=f32)
            p = (1.0 + randn(C, scale=0.1, dt=f32),
                 randn(C, scale=0.1, dt=f32),
                 uniform(hidden, C, fan_in=C, gain=2.0),
                 uniform(hidden, fan_in=C, dt=f32),
                 uniform(C, hidden, fan_in=hidden, gain=2.0),
                 uniform(C, fan_in=hidden, dt=f32),
                 1.0 + randn(C, scale=0.1, dt=f32),
                 randn(C, scale=0.1, dt=f32))
            for B, kind in ((4, "serve"), (16, "train")):
                shape = (B, T, h, w, C)
                x, y, g = (randn(*shape) for _ in range(3))
                tag = f"{stage} {shape}"
                if kind == "serve":
                    k1 = getattr(att, "swin_block_attention" + sfx)
                    for shift in (0, ws // 2):
                        fwd = (x, *wts, bias, mask if shift else None,
                               heads, scale, ws, shift)
                        record(k1.__name__, f"{tag} shift={shift}",
                               lambda: k1(*fwd))
                    for row, shift, with_m in (("row 2", 0, False),
                                               ("row 3", ws // 2, False),
                                               ("row 8", 0, True)):
                        kw = dict(gelu_exact=True, shift=shift, ws=ws)
                        if dtype == bf16:
                            fn = (lambda kw=kw, wm=with_m:
                                  epi._forward_kernel(x, y, *p, eps=1e-5,
                                                      with_m=wm, **kw))
                        else:
                            fn = (lambda kw=kw, wm=with_m:
                                  epi.swin_block_epilogue_f32(
                                      x, y, *p, m_out=wm, **kw))
                        record("swin_block_epilogue" + sfx, f"{tag} {row}",
                               fn)
                    qkv = randn(B, T, h, w, 3 * C)
                    q, k, v = partition_qkv(qkv, heads, ws).contiguous()
                    r10 = getattr(att, "windowed_attention_image" + sfx)
                    record(r10.__name__, f"{tag} mask=True",
                           lambda: r10(qkv, bias, mask, heads, scale, ws))
                    r11 = getattr(attn_ops, "fused_window_attention" + sfx)
                    record(r11.__name__, f"{tag} mask=True",
                           lambda: r11(q, k, v, bias, mask, scale))
                    del qkv, q, k, v
                    r16 = getattr(swin_block, "whole_swin_block" + sfx)
                    record(r16.__name__, f"{tag} W-MSA",
                           lambda: r16(x, *wts, bias, None, *p, heads, scale,
                                       ws))
                else:
                    fwd = (x, *wts, bias, mask, heads, scale, ws, ws // 2)
                    k1f = (att._forward_kernel if dtype == bf16
                           else att._forward_f32)
                    _, qkv, attn = k1f(*fwd)
                    k5 = getattr(att, "swin_block_attention_bwd" + sfx)
                    record(k5.__name__, f"{tag} SW-MSA",
                           lambda: k5(x, g, qkv, attn, wts[0], wts[2], bias,
                                      mask, *fwd[7:]))
                    del qkv, attn
                    shift = ws // 2 if stage == "s1" else 0
                    kw = dict(gelu_exact=True, shift=shift, ws=ws)
                    m = None
                    if stage == "s2":
                        m = (epi._forward_kernel(x, y, *p, eps=1e-5,
                                                 with_m=True, **kw)[1]
                             if dtype == bf16 else
                             epi.swin_block_epilogue_f32(
                                 x, y, *p, m_out=True, **kw)[1])
                    k6 = getattr(epi, "swin_block_epilogue_bwd" + sfx)
                    row = "row 7" if m is None else "row 9"
                    record(k6.__name__, f"{tag} {row} shift={shift}",
                           lambda: k6(x, y, g, m, *p[:7], **kw))
                    del m
                    if dtype == bf16 and stage == "s1":
                        R = x.numel() // C
                        dq, xr = randn(R, 3 * C), randn(R, C)
                        record("wgrad_sm90", f"dwqkv {stage} ({R}, 3C)",
                               lambda: gemm.wgrad_sm90(
                                   dq, xr, None, (T, h, w, ws, ws // 2)))
                        del dq, xr
                del x, y, g
                torch.cuda.empty_cache()
        C = 512
        xm = randn(8, 64, 80, C)
        pm = (1.0 + randn(4 * C, scale=0.1, dt=f32),
              randn(4 * C, scale=0.1, dt=f32),
              uniform(2 * C, 4 * C, fan_in=4 * C))
        k3 = getattr(patch_merge, "patch_merge" + sfx)
        record(k3.__name__, f"{tuple(xm.shape)}", lambda: k3(xm, *pm))
        del xm, pm
    gen = torch.Generator(device=dev).manual_seed(19)
    lcf = torch.randn((2, 12, 64, 80), generator=gen, device=dev)
    mh, mw = (t.to(dev) for t in composed_matrices(64, 80, (512, 640),
                                                    (1024, 1280)))
    for exact in (False, True):
        record("upsample_argmax", f"{tuple(lcf.shape)} exact={exact}",
               lambda: upsample_argmax(lcf, mh, mw, exact))
    steps(results, dev, (bf16, f32))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"results": results, "failed": []}, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
