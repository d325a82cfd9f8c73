"""Rows 10 and 11 in bf16 at the default model's serving shapes: the
kernel's own device time by `torch.profiler`, on the GPU.

    python3 -m stswincl_tpu_torch.tools.compare_checkouts runs/parent \
        --script stswincl_tpu_torch/tools/profile_row_attention.py

At stage 1 (4, 2, 64, 80, 512) ws 8 and stage 2 (4, 2, 32, 40, 1024) ws
4, 4 heads, masked (SW-MSA), seeded inputs: the device time a call of the
kernels whose name holds "window_attention", summed by the profiler over
20 calls after three warm-ups. At stage 2 a call takes about 0.04 ms, so
the back-to-back mean of `tools/kernel_bits.py` (`device_ms`) measures the
host's launches there, not the kernel. Writes {"results": {name:
[{"case", "ms"}]}, "failed": []} to --out. Needs a CUDA card.
"""
import argparse
import json

import torch
from torch.profiler import ProfilerActivity, profile


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    args = ap.parse_args()
    from stswincl_tpu_torch.ops import attention as attn_ops
    from stswincl_tpu_torch.ops import block_attention as att
    from stswincl_tpu_torch.ops.window import (partition_qkv,
                                               shifted_window_attention_mask)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {}
    for tag, (B, T, h, w, C, heads, ws) in (
            ("s1", (4, 2, 64, 80, 512, 4, 8)),
            ("s2", (4, 2, 32, 40, 1024, 4, 4))):
        TN = T * ws * ws
        qkv = (torch.randn(B, T, h, w, 3 * C, generator=gen, device=dev)
               * 2).bfloat16()
        q, k, v = partition_qkv(qkv, heads, ws).contiguous()
        bias = torch.randn(heads, TN, TN, generator=gen, device=dev) * 0.5
        mask = torch.from_numpy(shifted_window_attention_mask(
            h, w, ws, ws // 2)).repeat(1, T, T).to(dev)
        sc = (C // heads) ** -0.5
        for name, fn in (
                ("windowed_attention_image",
                 lambda: att.windowed_attention_image(qkv, bias, mask, heads,
                                                      sc, ws)),
                ("fused_window_attention",
                 lambda: attn_ops.fused_window_attention(q, k, v, bias, mask,
                                                         sc))):
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
            tot = sum(e.device_time_total for e in prof.key_averages()
                      if "window_attention" in e.key) / 1e3 / 20
            res.setdefault(name, []).append({"case": tag, "ms": tot})
            print(name, tag, f"{tot:.4f} ms (profiler device time a call)",
                  flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"results": res, "failed": []}, f)


if __name__ == "__main__":
    main()
