"""K5 bf16 at the windows past its one-pass slot kernel (`chip_smoke.py`
phase 2g's): a digest of its outputs and its time, on the GPU.

    python3 -m stswincl_tpu_torch.tools.compare_checkouts runs/parent \
        --script stswincl_tpu_torch/tools/k5_two_pass_bits.py

(any checkout whose K5 runs its two passes at these windows runs it).
At (8, 2, 64, 80, 768) / 4 heads (TN 128 x hd 192), (16, 2, 64,
80, 512) / 2 (hd 256), (4, 2, 64, 80, 1152) / 4 (hd 288), (8, 4, 48, 60,
256) / 4 ws 6 (TN 144 x hd 64) and (2, 11, 32, 40, 1664) / 8 ws 4 (TN
176 x hd 208), with and without the shift, on seeded inputs from K1's
window-order scratch: the SHA-256 of `swin_block_attention_bwd`'s outputs
and the CUDA-event median of 10 single calls after two warm-ups. Writes
{"results": {"k5_two_pass": [{"case", "sha", "ms"}]}, "failed": []} to
--out. Needs a CUDA card.
"""
import argparse
import hashlib
import json
import statistics

import torch


def digest(outs):
    h = hashlib.sha256()
    for t in outs:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def median_ms(fn, reps=10):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


WINDOWS = {"TN128 hd192": ((8, 2, 64, 80, 768), 4, 8),
           "TN128 hd256": ((16, 2, 64, 80, 512), 2, 8),
           "TN128 hd288": ((4, 2, 64, 80, 1152), 4, 8),
           "TN144 hd64": ((8, 4, 48, 60, 256), 4, 6),
           "TN176 hd208": ((2, 11, 32, 40, 1664), 8, 4)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    args = ap.parse_args()
    from stswincl_tpu_torch.ops import block_attention as att
    from stswincl_tpu_torch.ops.window import shifted_window_attention_mask
    dev = torch.device("cuda")
    res = {}
    gen = torch.Generator(device=dev).manual_seed(23)
    bf = torch.bfloat16
    for label, (shape, heads, ws) in WINDOWS.items():
        B, T, h, w, C = shape
        TN, hd = T * ws * ws, C // heads
        x = torch.randn(shape, generator=gen, device=dev).to(bf)
        g = torch.randn(shape, generator=gen, device=dev).to(bf)
        wq = ((torch.rand(3 * C, C, generator=gen, device=dev) * 2 - 1)
              * 3 * C ** -0.5).to(bf)
        bq = (torch.rand(3 * C, generator=gen, device=dev) * 2 - 1) \
            * C ** -0.5
        wp = ((torch.rand(C, C, generator=gen, device=dev) * 2 - 1)
              * 2 * C ** -0.5).to(bf)
        bp = (torch.rand(C, generator=gen, device=dev) * 2 - 1) * C ** -0.5
        bias = torch.randn(heads, TN, TN, generator=gen, device=dev)
        for shift in (0, ws // 2):
            mask = None
            if shift:
                mask = torch.from_numpy(shifted_window_attention_mask(
                    h, w, ws, shift)).repeat(1, T, T).to(dev)
            fwd = (x, wq, bq, wp, bp, bias, mask, heads, hd ** -0.5, ws,
                   shift)
            _, qkv, attn = att._forward_kernel(*fwd)

            def fn():
                return att.swin_block_attention_bwd(x, g, qkv, attn, wq, wp,
                                                    bias, mask, *fwd[7:])
            outs = fn()
            torch.cuda.synchronize()
            row = {"case": f"{label} shift={shift}", "sha": digest(outs),
                   "ms": median_ms(fn)}
            res.setdefault("k5_two_pass", []).append(row)
            print(row, flush=True)
            del qkv, attn, outs
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"results": res, "failed": []}, f)


if __name__ == "__main__":
    main()
