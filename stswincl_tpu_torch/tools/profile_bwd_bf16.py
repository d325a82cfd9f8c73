"""The bf16 training backwards and the steps they serve, timed on the GPU.

    python3 -m stswincl_tpu_torch.tools.profile_bwd_bf16 [--out f.json]
        [--swin-dim 512] [--heads 4]
    PYTHONPATH=<other checkout> python3 <this file> [--out f.json]
    python3 -m stswincl_tpu_torch.tools.profile_bwd_bf16 --slot-vs-passes

(the second form times another checkout's kernels with this script; it
uses only entry points the port has had since its bf16 backwards landed,
so a parent commit runs it too; `tools/compare_checkouts.py --script`
runs it on two checkouts in turns).

At the training shapes, (16, 2, 64, 80, C) ws 8 (stage 1) and (16, 2,
32, 40, 2C) ws 4 (stage 2), C the `--swin-dim` (512) over `--heads` (4)
heads, seeded inputs, each with and
without the SW-MSA shift: K5 (`swin_block_attention_bwd`, Pallas row 6)
at both stages, K6 (`swin_block_epilogue_bwd`) as row 7 (m recomputed) at
stage 1 and row 9 (given row 8's m) at stage 2. Each is timed with CUDA
events (the median of 10 single calls after two warm-ups), then split by
kernel with `torch.profiler` over 3 calls (device ms a call by kernel
name, launches a call). Then the bf16 stage-1 train step of
TswinPlus(12, that swin_dim and heads, depths (3, 3)) at batch 8
(512x640, Adam, OHEM; host clock and a sync, the median of 6 steps after 2) and a
`predict_next` at bs 2 (512x640 -> 1024x1280; host clock and a sync, the
median of 8 after 2). Prints the card's name and power limit first, and
writes {"results": {name: [{"case", "ms", "kernels"}]}, "failed": []}
to --out. With `--slot-vs-passes`, only K5 at equal work on its two
attention backwards (this checkout's; the parent has no two passes):
(16, 2, 64, 80, C) ws 8 at C 512 over 4 heads (hd 128, the one-pass slot
kernel) and 2 (hd 256, the two passes), and at C 256 over 2 and 1, each
timed and split by kernel as above. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

def stages(swin_dim: int = 512) -> dict:
    """Both stages' training block shapes and windows."""
    return {"s1": ((16, 2, 64, 80, swin_dim), 8),
            "s2": ((16, 2, 32, 40, 2 * swin_dim), 4)}


STAGES = stages()


def _median_ms(fn, reps=10):
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


def steps(results, dev, dtypes, swin_dim=512, heads=4) -> None:
    """TswinPlus(12, swin_dim, heads, depths (3, 3)) from seeded weights:
    a stage-1 train step at batch 8 in each of `dtypes` (512x640, Adam,
    OHEM; host clock and a sync, the median of 6 steps after 2), then a
    bf16 `predict_next` at bs 2 (512x640 -> 1024x1280; the median of 8
    after 2), into results["stage-1 step"] / ["predict_next"]."""
    from stswincl_tpu_torch.configs import SegTrainConfig
    from stswincl_tpu_torch.models import TswinPlus
    from stswincl_tpu_torch.models.init import init_weights
    from stswincl_tpu_torch.pipelines.seg import make_tx
    from stswincl_tpu_torch.pipelines.streaming import StreamingSegmenter
    from stswincl_tpu_torch.train.train_seg import make_seg_train_step

    def model(dtype):
        m = TswinPlus(num_classes=12, swin_dim=swin_dim, num_heads=heads,
                      swin_depths=(3, 3), dtype=dtype, input_hw=(512, 640))
        init_weights(m, torch.Generator().manual_seed(0))
        return m.to(dev)

    cfg = SegTrainConfig()
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.uniform(
        -1, 1, (8, 4, 512, 640, 3)).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 12, (8, 512, 640))).to(
        dev).long()
    for dtype in dtypes:
        m = model(dtype).train()
        opt, schedule = make_tx(cfg, 8, m)
        step = make_seg_train_step(m, opt, schedule, cfg.loss,
                                   ohem_thresh=cfg.ohem_thresh)
        secs = []
        for _ in range(8):
            ts = time.perf_counter()
            step(images, labels)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - ts)
        ms = 1e3 * statistics.median(secs[2:])
        name = str(dtype)[6:]
        results["stage-1 step"].append({"case": f"{name} batch 8",
                                        "ms": ms})
        print(f"{name} stage-1 step at batch 8: {ms:.2f} ms (steps "
              f"{[round(1e3 * s, 1) for s in secs]})", flush=True)
        del m, opt, step
        torch.cuda.empty_cache()
    del images, labels
    gen = torch.Generator(device=dev).manual_seed(41)
    frames = torch.rand((2, 14, 512, 640, 3), generator=gen,
                        device=dev) * 2 - 1
    seg = StreamingSegmenter(model(torch.bfloat16).eval(),
                             out_hw=(1024, 1280))
    with torch.no_grad():
        cache, _ = seg.init_and_predict(frames[:, 0:4])
        secs = []
        for i in range(4, 14):
            ts = time.perf_counter()
            cache, _ = seg.predict_next(cache, frames[:, i])
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - ts)
    ms = 1e3 * statistics.median(secs[2:])
    results["predict_next"].append({"case": "bf16 bs 2", "ms": ms})
    print(f"bf16 predict_next at bs 2: {ms:.2f} ms", flush=True)


def _split(fn, calls=3):
    """Device ms a call and launches a call by kernel name."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by = defaultdict(lambda: [0.0, 0])
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by[e.key][0] += e.self_device_time_total / 1e3 / calls
            by[e.key][1] += e.count / calls
    return {k[:90]: [round(v[0], 4), v[1]] for k, v in
            sorted(by.items(), key=lambda kv: -kv[1][0])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-steps", action="store_true",
                    help="the kernels only, not the train step and serving")
    ap.add_argument("--slot-vs-passes", action="store_true",
                    help="K5's slot kernel against its two passes at equal "
                    "work, alone")
    ap.add_argument("--swin-dim", type=int, default=512,
                    help="stage 1's channels (stage 2 twice them)")
    ap.add_argument("--heads", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_bwd_bf16: needs a CUDA card")
    from stswincl_tpu_torch.ops import add_ln_mlp as epi
    from stswincl_tpu_torch.ops import block_attention as att
    from stswincl_tpu_torch.ops.window import shifted_window_attention_mask
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(31)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def uniform(*shape, fan_in, dtype=bf16, gain=1.0):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1)
                * gain * fan_in ** -0.5).to(dtype)

    results = defaultdict(list)

    def record(name, case, fn):
        row = {"case": case, "ms": _median_ms(fn), "kernels": _split(fn)}
        results[name].append(row)
        print(f"{name} {case}: {row['ms']:.4f} ms", flush=True)
        for k, (ms, n) in row["kernels"].items():
            print(f"    {ms:8.4f} ms  x{n:<5g} {k}", flush=True)

    if args.slot_vs_passes:
        for C, heads in ((512, 4), (512, 2), (256, 2), (256, 1)):
            shape, ws, TN = (16, 2, 64, 80, C), 8, 128
            x, g = randn(*shape), randn(*shape)
            wqkv, wproj = uniform(3 * C, C, fan_in=C), uniform(C, C, fan_in=C)
            bqkv = uniform(3 * C, fan_in=C, dtype=f32)
            bproj = uniform(C, fan_in=C, dtype=f32)
            bias = randn(heads, TN, TN, dtype=f32)
            fwd = (x, wqkv, bqkv, wproj, bproj, bias, None, heads,
                   (C // heads) ** -0.5, ws, 0)
            _, qkv, attn = att._forward_kernel(*fwd)
            path = ("slot" if att._attn_bwd_slot_takes(TN, C // heads)
                    else "two passes")
            record("K5", f"C {C} heads {heads} hd {C // heads} ({path})",
                   lambda: att.swin_block_attention_bwd(
                       x, g, qkv, attn, wqkv, wproj, bias, None, *fwd[7:]))
            del x, g, qkv, attn
        args.no_steps = True
    heads = args.heads
    for label, (shape, ws) in (() if args.slot_vs_passes
                               else stages(args.swin_dim).items()):
        B, T, h, w, C = shape
        TN, hidden = T * ws * ws, 4 * C
        x, g, y = randn(*shape), randn(*shape), randn(*shape)
        wqkv = uniform(3 * C, C, fan_in=C, gain=3.0)
        bqkv = uniform(3 * C, fan_in=C, dtype=f32)
        wproj = uniform(C, C, fan_in=C, gain=2.0)
        bproj = uniform(C, fan_in=C, dtype=f32)
        bias = randn(heads, TN, TN, dtype=f32)
        p = (1.0 + randn(C, scale=0.1, dtype=f32),
             randn(C, scale=0.1, dtype=f32),
             uniform(hidden, C, fan_in=C, gain=2.0),
             uniform(hidden, fan_in=C, dtype=f32),
             uniform(C, hidden, fan_in=hidden, gain=2.0),
             uniform(C, fan_in=hidden, dtype=f32),
             1.0 + randn(C, scale=0.1, dtype=f32),
             randn(C, scale=0.1, dtype=f32))
        for shift in (0, ws // 2):
            mask = None
            if shift:
                mask = torch.from_numpy(shifted_window_attention_mask(
                    h, w, ws, shift)).repeat(1, T, T).to(dev)
            fwd = (x, wqkv, bqkv, wproj, bproj, bias, mask, heads,
                   (C // heads) ** -0.5, ws, shift)
            _, qkv, attn = att._forward_kernel(*fwd)
            record("K5", f"{label} {shape} shift={shift}",
                   lambda: att.swin_block_attention_bwd(
                       x, g, qkv, attn, wqkv, wproj, bias, mask, *fwd[7:]))
            del qkv, attn
            kw = dict(gelu_exact=True, shift=shift, ws=ws)
            m = None
            row = "row 7"
            if label == "s2":
                m = epi._forward_kernel(x, y, *p, eps=1e-5, with_m=True,
                                        **kw)[1]
                row = "row 9"
            record("K6", f"{row} {label} {shape} shift={shift}",
                   lambda: epi.swin_block_epilogue_bwd(x, y, g, m, *p[:7],
                                                       **kw))
            del m
        del x, g, y
        torch.cuda.empty_cache()

    if not args.no_steps:
        steps(results, dev, (bf16,), args.swin_dim, args.heads)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"results": results, "failed": []}, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
