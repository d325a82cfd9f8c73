#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`stswincl_tpu_torch`) once on one GPU.

    python3 chip_smoke.py

Phases (each prints its seconds; any failure raises and exits non-zero):
  1. build the hand-written CUDA kernels from `stswincl_tpu_torch/csrc/`;
  2. hold each kernel against its plain PyTorch twin at the serving
     path's full-width shapes, in bf16 (K4 also in `exact` fp32), and time
     both with CUDA events;
  3. serve: TswinPlus(num_classes=12, swin_dim=512, depths (3, 3), bf16)
     with seeded random weights (BatchNorm statistics calibrated on the
     first clip) through StreamingSegmenter at 512x640 ->
     1024x1280, bs 2, `init_and_predict` then `predict_next` frames; the
     streamed predictions are held against the full-clip kernel route and
     the plain route, and every kernel must have launched.

The line before the last is a JSON object with each kernel's launches,
error and times; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

TOL_REL = 1e-2        # K1-K3: ||kernel - plain|| / ||plain||
TOL_K4_SHARE = 0.999  # K4: share of equal pixels
TOL_STREAM_SHARE = 0.999  # streamed vs full-clip kernel route
TOL_PLAIN_SHARE = 0.98    # kernel route vs plain route (bf16 rounding)
BS, H, W, OUT_HW, STEPS = 2, 512, 640, (1024, 1280), 10


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def calibrate_batchnorm(model, clip) -> None:
    """Set each BatchNorm's running statistics to the statistics of its
    input on `clip`, layer by layer in forward order. Seeded random weights
    with identity statistics shrink the backbone's activations layer by
    layer and the served classes collapse to one; calibrated, the
    predictions spread over the classes, so the route comparisons below
    test something. A BatchNorm that sees fewer than 64 values per channel
    (the ASPP image-pool branch: one per image) keeps identity statistics:
    a variance from two samples is near zero and would amplify rounding
    noise into the logits."""
    import torch
    from stswincl_tpu_torch.models.norm import BatchNorm

    def hook(mod, args):
        x = args[0].float()
        if x.numel() // x.shape[-1] < 64:
            return
        dims = tuple(range(x.dim() - 1))
        mod.running_mean.copy_(x.mean(dims))
        mod.running_var.copy_(x.var(dims, unbiased=False))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, BatchNorm)]
    try:
        with torch.no_grad():
            model(clip, head_res_logits=True)
    finally:
        for h in handles:
            h.remove()


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels "
                         "need a GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from stswincl_tpu_torch import kernels
    from stswincl_tpu_torch.models import TswinPlus
    from stswincl_tpu_torch.models.init import init_weights
    from stswincl_tpu_torch.ops.add_ln_mlp import (swin_block_epilogue,
                                                   swin_block_epilogue_ref)
    from stswincl_tpu_torch.ops.block_attention import (
        swin_block_attention, swin_block_attention_ref)
    from stswincl_tpu_torch.ops.patch_merge import (patch_merge,
                                                    patch_merge_ref)
    from stswincl_tpu_torch.ops.resize import (composed_matrices,
                                               composed_upsample_argmax_cf)
    from stswincl_tpu_torch.ops.upsample_argmax import (upsample_argmax,
                                                        upsample_argmax_ref)
    from stswincl_tpu_torch.ops.window import shifted_window_attention_mask
    from stswincl_tpu_torch.pipelines.streaming import StreamingSegmenter

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    # ---- phase 1: build -------------------------------------------------
    t0 = time.perf_counter()
    kernels.build(verbose=True)
    kernels.load()
    print(f"phase 1 build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {kernels.build_seconds} s)", flush=True)

    # ---- phase 2: kernels against their twins ----------------------------
    t0 = time.perf_counter()

    def randn(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def uniform(*shape, fan_in, dtype=bf16):
        b = fan_in ** -0.5
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1)
                * b).to(dtype)

    def median_ms(fn, reps=10):
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

    results = {}  # kernel -> list of case dicts

    def compare(kname, case, kfn, pfn):
        got, want = kfn(), pfn()
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{kname} {case}: {got.shape}/{got.dtype} vs "
              f"{want.shape}/{want.dtype}")
        d = got.float() - want.float()
        row = {"case": case, "max_abs_err": d.abs().max().item(),
               "rel_err": (d.norm() / want.float().norm()).item(),
               "ms": median_ms(kfn), "plain_ms": median_ms(pfn)}
        results.setdefault(kname, []).append(row)
        print(f"  {kname:22s} {case:34s} max_abs {row['max_abs_err']:.3e} "
              f"rel {row['rel_err']:.3e} kernel {row['ms']:.3f} ms "
              f"plain {row['plain_ms']:.3f} ms", flush=True)
        check(row["rel_err"] <= TOL_REL, f"{kname} {case}: relative error "
              f"{row['rel_err']} > {TOL_REL}")

    stage = {1: dict(C=512, h=64, w=80, ws=8), 2: dict(C=1024, h=32, w=40,
                                                       ws=4)}
    for s, cfg in stage.items():
        C, h, w, ws = cfg["C"], cfg["h"], cfg["w"], cfg["ws"]
        heads, T = 4, 2
        TN = T * ws * ws
        x = randn(2 * BS, T, h, w, C)
        wqkv, bqkv = (uniform(3 * C, C, fan_in=C),
                      uniform(3 * C, fan_in=C, dtype=torch.float32))
        wproj, bproj = (uniform(C, C, fan_in=C),
                        uniform(C, fan_in=C, dtype=torch.float32))
        bias = randn(heads, TN, TN, scale=0.02, dtype=torch.float32)
        for shift in (0, ws // 2):
            mask = None
            if shift:
                m = torch.from_numpy(
                    shifted_window_attention_mask(h, w, ws, shift))
                mask = m.repeat(1, T, T).to(dev)
            args = (x, wqkv, bqkv, wproj, bproj, bias, mask, heads,
                    (C // heads) ** -0.5, ws, shift)
            compare("swin_block_attention",
                    f"stage{s} {tuple(x.shape)} shift={shift}",
                    lambda: swin_block_attention(*args),
                    lambda: swin_block_attention_ref(*args))
        hidden = 4 * C
        epi_w = (1.0 + randn(C, scale=0.1, dtype=torch.float32),
                 randn(C, scale=0.1, dtype=torch.float32),
                 uniform(hidden, C, fan_in=C),
                 uniform(hidden, fan_in=C, dtype=torch.float32),
                 uniform(C, hidden, fan_in=hidden),
                 uniform(C, fan_in=hidden, dtype=torch.float32),
                 1.0 + randn(C, scale=0.1, dtype=torch.float32),
                 randn(C, scale=0.1, dtype=torch.float32))
        y = randn(2 * BS, T, h, w, C)
        cases = [("plain", x, y, 0), (f"shift={ws // 2}", x, y, ws // 2)]
        if s == 1:  # the final_pair_only slice
            cases.append((f"T=1 shift={ws // 2}", x[:, 1:].contiguous(),
                          y[:, 1:].contiguous(), ws // 2))
        for name, xa, ya, shift in cases:
            kw = dict(gelu_exact=True, shift=shift, ws=ws)
            compare("swin_block_epilogue",
                    f"stage{s} {tuple(xa.shape)} {name}",
                    lambda: swin_block_epilogue(xa, ya, *epi_w, **kw),
                    lambda: swin_block_epilogue_ref(xa, ya, *epi_w, **kw))
    C = 512
    xm = randn(4 * BS, 64, 80, C)
    pm = (1.0 + randn(4 * C, scale=0.1, dtype=torch.float32),
          randn(4 * C, scale=0.1, dtype=torch.float32),
          uniform(2 * C, 4 * C, fan_in=4 * C))
    compare("patch_merge", f"{tuple(xm.shape)}",
            lambda: patch_merge(xm, *pm), lambda: patch_merge_ref(xm, *pm))

    lcf = randn(BS, 12, 64, 80, dtype=torch.float32)
    mh, mw = (m.to(dev) for m in composed_matrices(64, 80, (H, W), OUT_HW))
    for exact in (False, True):
        got = upsample_argmax(lcf, mh, mw, exact)
        want = upsample_argmax_ref(lcf, mh, mw, exact)
        torch.cuda.synchronize()
        check(got.shape == (BS, *OUT_HW) and got.dtype == torch.int32,
              f"upsample_argmax: {got.shape} {got.dtype}")
        share = (got == want).float().mean().item()
        row = {"case": f"{tuple(lcf.shape)} exact={exact}",
               "max_abs_err": (got - want).abs().max().item(),
               "equal_share": share,
               "ms": median_ms(lambda: upsample_argmax(lcf, mh, mw, exact)),
               "plain_ms": median_ms(
                   lambda: upsample_argmax_ref(lcf, mh, mw, exact))}
        results.setdefault("upsample_argmax", []).append(row)
        print(f"  {'upsample_argmax':22s} {row['case']:34s} equal "
              f"{share:.6f} kernel {row['ms']:.3f} ms plain "
              f"{row['plain_ms']:.3f} ms", flush=True)
        check(share >= TOL_K4_SHARE, f"upsample_argmax exact={exact}: "
              f"{share} of pixels equal < {TOL_K4_SHARE}")
    print(f"phase 2 kernels vs plain: {time.perf_counter() - t0:.1f} s",
          flush=True)

    # ---- phase 3: serve --------------------------------------------------
    t0 = time.perf_counter()
    model = TswinPlus(num_classes=12, swin_dim=512, swin_depths=(3, 3),
                      dtype=bf16, input_hw=(H, W))
    init_weights(model, torch.Generator().manual_seed(0))
    model.to(dev).eval()
    frames = torch.rand((BS, 4 + STEPS, H, W, 3), generator=gen,
                        device=dev) * 2 - 1
    calibrate_batchnorm(model, frames[:, 0:4])
    plain = TswinPlus(num_classes=12, swin_dim=512, swin_depths=(3, 3),
                      dtype=bf16, input_hw=(H, W), kernels=False)
    plain.load_state_dict(model.state_dict())
    plain.to(dev).eval()
    seg = StreamingSegmenter(model, out_hw=OUT_HW)
    wrappers = {"swin_block_attention": swin_block_attention,
                "swin_block_epilogue": swin_block_epilogue,
                "patch_merge": patch_merge,
                "upsample_argmax": upsample_argmax}

    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    cache, pred = seg.init_and_predict(frames[:, 0:4])
    preds = [pred]
    step_s = []
    for i in range(4, 4 + STEPS):
        ts = time.perf_counter()
        cache, pred = seg.predict_next(cache, frames[:, i])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - ts)
        preds.append(pred)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    print(f"  main-path launches: {launches}", flush=True)
    for k, n in launches.items():
        check(n > 0, f"{k} was never launched on the serving path")
    steady = step_s[2:]
    fps = BS * len(steady) / sum(steady)
    print(f"  steady-state predict_next: {fps:.2f} frames/s at bs {BS} "
          f"({1e3 * statistics.median(steady):.2f} ms/step median, "
          f"{len(steady)} steps) on {smi}", flush=True)

    for p in preds:
        check(p.shape == (BS, *OUT_HW) and p.dtype == torch.int32,
              f"prediction {p.shape} {p.dtype}")
        check(int(p.min()) >= 0 and int(p.max()) < 12, "class out of range")
    stream_shares, plain_shares = [], []
    with torch.inference_mode():
        for k, p in enumerate(preds):
            clip = frames[:, k:k + 4]
            full = composed_upsample_argmax_cf(
                model(clip, head_res_logits=True), (H, W), OUT_HW)
            stream_shares.append((p == full).float().mean().item())
            if k in (0, len(preds) - 1):
                ref = composed_upsample_argmax_cf(
                    plain(clip, head_res_logits=True), (H, W), OUT_HW,
                    kernels=False)
                plain_shares.append((full == ref).float().mean().item())
        classes = torch.bincount(preds[-1].flatten(), minlength=12)
    print(f"  streamed == full clip (kernel route): "
          f"min {min(stream_shares):.6f} of pixels over {len(preds)} frames",
          flush=True)
    print(f"  kernel route == plain route: {plain_shares} of pixels",
          flush=True)
    print(f"  last-frame class histogram: {classes.tolist()}", flush=True)
    check(min(stream_shares) >= TOL_STREAM_SHARE,
          f"streamed vs full clip {min(stream_shares)} < {TOL_STREAM_SHARE}")
    check(min(plain_shares) >= TOL_PLAIN_SHARE,
          f"kernel vs plain route {min(plain_shares)} < {TOL_PLAIN_SHARE}")
    print(f"phase 3 serve: {time.perf_counter() - t0:.1f} s", flush=True)

    meta = {
        "swin_block_attention": ("block_attention.cu",
                                 "stswincl_tpu/ops/pallas_block_attention.py:320"),
        "swin_block_epilogue": ("epilogue.cu",
                                "stswincl_tpu/ops/pallas_add_ln_mlp.py:895"),
        "patch_merge": ("patch_merge.cu",
                        "stswincl_tpu/ops/pallas_patch_merge.py:122"),
        "upsample_argmax": ("upsample_argmax.cu",
                            "stswincl_tpu/ops/pallas_upsample_argmax.py:53"),
    }
    rows = []
    for k, (src, replaces) in meta.items():
        cases = results[k]
        rows.append({
            "name": k, "route": "cuda",
            "source": f"stswincl_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": launches[k],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": sum(c["ms"] for c in cases),
            "plain_ms": sum(c["plain_ms"] for c in cases),
            "cases": cases})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
