#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`stswincl_tpu_torch`) once on one GPU.

    python3 chip_smoke.py

Phases (each prints its seconds; any failure raises and exits non-zero):
  1. build the hand-written CUDA kernels from `stswincl_tpu_torch/csrc/`;
  2. hold each forward kernel against its plain PyTorch twin at the
     serving path's full-width shapes, in bf16 (K4 also in `exact` fp32),
     and time both with CUDA events;
  2b. hold the backward kernels (K5 attention, K6 epilogue) and K2's
     `m` output against their twins at the full-width training shapes
     (batch 8), every output within TOL_REL, and time both;
  3. serve: TswinPlus(num_classes=12, swin_dim=512, depths (3, 3), bf16)
     with seeded random weights (BatchNorm statistics calibrated on the
     first clip) through StreamingSegmenter at 512x640 ->
     1024x1280, bs 2, `init_and_predict` then `predict_next` frames; the
     streamed predictions are held against the full-clip kernel route and
     the plain route, and every kernel must have launched;
  4. train: the stage-1 step (`SegTrainConfig` defaults: Adam 3e-4, OHEM
     0.7, batch 8) of the same model from seeded weights on seeded clips
     with blocky labels: (a) one step on the kernel route and one on the
     plain route, held against each other; (b) ten kernel-route steps on
     the repeated batch, every loss finite, the last below the first, and
     each kernel launched as often as the model's block calls imply;
     (c) the median ms/step of steps 4-10, clips/s and peak memory.

The line before the last is a JSON object with each kernel's launches
on the two main paths (serve, train), error and times; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import functools
import json
import math
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
# train: the kernel route against the plain route after one step
TOL_TRAIN_LOSS = 1e-2     # relative
TOL_GRAD_COS = 0.99       # cosine of each parameter's gradient
TOL_STATS = 1e-2          # relative, each updated BatchNorm statistic
TRAIN_STEPS = 10


def seeded_batch(batch: int, seed: int):
    """Seeded clips (batch, 4, H, W, 3) and blocky labels (batch, H, W):
    one class in [-1, 12) per 64x64 block (-1 ignored), each class drawn
    in its own colour under noise. Frames that differ in content give the
    batch statistics of the model's BatchNorms something to measure: on
    noise alone every image pools to nearly the same features, and the
    ASPP image-pool BatchNorm (one value per image and channel) then
    divides bf16 rounding by a near-zero variance."""
    import numpy as np
    rng = np.random.default_rng(seed)
    blocks = rng.integers(-1, 12, (batch, H // 64, W // 64))
    labels = np.repeat(np.repeat(blocks, 64, axis=1), 64, axis=2)
    palette = rng.uniform(-1.0, 1.0, (13, 3))  # row 12: the ignored label
    noise = rng.standard_normal((batch, 4, H, W, 3)) * 0.3
    images = (palette[labels][:, None] + noise).astype(np.float32)
    return images, labels.astype(np.int32)


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

    # ---- phase 2b: backward kernels against their twins -----------------
    t0 = time.perf_counter()
    from stswincl_tpu_torch.ops import add_ln_mlp as epi_ops
    from stswincl_tpu_torch.ops import block_attention as attn_ops

    def compare_outputs(kname, case, kfn, pfn, names):
        got, want = kfn(), pfn()
        torch.cuda.synchronize()
        rels, max_abs = {}, 0.0
        for n, a, b in zip(names, got, want):
            check(a.shape == b.shape, f"{kname} {case} {n}: {a.shape} vs "
                  f"{b.shape}")
            d = a.float() - b.float()
            rels[n] = (d.norm() / b.float().norm()).item()
            max_abs = max(max_abs, d.abs().max().item())
        row = {"case": case, "max_abs_err": max_abs,
               "rel_err": max(rels.values()), "rel_errs": rels,
               "ms": median_ms(kfn), "plain_ms": median_ms(pfn)}
        results.setdefault(kname, []).append(row)
        print(f"  {kname:24s} {case:44s} max rel {row['rel_err']:.3e} "
              f"kernel {row['ms']:.3f} ms plain {row['plain_ms']:.3f} ms",
              flush=True)
        print("      " + " ".join(f"{n} {r:.2e}" for n, r in rels.items()),
              flush=True)
        for n, r in rels.items():
            check(r <= TOL_REL, f"{kname} {case} {n}: relative error {r} > "
                  f"{TOL_REL}")
        torch.cuda.empty_cache()

    TB = 8  # the stage-1 training batch: two-group layers fold to 2 * TB
    attn_names = ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias")
    epi_names = ("dx", "dy", "ds2", "db2", "dw1", "db1", "dw2", "dbw2",
                 "ds1", "db1n")
    for s, cfg in stage.items():
        C, h, w, ws = cfg["C"], cfg["h"], cfg["w"], cfg["ws"]
        heads, T = 4, 2
        TN = T * ws * ws
        x = randn(2 * TB, T, h, w, C)
        g = randn(2 * TB, T, h, w, C)
        wqkv, bqkv = (uniform(3 * C, C, fan_in=C),
                      uniform(3 * C, fan_in=C, dtype=torch.float32))
        wproj, bproj = (uniform(C, C, fan_in=C),
                        uniform(C, fan_in=C, dtype=torch.float32))
        bias = randn(heads, TN, TN, scale=0.02, dtype=torch.float32)
        for shift in (0, ws // 2):
            mask = None
            if shift:
                mask = torch.from_numpy(shifted_window_attention_mask(
                    h, w, ws, shift)).repeat(1, T, T).to(dev)
            fwd = (x, wqkv, bqkv, wproj, bproj, bias, mask, heads,
                   (C // heads) ** -0.5, ws, shift)
            _, qkv, attn = attn_ops._forward_kernel(*fwd)
            compare_outputs(
                "swin_block_attention_bwd",
                f"stage{s} {tuple(x.shape)} shift={shift}",
                lambda: attn_ops.swin_block_attention_bwd(
                    x, g, qkv, attn, wqkv, wproj, bias, mask, *fwd[7:]),
                lambda: attn_ops.swin_block_attention_bwd_ref(
                    *fwd[:7], g, *fwd[7:]), attn_names)
            del qkv, attn
        hidden = 4 * C
        epi_w = (1.0 + randn(C, scale=0.1, dtype=torch.float32),
                 randn(C, scale=0.1, dtype=torch.float32),
                 uniform(hidden, C, fan_in=C),
                 uniform(hidden, fan_in=C, dtype=torch.float32),
                 uniform(C, hidden, fan_in=hidden),
                 uniform(C, fan_in=hidden, dtype=torch.float32),
                 1.0 + randn(C, scale=0.1, dtype=torch.float32),
                 randn(C, scale=0.1, dtype=torch.float32))
        y = randn(2 * TB, T, h, w, C)
        with_m = epi_ops.mlp_output_saved(C, hidden, bf16)
        for shift in (0, ws // 2):
            kw = dict(gelu_exact=True, shift=shift, ws=ws)
            m = (epi_ops._forward_kernel(x, y, *epi_w, **kw, eps=1e-5,
                                         with_m=True)[1] if with_m else None)
            compare_outputs(
                "swin_block_epilogue_bwd",
                f"stage{s} {tuple(x.shape)} shift={shift} "
                + ("m saved" if with_m else "m recomputed"),
                lambda: epi_ops.swin_block_epilogue_bwd(
                    x, y, g, m, *epi_w[:7], **kw),
                lambda: epi_ops.swin_block_epilogue_bwd_ref(
                    x, y, *epi_w, g, **kw), epi_names)
            del m
        if with_m:
            kw = dict(gelu_exact=True, shift=0, ws=ws)
            compare_outputs(
                "swin_block_epilogue", f"stage{s} {tuple(x.shape)} m output",
                lambda: epi_ops._forward_kernel(x, y, *epi_w, **kw, eps=1e-5,
                                                with_m=True),
                lambda: epi_ops.swin_block_epilogue_with_m_ref(x, y, *epi_w,
                                                               **kw),
                ("out", "m"))
        del x, y, g
    torch.cuda.empty_cache()
    print(f"phase 2b backward kernels vs plain: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

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
                "upsample_argmax": upsample_argmax,
                "swin_block_attention_bwd": attn_ops.swin_block_attention_bwd,
                "swin_block_epilogue_bwd": epi_ops.swin_block_epilogue_bwd}
    serve_kernels = ("swin_block_attention", "swin_block_epilogue",
                     "patch_merge", "upsample_argmax")

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
    serve_launches = {k: fn.launches for k, fn in wrappers.items()}
    print(f"  serving-path launches: {serve_launches}", flush=True)
    for k in serve_kernels:
        check(serve_launches[k] > 0,
              f"{k} was never launched on the serving path")
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
    del model, plain, seg, cache, frames, preds
    torch.cuda.empty_cache()

    # ---- phase 4: train ---------------------------------------------------
    t0 = time.perf_counter()
    train_launches = phase_train(dev, bf16, smi, wrappers)
    print(f"phase 4 train: {time.perf_counter() - t0:.1f} s", flush=True)

    meta = {
        "swin_block_attention": (
            "block_attention.cu",
            "stswincl_tpu/ops/pallas_block_attention.py:320"),
        "swin_block_epilogue": (
            "epilogue.cu", "stswincl_tpu/ops/pallas_add_ln_mlp.py:895 "
            "(and :1012 shifted, :802 with m)"),
        "patch_merge": ("patch_merge.cu",
                        "stswincl_tpu/ops/pallas_patch_merge.py:122"),
        "upsample_argmax": ("upsample_argmax.cu",
                            "stswincl_tpu/ops/pallas_upsample_argmax.py:53"),
        "swin_block_attention_bwd": (
            "block_attention.cu",
            "stswincl_tpu/ops/pallas_block_attention.py:547"),
        "swin_block_epilogue_bwd": (
            "epilogue.cu", "stswincl_tpu/ops/pallas_add_ln_mlp.py:310 "
            "(and :557 with m)"),
    }
    rows = []
    for k, (src, replaces) in meta.items():
        cases = results[k]
        by_path = {"serve": serve_launches[k],
                   "train": train_launches[k]}
        rows.append({
            "name": k, "route": "cuda",
            "source": f"stswincl_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": sum(c["ms"] for c in cases),
            "plain_ms": sum(c["plain_ms"] for c in cases),
            "cases": cases})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def gpu_clocks() -> str:
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def phase_train(dev, bf16, smi, wrappers) -> dict:
    """Phase 4. Returns the train path's kernel launches by wrapper."""
    import torch
    import torch.utils.checkpoint
    from stswincl_tpu.configs import SegTrainConfig
    from stswincl_tpu_torch.models import TswinPlus
    from stswincl_tpu_torch.models.aspp import ConvBNRelu
    from stswincl_tpu_torch.models.init import init_weights
    from stswincl_tpu_torch.models.swin import (PatchMerging,
                                                SpaceTimeSwinBlock)
    from stswincl_tpu_torch.pipelines.seg import make_tx
    from stswincl_tpu_torch.train.train_seg import make_seg_train_step

    cfg = SegTrainConfig()  # stage 1: Adam 3e-4 constant, OHEM 0.7
    TB = cfg.data.batch_size
    kw = dict(num_classes=cfg.model.num_classes, swin_dim=cfg.model.swin_dim,
              num_heads=cfg.model.num_heads,
              swin_depths=tuple(cfg.model.swin_depths),
              gelu_exact=cfg.model.gelu_exact, dtype=bf16, input_hw=(H, W))
    model = init_weights(TswinPlus(**kw), torch.Generator().manual_seed(0))
    init_state = {k: v.clone() for k, v in model.state_dict().items()}
    model.to(dev)
    images, labels = seeded_batch(TB, seed=3)
    images = torch.from_numpy(images).to(dev)
    labels = torch.from_numpy(labels).to(dev).long()
    print(f"  TswinPlus {kw}, batch {TB}, clips {tuple(images.shape)}",
          flush=True)

    def new_step(m, steps_per_epoch):
        opt, schedule = make_tx(cfg, steps_per_epoch, m)
        return make_seg_train_step(m, opt, schedule, cfg.loss,
                                   ohem_thresh=cfg.ohem_thresh), opt

    def one_step(m):
        step, opt = new_step(m, 1)
        grads = {}
        opt.register_step_pre_hook(lambda *_: grads.update(
            {n: p.grad.detach().clone() for n, p in m.named_parameters()}))
        ts = time.perf_counter()
        metrics = step(images, labels)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        stats = {n: b.detach().clone() for n, b in m.named_buffers()
                 if n.endswith(("running_mean", "running_var"))}
        return loss, grads, stats, time.perf_counter() - ts

    # (a) one step on each route from the same weights and batch; the
    # plain route recomputes each swin block in its backward
    # (torch.utils.checkpoint, same numbers) so its twins' fp32
    # intermediates fit the card at batch 8
    torch.cuda.reset_peak_memory_stats()
    loss_k, grads_k, stats_k, sec_k = one_step(model)
    plain = TswinPlus(**kw, kernels=False)
    plain.load_state_dict(init_state)
    plain.to(dev)
    for mod in plain.modules():
        if isinstance(mod, SpaceTimeSwinBlock):
            mod.forward = functools.partial(torch.utils.checkpoint.checkpoint,
                                            mod.forward, use_reentrant=False)
    loss_p, grads_p, stats_p, sec_p = one_step(plain)
    del plain
    torch.cuda.empty_cache()
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"  (a) loss kernel route {loss_k:.6f} plain route {loss_p:.6f} "
          f"(rel {loss_rel:.2e}); step {sec_k:.2f} s / {sec_p:.2f} s",
          flush=True)
    check(loss_rel <= TOL_TRAIN_LOSS, f"train loss rel {loss_rel}")
    # a conv bias that feeds a train-mode BatchNorm has a zero gradient in
    # exact arithmetic (the BatchNorm removes the channel mean): both
    # routes hold rounding noise there, so it is held to a norm bound
    zero_grad = {f"{n}.conv.bias" for n, mod in model.named_modules()
                 if isinstance(mod, ConvBNRelu)}
    top = max(g.float().norm().item() for g in grads_p.values())
    cosines = {}
    for n, gp in grads_p.items():
        gk = grads_k[n].float()
        gp = gp.float()
        if n in zero_grad:
            for route, gr in (("kernel", gk), ("plain", gp)):
                check(gr.norm().item() <= 1e-3 * top, f"{n} ({route}): "
                      f"gradient norm {gr.norm().item()} of a zero-gradient "
                      f"parameter against {top}")
            continue
        cosines[n] = (gk.flatten() @ gp.flatten()
                      / (gk.norm() * gp.norm())).item()
    worst = sorted(cosines.items(), key=lambda kv: kv[1])[:5]
    print(f"  (a) gradient cosine, {len(cosines)} parameters: min "
          f"{worst[0][1]:.5f} ({worst[0][0]}); lowest five {worst}; "
          f"{len(zero_grad)} zero-gradient conv biases below 1e-3 of the "
          f"largest gradient norm ({top:.3e})", flush=True)
    for n, c in cosines.items():
        check(c >= TOL_GRAD_COS, f"gradient cosine of {n}: {c}")
    stat_rel = {n: ((stats_k[n] - b).norm() / b.norm()).item()
                for n, b in stats_p.items()}
    worst_stat = max(stat_rel.items(), key=lambda kv: kv[1])
    print(f"  (a) BatchNorm statistics after the step: max rel "
          f"{worst_stat[1]:.2e} ({worst_stat[0]}) over {len(stat_rel)}",
          flush=True)
    check(worst_stat[1] <= TOL_STATS, f"BN statistic {worst_stat}")
    peak_a = torch.cuda.max_memory_allocated()
    del grads_k, grads_p

    # (b) ten kernel-route steps on the repeated batch: the train main path
    model.load_state_dict(init_state)
    step, _ = new_step(model, TRAIN_STEPS)
    calls = {"block": 0, "merge": 0}

    def counter(key):
        def hook(*_):
            calls[key] += 1
        return hook
    hooks = [mod.register_forward_hook(counter(
        "block" if isinstance(mod, SpaceTimeSwinBlock) else "merge"))
        for mod in model.modules()
        if isinstance(mod, (SpaceTimeSwinBlock, PatchMerging))]
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clocks = [gpu_clocks()]
    losses, events, host_s = [], [], []
    for _ in range(TRAIN_STEPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        ts = time.perf_counter()
        a.record()
        metrics = step(images, labels)
        b.record()
        losses.append(metrics["loss"])
        events.append((a, b))
        host_s.append(time.perf_counter() - ts)
    torch.cuda.synchronize()
    clocks.append(gpu_clocks())
    launches = {k: fn.launches for k, fn in wrappers.items()}
    for h in hooks:
        h.remove()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    step_ms = [a.elapsed_time(b) for a, b in events]
    print(f"  (b) losses {[round(v, 5) for v in losses]}", flush=True)
    print(f"  (b) train-path launches {launches}; swin block calls "
          f"{calls['block']}, patch merges {calls['merge']}", flush=True)
    check(all(math.isfinite(v) for v in losses), "non-finite train loss")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for k in ("swin_block_attention", "swin_block_epilogue",
              "swin_block_attention_bwd", "swin_block_epilogue_bwd"):
        check(launches[k] == calls["block"], f"{k}: {launches[k]} launches "
              f"for {calls['block']} swin block calls")
    check(launches["patch_merge"] == calls["merge"],
          f"patch_merge: {launches['patch_merge']} for {calls['merge']}")

    # (c) steady state
    med = statistics.median(step_ms[3:])
    print(f"  (c) {med:.2f} ms/step median of steps 4-10 (CUDA events; "
          f"host {1e3 * statistics.median(host_s[3:]):.2f} ms), "
          f"{TB / (med / 1e3):.2f} clips/s at batch {TB}, peak "
          f"{peak / 2**30:.2f} GiB allocated (route comparison "
          f"{peak_a / 2**30:.2f} GiB) on {smi}", flush=True)
    print(f"  (c) step ms {[round(v, 1) for v in step_ms]}; SM clock, "
          f"power draw, temperature before / after the steps: {clocks}",
          flush=True)
    return launches


if __name__ == "__main__":
    main()
