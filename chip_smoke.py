#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`stswincl_tpu_torch`) once on one GPU.

    python3 chip_smoke.py

Phases (each prints its seconds). A failed check is printed and the run
goes on, so every phase is driven and measured; the script then prints the
`kernels` line and exits non-zero without the last line. An error that
stops a phase exits non-zero at once:
  1. build the hand-written CUDA kernels from `stswincl_tpu_torch/csrc/`;
  2. hold each forward kernel against its plain PyTorch twin at the
     serving path's full-width shapes, in bf16 (K4 also in `exact` fp32),
     and time both with CUDA events; K1's weights and relative bias drawn
     so that its output is about as large as x; planted faults in the
     twins (K1 without its relative bias and at the wrong shift, K2 at
     the wrong shift, K3 with its 2x2 gather order swapped) must miss the
     bound tenfold. K1 and K2 also at the block shapes of stage-2
     pretraining (one view at batch 4, 256x448: (8, 2, 32, 56, 512) and
     (4, 2, 16, 28, 1024), `CONTRAST_STAGE`). K3 also at the stage-1
     training shape (32, 64, 80, 512) and the stage-2 one (16, 32, 56,
     512), and its backward (`PatchMergeFn`: bf16 products) at both
     against autograd of the fp32 twin, each gradient's cosine >= 0.99 and
     relative error <= 1e-2. K4 on the composed EndoVis matrices and on a
     dense random pair of the same shapes (full-row spans), each within
     TOL_K4_SHARE of its twin; its bound counts the nonzero products of
     the matrices' spans; two planted faults in its twin (the column
     matrix shifted by one output column, every span missing its last
     tap) must drop the share of equal pixels to 0.99 or below. K3 and K4
     also record `device_ms`, the mean of back-to-back calls;
  2b. hold the backward kernels (K5 attention, K6 epilogue) and K2's
     `m` output against their twins at the full-width training shapes
     (batch 8, and the stage-2 pretraining shapes of phase 2), every output
     within TOL_REL, and time both; planted
     faults: K5's twin without dbias and with the softmax backward's
     row-sum term dropped (dS = P * dP), K6's without the LN2 path and
     with gelu' taken as 1 (dpre = dh);
  2c. hold the attention kernels of the `attn_impl` routes 'pallas' (row
     10, image-layout qkv) and 'pallas_windows' (row 11, partitioned q, k,
     v) against their twins at the full-width stage-1 and stage-2 window
     shapes of the serving batch, with and without the SW-MSA mask, and
     time both; planted fault: each twin without the mask;
  2f. the Hopper GEMMs alone (`ops.gemm`: `linear_sm90`, K6's fused
     pair `gelu_bwd_sm90`, the weight gradients `wgrad_sm90`) at K1's and
     K2's products of the serving shapes and K5's and K6's input- and
     weight-gradient products at both training stages, through
     `tools.profile_gemm.main`: each held within 1e-2 of its twin and
     timed beside torch.matmul on the same operands (TFLOP/s, share of
     the bf16 peak);
  3. serve: TswinPlus(num_classes=12, swin_dim=512, depths (3, 3), bf16)
     with seeded random weights (BatchNorm statistics calibrated on the
     first clip) through StreamingSegmenter at 512x640 ->
     1024x1280, bs 2, `init_and_predict` then `predict_next` frames; the
     streamed predictions are held against the full-clip kernel route and
     the plain route, and every kernel must have launched;
  3b. serve the weights of phase 3 on each of those two routes: streamed
     == full clip, kernel route == plain route and route == the phase-3
     ('pallas_full') route on their shares of pixels, the route's kernel
     launched and K1 not, frames/s;
  4. train: the stage-1 step (`SegTrainConfig` defaults: Adam 3e-4, OHEM
     0.7, batch 8) of the same model from seeded weights on seeded clips
     with blocky labels: (a) one step on the kernel route and one on the
     plain route, held against each other, each gradient cosine at or
     above TOL_GRAD_COS_FLOOR (the control's too) but those behind a
     BatchNorm of at most BN_FEW_VALUES values a channel (the ASPP image
     pool), and each 1 - cosine within TOL_NOISE_FACTOR of that of a
     control route ('pallas_windows') on the same batch; a planted fault
     (the plain route's image-pool BatchNorm on its running statistics)
     must lift the image pool's gradients tenfold over that bound; (b) ten
     kernel-route steps on
     the repeated batch, every loss finite, the last below the first, and
     each kernel launched as often as the model's block calls imply;
     (c) the median ms/step of steps 4-10, clips/s and peak memory.
  2d. hold the whole-block kernel (Pallas row 16) against its twin at
     the full-width serving and batch-8 training shapes of both stages,
     with weights drawn so that the attention branch is as large as x
     (planted faults: a twin without its relative bias, and at stage 2
     one whose attention skips the last window of each 128-row tile,
     must miss the bound tenfold), print its largest difference from the
     K1 + K2 pair with m rounded, hold the library's GEMM counts at 0
     over its calls, its backward at the training shapes (through its
     autograd Function: K1, K2, K6 and K5) against the twin's autograd,
     and time it in single calls and back to back (`device_ms`) beside
     the K1 + K2 pair on the same inputs; hold rows 13 (add + LN + MLP,
     two bf16-form Hopper GEMM launches a call, counted) and 14 (add +
     LN) against their twins at the kernel profiler's shapes, timed in
     single calls and back to back, row 13 beside PyTorch's add,
     F.layer_norm and three MLP calls;
  3c. serve the weights of phase 3 with `whole_block=True`: streamed ==
     full clip, kernel route == plain route and == the phase-3 route on
     their shares of pixels, row 16 launched once per W-MSA block call (7
     a `predict_next`) and K1 / K2 once per SW-MSA block call, frames/s;
  4e. train with `whole_block=True` from the phase-4 weights on the
     phase-4d batch: one step against the plain route to the phase-4
     bounds, each gradient's 1 - cosine also within TOL_NOISE_FACTOR of
     that of a control on the same batch: the same route with row 16's
     function on the pair's kernels (`whole_swin_block_pair` with m
     rounded: K1, K2's m-output form, K6 taking that m, K5; its plain
     route is 4e's own), itself held to the absolute floor. Then five
     steps: falling losses, ms/step, peak memory, row 16 launched once per
     W-MSA block call, K1, K2, K5 and K6 once per block call (the W-MSA
     backward recomputes the pair). Both 4e runs are also printed (not
     held) against the 4d control, which adds the fp32 m at stage 1;
  2e. hold rows 12 (the MLP, erf and tanh), 15 (LayerNorm) and 17 (the
     dilated conv + folded BN + residual + ReLU) against their twins at
     full width: row 12 at the batch-8 block shapes of both stages beside
     cuBLAS's F.linear -> F.gelu -> F.linear, both timed in single calls
     and back to back, its two bf16-form Hopper GEMM launches a call
     counted by the library; row 15 at (163840, 512),
     (40960, 1024) and (40960, 2048) beside F.layer_norm; row 17 at three
     of the conv profiler's shapes and at the serving ASPP's dilated
     branches, 1024 -> 512 at dilation 12 and 18 on the model's (2, 32,
     40) and on (2, 64, 80), beside cuDNN's channels_last conv with the
     BN folded in and the model's own cuDNN call; rows 15 and 17 (and
     their library calls) timed in single calls and back to back
     (`device_ms`); row 17 runs on the Hopper GEMM's "conv" form, whose
     launches the library counts, held equal to row 17's own; scale and
     shift drawn away from 1 and 0, and a twin with a planted fault (row
     15 without its bias, row 17 with the dilation one off, with w
     flipped along kx or without its residual) must miss the bound
     tenfold;
  5. run the kernel profiler's entry point
     (`stswincl_tpu_torch.tools.profile_swin_kernels.main`) with few
     repeats: K1, K2, the attention step, rows 13 and 14 at the batch-8
     block shapes;
  6. drive the entry points of rows 12, 15 and 17: the `Mlp` module at
     the stage-1 width and `FusedLayerNorm`, each forward without and
     with autograd (then backward), held against their plain routes (the
     module's forward then timed back to back beside cuBLAS's three
     calls), and
     the conv profiler (`tools.profile_conv_kernel.main`) with few
     repeats; one row-12 or row-15 launch a module forward, one row-17
     launch a kernel call of the profiler;
  7. fp32: `build_model(ModelConfig(dtype="float32"))` (the plain twins:
     the kernels take bf16 only) serves `init_and_predict` +
     `predict_next` at full width, bs 2, and takes one stage-1 train step
     at batch 2: predictions in [0, 12), a finite loss, no kernel
     launched;
  8. stage-2 pretraining at full width (`ContrastEncoder`, batch 4, six
     views of 4 frames at 256x448, `ContrastTrainConfig`'s LARS and EMA):
     (a) one step on the kernel route against one on the plain route and
     the control route 'pallas_windows' (`contrast_gates`: loss, every
     gradient's 1 - cosine against the control's, a floor at
     TOL_CONTRAST_GRAD_COS_FLOOR, both branches' BatchNorm statistics,
     the EMA and the momentum); (b) `run_contrast_pretraining` for one
     epoch of 8 steps: finite losses, the checkpoint read back equal to
     the state, each kernel launched once per block call it serves,
     ms/step, samples/s and peak memory (`phase_contrast`).

Each main path (serve and train on each route, the profilers, the
modules) is driven with every launch count set to 0 just before it and
read just after. K1-K3, K5, K6, rows 12, 13 and 17 launch the Hopper
GEMMs from C: the library counts those launches by form where it makes
them, and each path holds them exactly to what the kernels' own launches
imply (on a train path, with the blocks whose m is saved); row 16 runs
its products inside its one launch and adds none. Then
come three lines: a JSON object with each kernel's launches by path,
error, times and the least time the card could take for the same work
(`bound_ms`: the larger of the operations over the dense peak for their
type and the bytes over 3.35 TB/s, each input read and each output
written once); the card's name and power limit (`nvidia-smi`); and, last,
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time
import unittest.mock

TOL_REL = 1e-2        # K1-K3: ||kernel - plain|| / ||plain||
TOL_K4_SHARE = 0.999  # K4: share of equal pixels
TOL_K3_BWD_COS = 0.99  # K3's backward: each gradient's cosine to the fp32 twin
TOL_STREAM_SHARE = 0.999  # streamed vs full-clip kernel route
TOL_PLAIN_SHARE = 0.98    # kernel route vs plain route (bf16 rounding)
BS, H, W, OUT_HW, STEPS = 2, 512, 640, (1024, 1280), 10
# train: the kernel route against the plain route after one step
TOL_TRAIN_LOSS = 1e-2     # relative
TOL_GRAD_COS = 0.99       # gradient cosines below it are printed
# every gradient cosine, of a control run too, is held at or above this
# floor, but those behind a BatchNorm of at most BN_FEW_VALUES values a
# channel (held to the control's 1 - cosine only): on batches 1-9 sound
# routes then read 0.98807 at their lowest (PERF.md), so the floor keeps a
# margin over bf16 noise and fails what the printed 0.99 misses widely
TOL_GRAD_COS_FLOOR = 0.98
TOL_STATS = 1e-2          # relative, each updated BatchNorm statistic
# phases 4, 4d and 4e hold each gradient's 1 - cosine against that of a
# sound control route on the same batch: at most TOL_NOISE_FACTOR times
# the control's plus TOL_NOISE_FLOOR (a factor 4 on 1 - cos is a factor 2
# on the relative error; the floor is a relative error of 0.45 %)
TOL_NOISE_FACTOR = 4.0
TOL_NOISE_FLOOR = 1e-5
TRAIN_STEPS = 10
ROUTE_TRAIN_STEPS = 5  # phases 4d and 4e
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12  # H100 SXM, dense
# Phases 4d and 4e train on a second seeded batch. On the phase-4 batch
# the gradient of the stem BatchNorm bias (64 values summed over 2.6M
# positions) sits at this check's bf16 noise floor on the other routes:
# cosine 0.9894-0.9904 between the kernel and plain routes of 'pallas'
# and 'pallas_windows', 0.9882 with `whole_block`, 0.986 between two
# kernel routes, where 'pallas_full' gives 0.9907-0.9915 (PERF.md).
ROUTE_TRAIN_SEED = 4
# phase 8, stage-2 pretraining: `ContrastTrainConfig`'s batch of 4 samples,
# each six views of 4 frames at 256x448 (feature maps 32x56 and 16x28)
CONTRAST_BATCH, CONTRAST_HW = 4, (256, 448)
CONTRAST_STEPS = 8   # an epoch of the synthetic contrast set (32 samples)
CONTRAST_SEED = 7    # phase 8 (a)'s batch
# phase 8 (a)'s gradient-cosine floor: the contrast step's gradients that
# sum over every token (biases, LayerNorm and relative-bias tables) sit
# lower than stage 1's, at the bf16 noise of the class-sum loss, whose
# per-pixel pulls cancel in those sums: the kernel and control routes read
# 0.93207-0.96841 at their lowest on batches 1-9 (`route_gate_seeds.py
# --contrast`, PERF.md), so a floor of 0.9 keeps 1.47x of the lowest
# 1 - cosine as margin; the relative gate against the control route is the
# finer check
TOL_CONTRAST_GRAD_COS_FLOOR = 0.9
CONTRAST_HW8 = (CONTRAST_HW[0] // 8, CONTRAST_HW[1] // 8)
# the block shapes of one view on that path (a view's forward at batch 4):
# a two-group stage-1 layer folds both groups into the batch, (8, 2, 32,
# 56, 512); every stage-2 block call takes one group (`final_pair_only`
# splits the first stage-2 layer), (4, 2, 16, 28, 1024)
CONTRAST_STAGE = {
    "c1": dict(C=512, h=CONTRAST_HW8[0], w=CONTRAST_HW8[1], ws=8,
               n=2 * CONTRAST_BATCH, label="contrast s1"),
    "c2": dict(C=1024, h=CONTRAST_HW8[0] // 2, w=CONTRAST_HW8[1] // 2, ws=4,
               n=CONTRAST_BATCH, label="contrast s2")}


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


FAILED = []  # the message of each failed check, in order


def check(cond: bool, msg: str) -> None:
    """Record a failed check and go on; `main` exits non-zero at its end
    if any failed."""
    if not cond:
        FAILED.append(msg)
        print(f"  CHECK FAILED: {msg}", flush=True)


def rel_err(got, want) -> float:
    """||got - want|| / ||want||, in fp32."""
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def max_rel_err(got, want) -> float:
    """The largest `rel_err` over matching outputs."""
    return max(rel_err(a, b) for a, b in zip(got, want))


def epilogue_bwd_without_ln2_path(x, y, s2, b2, w1, b1, w2, bw2, s1, b1n, g,
                                  gelu_exact=True, shift=0, ws=None,
                                  eps=1e-5):
    """K6's twin (autograd of the rounded-m epilogue) with a planted fault:
    LN2 normalises a detached s, so the gradient of x and y through the
    MLP branch is dropped."""
    import torch
    import torch.nn.functional as F
    from stswincl_tpu_torch.ops.add_ln_mlp import layer_norm_f32
    from stswincl_tpu_torch.ops.mlp import gelu
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_()
                  for t in (x, y, s2, b2, w1, b1, w2, bw2, s1, b1n)]
        x_, y_, s2_, b2_, w1_, b1_, w2_, bw2_, s1_, b1n_ = leaves
        ys = torch.roll(y_, (shift, shift), dims=(2, 3)) if shift else y_
        s32 = x_.float() + ys.float()
        n2 = layer_norm_f32(s32.detach(), s2_, b2_, eps).to(x.dtype)
        h = gelu(F.linear(n2.float(), w1_.float(), b1_.float()), gelu_exact)
        m = F.linear(h.to(x.dtype).float(), w2_.float(),
                     bw2_.float()).to(x.dtype)
        out = layer_norm_f32(s32 + m.float(), s1_, b1n_, eps).to(x.dtype)
        return torch.autograd.grad(out, leaves, g)


def epilogue_bwd_with_unit_gelu_grad(x, y, s2, b2, w1, b1, w2, bw2, s1, b1n,
                                     g, gelu_exact=True, shift=0, ws=None,
                                     eps=1e-5):
    """K6's twin with a planted fault: the GELU's derivative taken as 1
    (dpre = dh), what a fused epilogue that dropped its multiply by gelu'
    would give; the forward values are unchanged."""
    import torch
    import torch.nn.functional as F
    from stswincl_tpu_torch.ops.add_ln_mlp import layer_norm_f32
    from stswincl_tpu_torch.ops.mlp import gelu
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_()
                  for t in (x, y, s2, b2, w1, b1, w2, bw2, s1, b1n)]
        x_, y_, s2_, b2_, w1_, b1_, w2_, bw2_, s1_, b1n_ = leaves
        ys = torch.roll(y_, (shift, shift), dims=(2, 3)) if shift else y_
        s32 = x_.float() + ys.float()
        n2 = layer_norm_f32(s32, s2_, b2_, eps).to(x.dtype)
        pre = F.linear(n2.float(), w1_.float(), b1_.float())
        h = pre + (gelu(pre, gelu_exact) - pre).detach()
        m = F.linear(h.to(x.dtype).float(), w2_.float(),
                     bw2_.float()).to(x.dtype)
        out = layer_norm_f32(s32 + m.float(), s1_, b1n_, eps).to(x.dtype)
        return torch.autograd.grad(out, leaves, g)


def attention_bwd_without_rowsum(x, wqkv, bqkv, wproj, bproj, bias, mask, g,
                                 heads, scale, ws, shift=0):
    """K5's twin (autograd of K1's twin) with a planted fault: the
    softmax backward without its row-sum term, dS = P * dP in place of P *
    (dP - rowsum(dP * P)); the forward values are unchanged."""
    import torch
    import torch.nn.functional as F
    from stswincl_tpu_torch.ops.window import partition_qkv, reverse_windows

    class SoftmaxWithoutRowsum(torch.autograd.Function):
        @staticmethod
        def forward(ctx, scores):
            e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
            p = e * (1.0 / e.sum(dim=-1, keepdim=True))
            ctx.save_for_backward(p)
            return p

        @staticmethod
        def backward(ctx, dp):
            (p,) = ctx.saved_tensors
            return p * dp

    with torch.enable_grad():
        leaves = [t.detach().requires_grad_()
                  for t in (x, wqkv, bqkv, wproj, bproj, bias)]
        x_, wq, bq, wp, bp, bias_ = leaves
        B, T, H, W, _ = x.shape
        xs = torch.roll(x_, (-shift, -shift), dims=(2, 3)) if shift else x_
        qkv = F.linear(xs.float(), wq.float(), bq.float()).to(x.dtype)
        q, k, v = partition_qkv(qkv, heads, ws)
        Bw, _, TN, _ = q.shape
        sc = (q.float() @ k.float().transpose(-1, -2)) * scale
        sc = sc + bias_.float()[None]
        if mask is not None and mask.shape[0] > 1:
            nW = mask.shape[0]
            sc = (sc.reshape(Bw // nW, nW, heads, TN, TN)
                  + mask.float()[None, :, None]).reshape(Bw, heads, TN, TN)
        o = (SoftmaxWithoutRowsum.apply(sc).to(v.dtype).float()
             @ v.float()).to(v.dtype)
        attn = reverse_windows(o, B, T, H, W, ws)
        out = F.linear(attn.float(), wp.float(), bp.float()).to(x.dtype)
        return torch.autograd.grad(out, leaves, g)


def whole_block_without_last_window(x, params, cfg, windows_per_tile):
    """Row 16's twin with a planted fault of its tiling: the attention
    output of the last window of each tile of `windows_per_tile` windows
    (window order: image, then window rows, then columns) left at zero, as
    if the attention phase skipped it."""
    import torch
    import torch.nn.functional as F
    from stswincl_tpu_torch.ops.add_ln_mlp import (
        swin_block_epilogue_with_m_ref)
    from stswincl_tpu_torch.ops.block_attention import (
        windowed_attention_image_ref)
    heads, scale, ws = cfg
    wqkv, bqkv, wproj, bproj, bias, mask = params[:6]
    B, T, H, W, C = x.shape
    qkv = F.linear(x.float(), wqkv.float(), bqkv.float()).to(x.dtype)
    attn = windowed_attention_image_ref(qkv, bias, mask, heads, scale, ws)
    nWh, nWw = H // ws, W // ws
    win = (torch.arange(B, device=x.device)[:, None, None] * nWh * nWw
           + (torch.arange(H, device=x.device) // ws)[None, :, None] * nWw
           + (torch.arange(W, device=x.device) // ws)[None, None, :])
    last = (win % windows_per_tile == windows_per_tile - 1)[:, None, :, :,
                                                            None]
    attn = attn.masked_fill(last, 0)
    y = F.linear(attn.float(), wproj.float(), bproj.float()).to(x.dtype)
    return swin_block_epilogue_with_m_ref(x, y, *params[6:])[0]


def planted(kname: str, case: str, fault: str, moved: float) -> None:
    """A twin with a planted fault must miss the bound TOL_REL that its
    kernel is held to tenfold, or the check could not see that fault."""
    print(f"  {'':22s} {case:34s} the twin {fault} moves by rel "
          f"{moved:.3e}", flush=True)
    check(moved > 10 * TOL_REL, f"{kname} {case}: the twin {fault} "
          f"moves the output by only {moved}")


# the Hopper GEMM's rows of the `kernels` line -> the forms of
# `ops.gemm.launch_counts` that each counts
GEMM_ROWS = {"linear_sm90": ("bf16", "resid_f32", "gelu_grad", "dgelu", "f32"),
             "gelu_bwd_sm90": ("gelu_bwd",), "wgrad_sm90": ("wgrad",)}


# the attention kernel each route launches in place of K1
ROUTE_KERNEL = {"pallas_full": "swin_block_attention",
                "pallas": "windowed_attention_image",
                "pallas_windows": "fused_window_attention"}


def kernel_wrappers() -> dict:
    """Each row of the `kernels` line -> the wrapper whose `launches` the
    main paths read (the Hopper GEMM rows read the library's counts)."""
    from stswincl_tpu_torch.ops import (add_layernorm, add_ln_mlp,
                                        block_attention, conv, gemm,
                                        layernorm, mlp, patch_merge,
                                        swin_block, upsample_argmax)
    from stswincl_tpu_torch.ops.attention import fused_window_attention
    return {
        "swin_block_attention": block_attention.swin_block_attention,
        "swin_block_epilogue": add_ln_mlp.swin_block_epilogue,
        "patch_merge": patch_merge.patch_merge,
        "upsample_argmax": upsample_argmax.upsample_argmax,
        "swin_block_attention_bwd": block_attention.swin_block_attention_bwd,
        "swin_block_epilogue_bwd": add_ln_mlp.swin_block_epilogue_bwd,
        "windowed_attention_image": block_attention.windowed_attention_image,
        "fused_window_attention": fused_window_attention,
        "whole_swin_block": swin_block.whole_swin_block,
        "add_ln_mlp": add_ln_mlp.add_ln_mlp,
        "add_layer_norm": add_layernorm.add_layer_norm,
        "fused_mlp": mlp.fused_mlp,
        "fused_layer_norm": layernorm.fused_layer_norm,
        "conv3x3_bn_act": conv.conv3x3_bn_act,
        "linear_sm90": gemm.linear_sm90,
        "gelu_bwd_sm90": gemm.gelu_bwd_sm90,
        "wgrad_sm90": gemm.wgrad_sm90}


def reset_launches(wrappers) -> None:
    """Every kernel's launch count to 0, the library's GEMM counts too,
    with the card idle."""
    import torch
    from stswincl_tpu_torch.ops import gemm as gemm_ops
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    gemm_ops.launch_counts(reset=True)


def read_launches(wrappers) -> tuple:
    """(each kernel's launches since the reset, the library's GEMM counts
    by form). A kernel's count is its wrapper's; a Hopper GEMM row's is the
    library's, which also counts the launches made inside the C entries of
    K1, K2, K3, K5 and K6."""
    from stswincl_tpu_torch.ops import gemm as gemm_ops
    forms = gemm_ops.launch_counts()
    counts = {k: fn.launches for k, fn in wrappers.items()}
    for k, fs in GEMM_ROWS.items():
        if k in counts:
            counts[k] = sum(forms[f] for f in fs)
    return counts, forms


def check_gemm_launches(tag, counts, forms, m_saved=None) -> None:
    """The GEMM launches the library counted on a path against those that
    the kernels' own launches imply: K1 two bf16 products (qkv, proj); K2
    fc1 (bf16) and fc2 (bf16 m where the training forward saves it, else
    the fp32 residual); K3 one bf16 product (the 4C -> 2C reduction); K5
    two bf16 input-gradient products and two weight gradients; K6 dn2
    (f32) and two weight gradients, with m saved the fused pair, with m
    recomputed fc1 + gelu', m (bf16) and dh * gelu'; rows 12 and 13 two
    bf16 products (fc1, fc2); row 16 none (its products run inside its one
    launch); row 17 one "conv" product a call. `m_saved`: the block calls
    whose K2 saves m and whose K6 takes it (0 where nothing is trained;
    None where the path does not say)."""
    k1, k2 = counts["swin_block_attention"], counts["swin_block_epilogue"]
    k3 = counts["patch_merge"]
    k5 = counts["swin_block_attention_bwd"]
    k6 = counts["swin_block_epilogue_bwd"]
    mlps = counts["fused_mlp"] + counts["add_ln_mlp"]
    rules = [("bf16 + resid_f32", forms["bf16"] + forms["resid_f32"],
              2 * k1 + 2 * k2 + k3 + 2 * k5 + forms["gelu_grad"]
              + 2 * mlps),
             ("gelu_grad + gelu_bwd", forms["gelu_grad"] + forms["gelu_bwd"],
              k6),
             ("dgelu", forms["dgelu"], forms["gelu_grad"]),
             ("f32", forms["f32"], k6),
             ("wgrad", forms["wgrad"], 2 * (k5 + k6)),
             ("conv", forms["conv"], counts["conv3x3_bn_act"])]
    if m_saved is not None:
        rules += [("resid_f32", forms["resid_f32"], k2 - m_saved),
                  ("gelu_bwd", forms["gelu_bwd"], m_saved if k6 else 0)]
    print(f"  [{tag}] Hopper GEMM launches by form (counted in the library):"
          f" {forms}", flush=True)
    for what, got, want in rules:
        check(got == want, f"{tag}: {what} GEMM launches {got}, the kernels' "
              f"launches imply {want}")


def without_last_tap(m, spans):
    """m with the last nonzero of each row set to 0: the planted fault of
    a K4 that stops one tap short of every span."""
    import torch
    out = m.clone()
    live = spans[:, 1] > spans[:, 0]
    rows = torch.arange(m.shape[0], device=m.device)[live]
    out[rows, spans[live, 1].long() - 1] = 0.0
    return out


def phase_patch_merge_backward(x, params, randn, median_ms) -> dict:
    """K3's backward through `PatchMergeFn` at x's shape: x bf16, w an fp32
    parameter cast for the product (as the model holds it), against
    autograd of the fp32 twin on the same values; each gradient's cosine
    at or above TOL_K3_BWD_COS and its relative error within TOL_REL (the
    kernel route rounds n, dn and dW to bf16). Returns the case, the
    errors and the ms of one forward + backward on each route."""
    import torch
    from stswincl_tpu_torch.ops.patch_merge import (patch_merge,
                                                    patch_merge_ref)
    BT, H_, W_, C = x.shape
    g = randn(BT, H_ // 2, W_ // 2, 2 * C)
    scale, bias, w = params
    leaves = [x.clone().requires_grad_(), scale.clone().requires_grad_(),
              bias.clone().requires_grad_(), w.float().requires_grad_()]
    ref = [t.detach().float().requires_grad_() for t in leaves]

    def kernel_route():
        return torch.autograd.grad(patch_merge(*leaves), leaves, g)

    def twin():
        return torch.autograd.grad(patch_merge_ref(*ref), ref, g.float())

    row = {"case": f"{tuple(x.shape)} backward", "cosine": {},
           "rel_err": {}}
    for n, t, a, b in zip(("x", "scale", "bias", "w"), leaves,
                          kernel_route(), twin()):
        check(a.dtype == t.dtype, f"patch_merge backward: d{n} is {a.dtype}")
        a, b = a.float().flatten(), b.flatten()
        row["cosine"][n] = (a @ b / (a.norm() * b.norm())).item()
        row["rel_err"][n] = ((a - b).norm() / b.norm()).item()
    row["ms"], row["plain_ms"] = median_ms(kernel_route), median_ms(twin)
    print(f"  {'patch_merge':22s} {row['case']:34s} forward + backward "
          f"{row['ms']:.3f} ms (fp32 twin {row['plain_ms']:.3f} ms); "
          f"cosine {row['cosine']}; rel {row['rel_err']}", flush=True)
    for n in row["cosine"]:
        check(row["cosine"][n] >= TOL_K3_BWD_COS and row["rel_err"][n]
              <= TOL_REL, f"patch_merge backward d{n}: cosine "
              f"{row['cosine'][n]}, rel {row['rel_err'][n]}")
    return row


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16) -> dict:
    """The least time the card could take for `flops` operations at
    `peak` and `nbytes` of device memory traffic, and which bounds it."""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "ops_ms": ops_ms,
            "bytes_ms": bytes_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def attention_work(R: int, C: int, TN: int, heads: int, mask) -> tuple:
    """(flops, bytes) of window attention over R token rows of C channels
    in windows of TN tokens: QK^T and PV, q, k, v read, the output
    written, the bias and mask tables read."""
    tables = heads * TN * TN * 4 + (0 if mask is None else mask.numel() * 4)
    return 4 * R * TN * C, 4 * R * C * 2 + tables


def block_attention_work(x, heads: int, TN: int, mask) -> tuple:
    """K1: the qkv and proj products and the attention; x read, the
    output written, the weights read."""
    C = x.shape[-1]
    R = x.numel() // C
    fl, nb = attention_work(R, C, TN, heads, mask)
    return (fl + 8 * R * C * C,
            nb - 4 * R * C * 2 + 2 * R * C * 2 + 4 * C * C * 2 + 4 * C * 4)


def mlp_work(R: int, C: int, hidden: int, n_rows_io: int) -> tuple:
    """fc1 + fc2 over R rows; `n_rows_io` bf16 (R, C) tensors read or
    written; the weights and vectors read."""
    return (4 * R * C * hidden,
            n_rows_io * R * C * 2 + 2 * C * hidden * 2 + (hidden + 5 * C) * 4)


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
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels "
                         "need a GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from stswincl_tpu_torch import kernels
    from stswincl_tpu_torch.models import TswinPlus
    from stswincl_tpu_torch.models.init import init_weights
    from stswincl_tpu_torch.ops.add_ln_mlp import (swin_block_epilogue,
                                                   swin_block_epilogue_ref)
    from stswincl_tpu_torch.ops.attention import (attend_tiled,
                                                  fused_window_attention)
    from stswincl_tpu_torch.ops.block_attention import (
        swin_block_attention, swin_block_attention_ref,
        windowed_attention_image, windowed_attention_image_ref)
    from stswincl_tpu_torch.ops.conv import conv3x3_bn_act
    from stswincl_tpu_torch.ops.layernorm import fused_layer_norm
    from stswincl_tpu_torch.ops.mlp import fused_mlp
    from stswincl_tpu_torch.ops.patch_merge import (patch_merge,
                                                    patch_merge_ref)
    from stswincl_tpu_torch.ops.resize import (composed_matrices,
                                               composed_upsample_argmax_cf)
    from stswincl_tpu_torch.ops.upsample_argmax import (interp_spans,
                                                        upsample_argmax,
                                                        upsample_argmax_ref)
    from stswincl_tpu_torch.ops.window import (partition_qkv,
                                               shifted_window_attention_mask)
    from stswincl_tpu_torch.pipelines.streaming import StreamingSegmenter
    from stswincl_tpu_torch.tools.profile_merge_upsample import k4_work
    from stswincl_tpu_torch.tools.profile_swin_kernels import device_ms

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

    def uniform(*shape, fan_in, dtype=bf16, gain=1.0):
        b = gain * fan_in ** -0.5
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

    def compare(kname, case, kfn, pfn, work, lib=None, device=False):
        """Hold kernel call kfn against its twin pfn; `work` is (flops,
        bytes[, peak]) of the call, `lib` one PyTorch call computing the
        same function (timed only). `ms` is the median of single calls,
        host launch time included; with `device`, `device_ms` (and
        `library_device_ms`) the mean of back-to-back calls, which keep
        the card busy while the host runs ahead."""
        got, want = kfn(), pfn()
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{kname} {case}: {got.shape}/{got.dtype} vs "
              f"{want.shape}/{want.dtype}")
        d = got.float() - want.float()
        row = {"case": case, "max_abs_err": d.abs().max().item(),
               "rel_err": (d.norm() / want.float().norm()).item(),
               "ms": median_ms(kfn), "plain_ms": median_ms(pfn),
               "library_ms": None if lib is None else median_ms(lib),
               **bound(*work)}
        if device:
            row["device_ms"] = device_ms(kfn, 20)
            if lib is not None:
                row["library_device_ms"] = device_ms(lib, 20)
        results.setdefault(kname, []).append(row)
        print(f"  {kname:22s} {case:34s} max_abs {row['max_abs_err']:.3e} "
              f"rel {row['rel_err']:.3e} kernel {row['ms']:.3f} ms "
              f"plain {row['plain_ms']:.3f} ms bound {row['bound_ms']:.4f} "
              f"ms ({row['bound_by']})" + ("" if lib is None else
                                          f" library {row['library_ms']:.3f}"
                                          " ms"), flush=True)
        if device:
            print(f"  {'':22s} {case:34s} back to back: kernel "
                  f"{row['device_ms']:.4f} ms" + (
                      "" if lib is None else " library "
                      f"{row['library_device_ms']:.4f} ms"), flush=True)
        check(row["rel_err"] <= TOL_REL, f"{kname} {case}: relative error "
              f"{row['rel_err']} > {TOL_REL}")

    stage = {1: dict(C=512, h=64, w=80, ws=8), 2: dict(C=1024, h=32, w=40,
                                                       ws=4)}
    for s, cfg in itertools.chain(stage.items(), CONTRAST_STAGE.items()):
        C, h, w, ws = cfg["C"], cfg["h"], cfg["w"], cfg["ws"]
        heads, T = 4, 2
        TN = T * ws * ws
        x = randn(cfg.get("n", 2 * BS), T, h, w, C)
        label = cfg.get("label", f"stage{s}")
        # qkv and proj weights and the relative bias drawn as phase 2d
        # draws them, so that the attention branch is about as large as x
        # and the softmax peaked: at init scales and a 0.02 bias a missing
        # bias would move K1's output by less than the bound
        wqkv, bqkv = (uniform(3 * C, C, fan_in=C, gain=3.0),
                      uniform(3 * C, fan_in=C, dtype=torch.float32))
        wproj, bproj = (uniform(C, C, fan_in=C, gain=2.0),
                        uniform(C, fan_in=C, dtype=torch.float32))
        bias = randn(heads, TN, TN, dtype=torch.float32)
        for shift in (0, ws // 2):
            mask = None
            if shift:
                m = torch.from_numpy(
                    shifted_window_attention_mask(h, w, ws, shift))
                mask = m.repeat(1, T, T).to(dev)
            args = (x, wqkv, bqkv, wproj, bproj, bias, mask, heads,
                    (C // heads) ** -0.5, ws, shift)
            case = f"{label} {tuple(x.shape)} shift={shift}"
            compare("swin_block_attention", case,
                    lambda: swin_block_attention(*args),
                    lambda: swin_block_attention_ref(*args),
                    block_attention_work(x, heads, TN, mask))
            want = swin_block_attention_ref(*args)
            print(f"  {'':22s} {case:34s} |y| / |x| "
                  f"{(want.float().norm() / x.float().norm()).item():.3f}",
                  flush=True)
            planted("swin_block_attention", case, "without its relative "
                    "bias", rel_err(swin_block_attention_ref(
                        *args[:5], torch.zeros_like(bias), *args[6:]), want))
            planted("swin_block_attention", case, f"at shift {shift + 1}",
                    rel_err(swin_block_attention_ref(*args[:10], shift + 1),
                            want))
            del want
        hidden = 4 * C
        epi_w = (1.0 + randn(C, scale=0.1, dtype=torch.float32),
                 randn(C, scale=0.1, dtype=torch.float32),
                 uniform(hidden, C, fan_in=C),
                 uniform(hidden, fan_in=C, dtype=torch.float32),
                 uniform(C, hidden, fan_in=hidden),
                 uniform(C, fan_in=hidden, dtype=torch.float32),
                 1.0 + randn(C, scale=0.1, dtype=torch.float32),
                 randn(C, scale=0.1, dtype=torch.float32))
        y = randn(*x.shape)
        cases = [("plain", x, y, 0), (f"shift={ws // 2}", x, y, ws // 2)]
        if s == 1:  # the final_pair_only slice
            cases.append((f"T=1 shift={ws // 2}", x[:, 1:].contiguous(),
                          y[:, 1:].contiguous(), ws // 2))
        for name, xa, ya, shift in cases:
            kw = dict(gelu_exact=True, shift=shift, ws=ws)
            case = f"{label} {tuple(xa.shape)} {name}"
            compare("swin_block_epilogue", case,
                    lambda: swin_block_epilogue(xa, ya, *epi_w, **kw),
                    lambda: swin_block_epilogue_ref(xa, ya, *epi_w, **kw),
                    mlp_work(xa.numel() // C, C, hidden, 3))
            planted("swin_block_epilogue", case, f"at shift {shift + 1}",
                    rel_err(swin_block_epilogue_ref(
                        xa, ya, *epi_w, **dict(kw, shift=shift + 1)),
                        swin_block_epilogue_ref(xa, ya, *epi_w, **kw)))
    C = 512
    pm = (1.0 + randn(4 * C, scale=0.1, dtype=torch.float32),
          randn(4 * C, scale=0.1, dtype=torch.float32),
          uniform(2 * C, 4 * C, fan_in=4 * C))
    # K3 at the serving shape (bs 2, 4 frames), the stage-1 training shape
    # (batch 8) and the contrast path's (batch 4, 256x448): one LayerNorm
    # pass and one Hopper GEMM a call; on the two training shapes also its
    # backward (PatchMergeFn: the LayerNorm recomputed, dn and dW as bf16
    # products with fp32 accumulation) against autograd of the fp32 twin
    # on the same values
    k3_bwd = []
    for BT, hm, wm in ((4 * BS, 64, 80), (4 * 8, 64, 80),
                       (4 * CONTRAST_BATCH, *CONTRAST_HW8)):
        xm = randn(BT, hm, wm, C)
        rm = xm.numel() // C // 4  # output rows
        compare("patch_merge", f"{tuple(xm.shape)}",
                lambda: patch_merge(xm, *pm), lambda: patch_merge_ref(xm, *pm),
                (16 * rm * C * C, xm.numel() * 2 + rm * 2 * C * 2
                 + 8 * C * C * 2 + 8 * C * 4), device=True)
        if BT == 4 * BS:
            # the 2x2 gather order with its (0, 1) and (1, 0) pixels
            # swapped: the merge of each 2x2 block transposed
            planted("patch_merge", f"{tuple(xm.shape)}", "with the 2x2 "
                    "gather order swapped", rel_err(patch_merge_ref(
                        xm.transpose(1, 2).contiguous(), *pm).transpose(1, 2),
                        patch_merge_ref(xm, *pm)))
        else:
            k3_bwd.append(phase_patch_merge_backward(xm, pm, randn,
                                                     median_ms))
        del xm

    lcf = randn(BS, 12, 64, 80, dtype=torch.float32)
    mh, mw = (m.to(dev) for m in composed_matrices(64, 80, (H, W), OUT_HW))
    sh, sw = interp_spans(mh), interp_spans(mw)
    # a dense pair (full-row spans: still correct, slower) of the same
    # shapes, uniform in [0, 1): positive weights, so no class is
    # cancelled away
    dh_, dw_ = (torch.rand(m.shape, generator=gen, device=dev)
                for m in (mh, mw))
    k4_pairs = {"composed": (mh, mw, sh, sw),
                "dense": (dh_, dw_, interp_spans(dh_), interp_spans(dw_))}
    for (pair, (ah, aw, s_h, s_w)), exact in itertools.product(
            k4_pairs.items(), (False, True)):
        k4 = functools.partial(upsample_argmax, lcf, ah, aw, exact,
                               spans=(s_h, s_w))
        got, want = k4(), upsample_argmax_ref(lcf, ah, aw, exact)
        torch.cuda.synchronize()
        check(got.shape == (BS, *OUT_HW) and got.dtype == torch.int32,
              f"upsample_argmax: {got.shape} {got.dtype}")
        share = (got == want).float().mean().item()
        row = {"case": f"{tuple(lcf.shape)} {pair} exact={exact}",
               "max_abs_err": (got - want).abs().max().item(),
               "equal_share": share, "ms": median_ms(k4),
               "plain_ms": median_ms(
                   lambda: upsample_argmax_ref(lcf, ah, aw, exact)),
               "library_ms": None, "device_ms": device_ms(k4, 20),
               **bound(*k4_work(lcf.shape, s_h, s_w),
                       PEAK_F32 if exact else PEAK_BF16)}
        results.setdefault("upsample_argmax", []).append(row)
        print(f"  {'upsample_argmax':22s} {row['case']:34s} equal "
              f"{share:.6f} kernel {row['ms']:.4f} ms plain "
              f"{row['plain_ms']:.3f} ms back to back "
              f"{row['device_ms']:.4f} ms bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})", flush=True)
        check(share >= TOL_K4_SHARE, f"upsample_argmax {row['case']}: "
              f"{share} of pixels equal < {TOL_K4_SHARE}")
    # planted faults in the twin: each must drop the share of equal pixels
    # to 0.99 or below, missing TOL_K4_SHARE's 1e-3 tenfold
    want = upsample_argmax_ref(lcf, mh, mw)
    for fault, (fh, fw) in (
            ("with the column matrix shifted by one output column",
             (mh, mw.roll(1, dims=0))),
            ("with every span missing its last tap",
             (without_last_tap(mh, sh), without_last_tap(mw, sw)))):
        share = (upsample_argmax_ref(lcf, fh, fw) == want).float().mean()
        print(f"  {'':22s} {'composed':34s} the twin {fault}: equal "
              f"{share.item():.6f}", flush=True)
        check(share.item() <= 1 - 10 * (1 - TOL_K4_SHARE),
              f"upsample_argmax: the twin {fault} keeps {share.item()} of "
              "pixels equal")
    del want
    print(f"phase 2 kernels vs plain: {time.perf_counter() - t0:.1f} s",
          flush=True)

    # ---- phase 2b: backward kernels against their twins -----------------
    t0 = time.perf_counter()
    from stswincl_tpu_torch.ops import add_ln_mlp as epi_ops
    from stswincl_tpu_torch.ops import block_attention as attn_ops

    def compare_outputs(kname, case, kfn, pfn, names, work, device=False):
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
               "ms": median_ms(kfn), "plain_ms": median_ms(pfn),
               "library_ms": None}
        if work is not None:
            row.update(bound(*work))
        if device:
            row["device_ms"] = device_ms(kfn, 20)
        results.setdefault(kname, []).append(row)
        print(f"  {kname:24s} {case:44s} max rel {row['rel_err']:.3e} "
              f"kernel {row['ms']:.3f} ms plain {row['plain_ms']:.3f} ms"
              + (f" back to back {row['device_ms']:.4f} ms" if device
                 else ""), flush=True)
        print("      " + " ".join(f"{n} {r:.2e}" for n, r in rels.items()),
              flush=True)
        for n, r in rels.items():
            check(r <= TOL_REL, f"{kname} {case} {n}: relative error {r} > "
                  f"{TOL_REL}")
        torch.cuda.empty_cache()

    TB = 8  # the stage-1 training batch: two-group layers fold to 2 * TB

    def k5_work(x, heads, TN, mask):
        """K5: five attention products, the input- and weight-gradient
        products of qkv and proj; x, g, qkv, attn read, dx written, the
        weights read and their fp32 gradients written."""
        C = x.shape[-1]
        R = x.numel() // C
        fl, tables = attention_work(R, C, TN, heads, mask)
        return (2.5 * fl + 16 * R * C * C,
                tables - 4 * R * C * 2 + heads * TN * TN * 4
                + 7 * R * C * 2 + 4 * C * C * (2 + 4) + 4 * C * 4)

    def k6_work(x, hidden, with_m, shift):
        """K6: fc1 (and fc2 without a saved m) recomputed, dh, dn2, dw1,
        dw2; x, y, g (and m) read, dx (and dy when shifted) written, the
        weights read and their fp32 gradients written."""
        C = x.shape[-1]
        R = x.numel() // C
        n_io = 3 + bool(with_m) + 1 + bool(shift)
        return ((5 if with_m else 6) * 2 * R * C * hidden,
                n_io * R * C * 2 + 2 * C * hidden * (2 + 4)
                + (2 * hidden + 9 * C) * 4)
    attn_names = ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias")
    epi_names = ("dx", "dy", "ds2", "db2", "dw1", "db1", "dw2", "dbw2",
                 "ds1", "db1n")
    for s, cfg in itertools.chain(stage.items(), CONTRAST_STAGE.items()):
        C, h, w, ws = cfg["C"], cfg["h"], cfg["w"], cfg["ws"]
        heads, T = 4, 2
        TN = T * ws * ws
        x = randn(cfg.get("n", 2 * TB), T, h, w, C)
        g = randn(*x.shape)
        label = cfg.get("label", f"stage{s}")
        # drawn as phase 2 draws them: a peaked softmax, so that the
        # softmax backward's row-sum term is a sizeable share of dS (at
        # init scales and a 0.02 bias P is near uniform and dropping the
        # term moved the gradients by only 0.10-0.24)
        wqkv, bqkv = (uniform(3 * C, C, fan_in=C, gain=3.0),
                      uniform(3 * C, fan_in=C, dtype=torch.float32))
        wproj, bproj = (uniform(C, C, fan_in=C, gain=2.0),
                        uniform(C, fan_in=C, dtype=torch.float32))
        bias = randn(heads, TN, TN, dtype=torch.float32)
        for shift in (0, ws // 2):
            mask = None
            if shift:
                mask = torch.from_numpy(shifted_window_attention_mask(
                    h, w, ws, shift)).repeat(1, T, T).to(dev)
            fwd = (x, wqkv, bqkv, wproj, bproj, bias, mask, heads,
                   (C // heads) ** -0.5, ws, shift)
            _, qkv, attn = attn_ops._forward_kernel(*fwd)
            case = f"{label} {tuple(x.shape)} shift={shift}"
            compare_outputs(
                "swin_block_attention_bwd", case,
                lambda: attn_ops.swin_block_attention_bwd(
                    x, g, qkv, attn, wqkv, wproj, bias, mask, *fwd[7:]),
                lambda: attn_ops.swin_block_attention_bwd_ref(
                    *fwd[:7], g, *fwd[7:]), attn_names,
                k5_work(x, heads, TN, mask))
            del qkv, attn
            # the twin with its dbias term dropped (the relative bias
            # taken as a constant)
            want = attn_ops.swin_block_attention_bwd_ref(*fwd[:7], g,
                                                         *fwd[7:])
            planted("swin_block_attention_bwd", case, "without dbias",
                    max_rel_err(want[:5] + (torch.zeros_like(want[5]),),
                                want))
            planted("swin_block_attention_bwd", case, "without the row-sum "
                    "term (dS = P dP)", max_rel_err(
                        attention_bwd_without_rowsum(*fwd[:7], g, *fwd[7:]),
                        want))
            del want
        hidden = 4 * C
        # fc1 and fc2 at twice the init gain, so that the MLP branch, and
        # with it the gradient through LN2, is a sizeable share of s's
        epi_w = (1.0 + randn(C, scale=0.1, dtype=torch.float32),
                 randn(C, scale=0.1, dtype=torch.float32),
                 uniform(hidden, C, fan_in=C, gain=2.0),
                 uniform(hidden, fan_in=C, dtype=torch.float32),
                 uniform(C, hidden, fan_in=hidden, gain=2.0),
                 uniform(C, fan_in=hidden, dtype=torch.float32),
                 1.0 + randn(C, scale=0.1, dtype=torch.float32),
                 randn(C, scale=0.1, dtype=torch.float32))
        y = randn(*x.shape)
        with_m = epi_ops.mlp_output_saved(C, hidden, bf16)
        for shift in (0, ws // 2):
            kw = dict(gelu_exact=True, shift=shift, ws=ws)
            m = (epi_ops._forward_kernel(x, y, *epi_w, **kw, eps=1e-5,
                                         with_m=True)[1] if with_m else None)
            case = (f"{label} {tuple(x.shape)} shift={shift} "
                    + ("m saved" if with_m else "m recomputed"))
            compare_outputs(
                "swin_block_epilogue_bwd", case,
                lambda: epi_ops.swin_block_epilogue_bwd(
                    x, y, g, m, *epi_w[:7], **kw),
                lambda: epi_ops.swin_block_epilogue_bwd_ref(
                    x, y, *epi_w, g, **kw), epi_names,
                k6_work(x, hidden, with_m, shift))
            del m
            want = epi_ops.swin_block_epilogue_bwd_ref(x, y, *epi_w, g, **kw)
            planted("swin_block_epilogue_bwd", case, "without the LN2 path",
                    max_rel_err(epilogue_bwd_without_ln2_path(
                        x, y, *epi_w, g, **kw), want))
            planted("swin_block_epilogue_bwd", case, "with gelu' as 1",
                    max_rel_err(epilogue_bwd_with_unit_gelu_grad(
                        x, y, *epi_w, g, **kw), want))
            del want
        if with_m:
            kw = dict(gelu_exact=True, shift=0, ws=ws)
            compare_outputs(
                "swin_block_epilogue", f"{label} {tuple(x.shape)} m output",
                lambda: epi_ops._forward_kernel(x, y, *epi_w, **kw, eps=1e-5,
                                                with_m=True),
                lambda: epi_ops.swin_block_epilogue_with_m_ref(x, y, *epi_w,
                                                               **kw),
                ("out", "m"), mlp_work(x.numel() // C, C, hidden, 4))
        del x, y, g
    torch.cuda.empty_cache()
    print(f"phase 2b backward kernels vs plain: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 2c: the attention kernels of 'pallas' / 'pallas_windows' --
    t0 = time.perf_counter()
    for s, cfg in stage.items():
        C, h, w, ws = cfg["C"], cfg["h"], cfg["w"], cfg["ws"]
        heads, T = 4, 2
        TN = T * ws * ws
        qkv = randn(2 * BS, T, h, w, 3 * C)
        q, k, v = partition_qkv(qkv, heads, ws).contiguous()
        bias = randn(heads, TN, TN, scale=0.02, dtype=torch.float32)
        scale = (C // heads) ** -0.5
        for shift in (0, ws // 2):
            mask = None
            if shift:
                mask = torch.from_numpy(shifted_window_attention_mask(
                    h, w, ws, shift)).repeat(1, T, T).to(dev)
            work = attention_work(qkv.numel() // (3 * C), C, TN, heads, mask)
            case = f"stage{s} {tuple(qkv.shape)} mask={bool(shift)}"
            compare("windowed_attention_image", case,
                    lambda: windowed_attention_image(qkv, bias, mask, heads,
                                                     scale, ws),
                    lambda: windowed_attention_image_ref(qkv, bias, mask,
                                                         heads, scale, ws),
                    work)
            if mask is not None:
                planted("windowed_attention_image", case, "without the mask",
                        rel_err(windowed_attention_image_ref(
                            qkv, bias, None, heads, scale, ws),
                            windowed_attention_image_ref(qkv, bias, mask,
                                                         heads, scale, ws)))
            # the library yardstick: SDPA with bias (+ the window's mask)
            # as its additive mask, windows regrouped so that the mask
            # broadcasts over the images; timed only, the port never
            # calls it
            if mask is None:
                qs, ks, vs = q, k, v
                am = bias[None].to(bf16)
            else:
                nW = mask.shape[0]
                qs, ks, vs = (t.reshape(-1, nW * heads, TN, C // heads)
                              for t in (q, k, v))
                am = (mask[:, None] + bias[None]).reshape(
                    1, nW * heads, TN, TN).to(bf16)
            case = f"stage{s} {tuple(q.shape)} mask={bool(shift)}"
            compare("fused_window_attention", case,
                    lambda: fused_window_attention(q, k, v, bias, mask,
                                                   scale),
                    lambda: attend_tiled(q, k, v, bias, mask, scale), work,
                    lambda: F.scaled_dot_product_attention(
                        qs, ks, vs, attn_mask=am, scale=scale))
            if mask is not None:
                planted("fused_window_attention", case, "without the mask",
                        rel_err(attend_tiled(q, k, v, bias, None, scale),
                                attend_tiled(q, k, v, bias, mask, scale)))
        del qkv, q, k, v
    torch.cuda.empty_cache()
    print(f"phase 2c route attention kernels vs plain: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 2d: the whole-block kernel (row 16); rows 13 and 14 -------
    t0 = time.perf_counter()
    from stswincl_tpu_torch.ops import gemm as gemm_ops
    from stswincl_tpu_torch.ops import swin_block as wb_ops
    from stswincl_tpu_torch.ops.add_layernorm import (add_layer_norm,
                                                      add_layer_norm_ref)
    from stswincl_tpu_torch.ops.add_ln_mlp import add_ln_mlp, add_ln_mlp_ref

    pair_ms = {}  # row-16 case -> ms of the K1 + K2 pair on its inputs
    whole_names = ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias",
                   "ds2", "db2", "dw1", "db1", "dw2", "dbw2", "ds1", "db1n")
    for s, batch in ((1, 2 * BS), (2, 2 * BS), (1, 2 * TB), (2, 2 * TB)):
        C, h, w, ws = (stage[s][k] for k in ("C", "h", "w", "ws"))
        heads, T = 4, 2
        TN, hidden = T * ws * ws, 4 * C
        x = randn(batch, T, h, w, C)
        # qkv and proj weights and the relative bias drawn large enough
        # that the attention branch y is about as large as x (1.1-1.3x)
        # and the softmax peaked: at unit gains and a 0.02 bias y is 3-4 %
        # of x, and a fault in the attention phases would move the block's
        # output by less than TOL_REL
        params = [uniform(3 * C, C, fan_in=C, gain=3.0),
                  uniform(3 * C, fan_in=C, dtype=torch.float32),
                  uniform(C, C, fan_in=C, gain=2.0),
                  uniform(C, fan_in=C, dtype=torch.float32),
                  randn(heads, TN, TN, dtype=torch.float32), None,
                  1.0 + randn(C, scale=0.1, dtype=torch.float32),
                  randn(C, scale=0.1, dtype=torch.float32),
                  uniform(hidden, C, fan_in=C),
                  uniform(hidden, fan_in=C, dtype=torch.float32),
                  uniform(C, hidden, fan_in=hidden),
                  uniform(C, fan_in=hidden, dtype=torch.float32),
                  1.0 + randn(C, scale=0.1, dtype=torch.float32),
                  randn(C, scale=0.1, dtype=torch.float32)]
        cfgw = (heads, (C // heads) ** -0.5, ws)
        R = x.numel() // C
        case = f"stage{s} {tuple(x.shape)}"
        gemm_ops.launch_counts(reset=True)
        compare("whole_swin_block", case,
                lambda: wb_ops.whole_swin_block(x, *params, *cfgw),
                lambda: wb_ops.whole_swin_block_ref(x, *params, *cfgw),
                (8 * R * C * C + 4 * R * TN * C + 4 * R * C * hidden,
                 2 * R * C * 2 + (4 * C * C + 2 * C * hidden) * 2
                 + (9 * C + hidden) * 4 + heads * TN * TN * 4), device=True)
        torch.cuda.synchronize()
        forms = gemm_ops.launch_counts()
        check(forms == dict.fromkeys(gemm_ops.FORMS, 0), f"row 16 {case}: "
              f"the library counted GEMM launches {forms}, expected none")
        # the K1 + K2 pair with m rounded (K2's `m_out` form): row 16 sums
        # every product in the Hopper GEMM's order, runs K1's attention core
        # and K2's LayerNorm order, so it should carry the same bits
        got = wb_ops.whole_swin_block(x, *params, *cfgw)
        pair_m = wb_ops.whole_swin_block_pair(x, *params, *cfgw,
                                              m_out=True)
        pair_diff = (got.float() - pair_m.float()).abs().max().item()
        del got, pair_m
        print(f"  {'':22s} {case:34s} largest |row 16 - (K1 + K2 with m "
              f"rounded)| = {pair_diff:.3e}", flush=True)
        results["whole_swin_block"][-1]["pair_m_rounded_max_abs"] = pair_diff
        # a planted fault: the twin without its relative bias must lie far
        # outside the bound the kernel is held to
        want = wb_ops.whole_swin_block_ref(x, *params, *cfgw).float()
        no_bias = params[:4] + [torch.zeros_like(params[4])] + params[5:]
        moved = ((wb_ops.whole_swin_block_ref(x, *no_bias, *cfgw).float()
                  - want).norm() / want.norm()).item()
        y_size = (swin_block_attention_ref(x, *params[:6], *cfgw).float()
                  .norm() / x.float().norm()).item()
        del want
        print(f"  {'':22s} {case:34s} |y| / |x| {y_size:.3f}; the twin "
              f"without its relative bias moves by rel {moved:.3e}; "
              f"{wb_ops._slots(T, C, heads, ws)} workspace slots",
              flush=True)
        check(moved > 10 * TOL_REL, f"whole_swin_block {case}: dropping the "
              f"relative bias moves the output by only {moved}")
        if s == 2:
            # a fault only the tiling shows: the attention phase skipping
            # the last window of each 128-row tile (4 windows a tile)
            planted("whole_swin_block", case,
                    "without the last window of each tile",
                    rel_err(whole_block_without_last_window(
                        x, params, cfgw, wb_ops.TILE_ROWS // TN),
                        wb_ops.whole_swin_block_ref(x, *params, *cfgw)))

        def pair():
            return swin_block_epilogue(
                x, swin_block_attention(x, *params[:6], *cfgw), *params[6:],
                ws=ws)
        pair_ms[case] = {"ms": median_ms(pair), "device_ms": device_ms(pair,
                                                                       20)}
        # device-memory bytes of one call by design (computed from the
        # shapes, not measured), each intermediate written once and read
        # once (GEMM re-reads counted once), bf16 2 and fp32 4 bytes: row
        # 16 reads x in phases 1 and 3, writes the output, and takes
        # through its slot workspace qkv, the attention output, LN2(s),
        # the hidden activation and the fp32 s (written, read by LN2,
        # updated by fc2, read by LN1); the pair also writes y (K1) and
        # reads it back (K2)
        bytes16 = R * (2 * 2 * C + 2 * C + 2 * 2 * 3 * C + 2 * 2 * C
                       + 2 * 2 * C + 2 * 2 * hidden + 5 * 4 * C)
        print(f"  {'K1 + K2 pair':22s} {case:34s} on the same inputs "
              f"{pair_ms[case]['ms']:.3f} ms, back to back "
              f"{pair_ms[case]['device_ms']:.4f} ms (measured)", flush=True)
        print(f"  {'':22s} {case:34s} design count, not measured: "
              f"device-memory bytes row 16 {bytes16 / 1e9:.3f} GB, the pair "
              f"{(bytes16 + R * 4 * C) / 1e9:.3f} GB, x and out once "
              f"{R * 4 * C / 1e9:.3f} GB", flush=True)
        if batch == 2 * TB:
            # the backward, through the Function (fp32 weights, as the
            # model hands them) and autograd of the twin (bf16 weights)
            mats = (0, 2, 8, 10)
            given = [p.float() if i in mats else p
                     for i, p in enumerate(params)]
            g = randn(*x.shape)

            def grads(fn, ps):
                idx = [i for i, p in enumerate(ps) if p is not None]
                leaves = [x.detach().requires_grad_()] + [
                    ps[i].detach().requires_grad_() for i in idx]
                a = list(ps)
                for i, leaf in zip(idx, leaves[1:]):
                    a[i] = leaf
                return torch.autograd.grad(fn(leaves[0], *a, *cfgw), leaves,
                                           g)
            compare_outputs(
                "whole_swin_block_bwd", case,
                lambda: grads(wb_ops.whole_swin_block, given),
                lambda: grads(wb_ops.whole_swin_block_ref, params),
                whole_names, None)
            del given, g
        del x, params
        torch.cuda.empty_cache()
    row13_chain = {}  # case -> ms of PyTorch's add, LN and three MLP calls
    for C, R in ((512, 163840), (1024, 40960)):  # the profiler's shapes
        hidden = 4 * C
        xt, yt = randn(R, C), randn(R, C)
        p13 = (1.0 + randn(C, scale=0.1, dtype=torch.float32),
               randn(C, scale=0.1, dtype=torch.float32),
               uniform(hidden, C, fan_in=C),
               uniform(hidden, fan_in=C, dtype=torch.float32),
               uniform(C, hidden, fan_in=hidden),
               uniform(C, fan_in=hidden, dtype=torch.float32))
        case = f"({R}, {C})"
        reset_launches({"add_ln_mlp": add_ln_mlp})
        compare_outputs("add_ln_mlp", case,
                        lambda: add_ln_mlp(xt, yt, *p13),
                        lambda: add_ln_mlp_ref(xt, yt, *p13), ("s", "m"),
                        mlp_work(R, C, hidden, 4), device=True)
        torch.cuda.synchronize()
        forms = gemm_ops.launch_counts()
        print(f"  {'':24s} {case:44s} row 13 launches {add_ln_mlp.launches}"
              f", Hopper GEMM launches by form {forms}", flush=True)
        check(forms == dict.fromkeys(gemm_ops.FORMS, 0)
              | {"bf16": 2 * add_ln_mlp.launches}, f"row 13 {case}: the "
              f"library counted {forms} for {add_ln_mlp.launches} launches")
        # beside it, PyTorch's add, F.layer_norm and F.linear -> F.gelu ->
        # F.linear on cuBLAS, bf16 (the same function in five calls)
        lw = [t.to(bf16) for t in p13]

        def chain():
            s32 = xt + yt
            return s32, F.linear(F.gelu(F.linear(
                F.layer_norm(s32, (C,), lw[0], lw[1], 1e-5), p13[2], lw[3])),
                p13[4], lw[5])
        row13_chain[case] = {"ms": median_ms(chain),
                             "device_ms": device_ms(chain, 20)}
        print(f"  {'add-LN-linear-gelu-linear':24s} {case:44s} "
              f"{row13_chain[case]['ms']:.3f} ms, back to back "
              f"{row13_chain[case]['device_ms']:.4f} ms (PyTorch, bf16)",
              flush=True)
        ln = p13[:2]
        compare("add_layer_norm", f"({R}, {C}) norm only",
                lambda: add_layer_norm(xt, yt, *ln, return_sum=False)[1],
                lambda: add_layer_norm_ref(xt, yt, *ln, return_sum=False)[1],
                (10 * R * C, 3 * R * C * 2 + 2 * C * 4, PEAK_F32),
                device=True)
        compare_outputs("add_layer_norm", f"({R}, {C}) with the sum",
                        lambda: add_layer_norm(xt, yt, *ln),
                        lambda: add_layer_norm_ref(xt, yt, *ln),
                        ("sum", "norm"),
                        (10 * R * C, 4 * R * C * 2 + 2 * C * 4, PEAK_F32),
                        device=True)
        del xt, yt, p13
        torch.cuda.empty_cache()
    print(f"phase 2d whole block, rows 13 and 14 vs plain: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 2e: rows 12, 15 and 17 ------------------------------------
    t0 = time.perf_counter()
    from stswincl_tpu_torch.ops import gemm as gemm_ops
    reset_launches({"conv3x3_bn_act": conv3x3_bn_act, "fused_mlp": fused_mlp})
    extras = phase_offpath_kernels(dev, bf16, randn, uniform, median_ms,
                                   compare)
    forms = gemm_ops.launch_counts()
    print(f"  row 12 launches {fused_mlp.launches}, row 17 launches "
          f"{conv3x3_bn_act.launches}; Hopper GEMM launches by form "
          f"(counted in the library): {forms}", flush=True)
    check(forms == dict.fromkeys(gemm_ops.FORMS, 0)
          | {"bf16": 2 * fused_mlp.launches,
             "conv": conv3x3_bn_act.launches}, "phase 2e: the library "
          f"counted {forms}, row 12's wrapper {fused_mlp.launches}, row "
          f"17's {conv3x3_bn_act.launches}")
    print(f"phase 2e rows 12, 15 and 17 vs plain: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 2f: the Hopper GEMMs alone at K1, K2, K5 and K6's products --
    # (the tool holds each case within TOL_REL of the twin and raises else)
    t0 = time.perf_counter()
    from stswincl_tpu_torch.tools import profile_gemm
    gemm_wrappers = {"linear_sm90": gemm_ops.linear_sm90,
                     "gelu_bwd_sm90": gemm_ops.gelu_bwd_sm90,
                     "wgrad_sm90": gemm_ops.wgrad_sm90}
    gemm_forms = {"linear": "linear_sm90", "gelu_bwd": "gelu_bwd_sm90",
                  "wgrad": "wgrad_sm90"}
    reset_launches(gemm_wrappers)
    for r in profile_gemm.main(["--reps", "10"]):
        r["library_ms"] = r.pop("matmul_ms")  # cuBLAS on the same operands
        form = r.pop("form")
        if form in gemm_forms:  # not the two-way comparisons' sequences
            results.setdefault(gemm_forms[form], []).append(r)
    gemm_launches, forms = read_launches(gemm_wrappers)
    print(f"  profile_gemm launches: {gemm_launches}, by form {forms}",
          flush=True)
    for k, fn in gemm_wrappers.items():  # the library counts what the
        check(gemm_launches[k] == fn.launches,  # wrappers launched
              f"profile_gemm: the library counted {gemm_launches[k]} {k} "
              f"launches, its wrapper {fn.launches}")
    print(f"phase 2f the Hopper GEMMs vs torch.matmul: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 3: serve --------------------------------------------------
    t0 = time.perf_counter()
    kw = dict(num_classes=12, swin_dim=512, swin_depths=(3, 3), dtype=bf16,
              input_hw=(H, W))
    model = TswinPlus(**kw)
    init_weights(model, torch.Generator().manual_seed(0))
    model.to(dev).eval()
    frames = torch.rand((BS, 4 + STEPS, H, W, 3), generator=gen,
                        device=dev) * 2 - 1
    calibrate_batchnorm(model, frames[:, 0:4])
    weights = model.state_dict()
    wrappers = kernel_wrappers()
    route_kernel = ROUTE_KERNEL
    # path -> {kernel: launches on that path}; the Hopper GEMM's counts
    # come from the library (K1-K3, K5 and K6 launch it from C)
    launches = {"gemm": {k: gemm_launches.get(k, 0) for k in wrappers}}

    def serve(route, whole_block=False):
        """Drive StreamingSegmenter on `route` (with the whole-block
        kernel on the W-MSA blocks when `whole_block`) with the phase-3
        weights; check it against the full clip, the route's plain form
        and (for the other routes) the phase-3 route. Returns the
        full-clip predictions."""
        tag = "pallas_full whole_block" if whole_block else route
        m = TswinPlus(**kw, attn_impl=route, whole_block=whole_block)
        m.load_state_dict(weights)
        m.to(dev).eval()
        seg = StreamingSegmenter(m, out_hw=OUT_HW)
        path = ("serve_whole_block" if whole_block else "serve"
                if route == "pallas_full" else f"serve_{route}")
        reset_launches(wrappers)
        cache, pred = seg.init_and_predict(frames[:, 0:4])
        preds = [pred]
        step_s = []
        before = read_launches(wrappers)[0]
        for i in range(4, 4 + STEPS):
            ts = time.perf_counter()
            cache, pred = seg.predict_next(cache, frames[:, i])
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - ts)
            preds.append(pred)
        launches[path], forms = read_launches(wrappers)
        per_step = {k: (n - before[k]) / STEPS
                    for k, n in launches[path].items()}
        print(f"  [{tag}] serving-path launches: {launches[path]}; per "
              f"predict_next: {per_step}", flush=True)
        check_gemm_launches(tag, launches[path], forms, m_saved=0)
        for k in (route_kernel[route], "swin_block_epilogue", "patch_merge",
                  "upsample_argmax"):
            check(launches[path][k] > 0,
                  f"{k} was never launched on the {tag} serving path")
        for r, k in route_kernel.items():
            check(r == route or launches[path][k] == 0,
                  f"{k} launched on the {tag} serving path")
        # a predict_next runs 7 W-MSA / SW-MSA block pairs at depths (3, 3)
        # under final_pair_only; row 16 takes the W-MSA block of each pair
        pair_calls = 1 if whole_block else 2
        for k, want in ((route_kernel[route], 7 * pair_calls),
                        ("swin_block_epilogue", 7 * pair_calls),
                        ("whole_swin_block", 7 if whole_block else 0)):
            check(per_step[k] == want, f"{tag}: {k} launched {per_step[k]} "
                  f"times a predict_next, expected {want}")
        steady = step_s[2:]
        fps = BS * len(steady) / sum(steady)
        print(f"  [{tag}] steady-state predict_next: {fps:.2f} frames/s at "
              f"bs {BS} ({1e3 * statistics.median(steady):.2f} ms/step "
              f"median, {len(steady)} steps) on {smi}", flush=True)

        for p in preds:
            check(p.shape == (BS, *OUT_HW) and p.dtype == torch.int32,
                  f"prediction {p.shape} {p.dtype}")
            check(int(p.min()) >= 0 and int(p.max()) < 12,
                  "class out of range")
        plain = TswinPlus(**kw, attn_impl=route, kernels=False,
                          whole_block=whole_block)
        plain.load_state_dict(weights)
        plain.to(dev).eval()
        stream_shares, plain_shares, fulls = [], [], []
        with torch.inference_mode():
            for k, p in enumerate(preds):
                clip = frames[:, k:k + 4]
                full = composed_upsample_argmax_cf(
                    m(clip, head_res_logits=True), (H, W), OUT_HW)
                fulls.append(full)
                stream_shares.append((p == full).float().mean().item())
                if k in (0, len(preds) - 1):
                    ref = composed_upsample_argmax_cf(
                        plain(clip, head_res_logits=True), (H, W), OUT_HW,
                        kernels=False)
                    plain_shares.append((full == ref).float().mean().item())
            classes = torch.bincount(preds[-1].flatten(), minlength=12)
        print(f"  [{tag}] streamed == full clip (kernel route): min "
              f"{min(stream_shares):.6f} of pixels over {len(preds)} frames",
              flush=True)
        print(f"  [{tag}] kernel route == plain route: {plain_shares} of "
              f"pixels", flush=True)
        print(f"  [{tag}] last-frame class histogram: {classes.tolist()}",
              flush=True)
        check(min(stream_shares) >= TOL_STREAM_SHARE, f"{tag}: streamed vs "
              f"full clip {min(stream_shares)} < {TOL_STREAM_SHARE}")
        check(min(plain_shares) >= TOL_PLAIN_SHARE, f"{tag}: kernel vs "
              f"plain route {min(plain_shares)} < {TOL_PLAIN_SHARE}")
        return fulls

    full_preds = serve("pallas_full")
    print(f"phase 3 serve: {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 3b: serve on the 'pallas' and 'pallas_windows' routes -----
    t0 = time.perf_counter()
    def same_as_phase3(tag, fulls):
        shares = [(a == b).float().mean().item()
                  for a, b in zip(fulls, full_preds)]
        print(f"  [{tag}] == 'pallas_full' route (full clips): min "
              f"{min(shares):.6f} of pixels over {len(shares)} clips",
              flush=True)
        check(min(shares) >= TOL_PLAIN_SHARE, f"{tag} vs pallas_full "
              f"route {min(shares)} < {TOL_PLAIN_SHARE}")

    for route in ("pallas", "pallas_windows"):
        same_as_phase3(route, serve(route))
    print(f"phase 3b serve on the new routes: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 3c: serve with the whole-block kernel ---------------------
    t0 = time.perf_counter()
    same_as_phase3("whole_block", serve("pallas_full", whole_block=True))
    print(f"phase 3c serve with the whole-block kernel: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del model, frames, weights, full_preds
    torch.cuda.empty_cache()

    # ---- phases 4, 4d and 4e: train --------------------------------------
    t0 = time.perf_counter()
    phase_train(dev, bf16, smi, wrappers, route_kernel, launches)
    print(f"phases 4, 4d and 4e train: {time.perf_counter() - t0:.1f} s",
          flush=True)

    # ---- phase 5: the kernel profiler's entry point ----------------------
    t0 = time.perf_counter()
    from stswincl_tpu_torch.tools import profile_swin_kernels
    reset_launches(wrappers)
    profile_swin_kernels.main(["--reps", "3"])
    launches["profile"], forms = read_launches(wrappers)
    print(f"  profiler launches: {launches['profile']}", flush=True)
    check_gemm_launches("profile", launches["profile"], forms)
    for k in ("swin_block_attention", "swin_block_epilogue",
              "windowed_attention_image", "add_ln_mlp", "add_layer_norm"):
        check(launches["profile"][k] > 0, f"{k} was never launched by the "
              "kernel profiler")
    print(f"phase 5 kernel profiler: {time.perf_counter() - t0:.1f} s",
          flush=True)

    # ---- phase 6: the entry points of rows 12, 15 and 17 -----------------
    t0 = time.perf_counter()
    mlp_module_ms = phase_entry_points(dev, bf16, randn, wrappers, launches)
    print(f"phase 6 the Mlp and FusedLayerNorm modules, the conv profiler: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 7: fp32 compute on the plain twins ------------------------
    t0 = time.perf_counter()
    phase_fp32(dev, wrappers, launches)
    print(f"phase 7 fp32 serve and train step: {time.perf_counter() - t0:.1f}"
          " s", flush=True)

    # ---- phase 8: stage-2 contrastive pretraining ------------------------
    t0 = time.perf_counter()
    phase_contrast(dev, bf16, smi, wrappers, launches)
    print(f"phase 8 stage-2 pretraining: {time.perf_counter() - t0:.1f} s",
          flush=True)

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
        "windowed_attention_image": (
            "window_attention.cu",
            "stswincl_tpu/ops/pallas_block_attention.py:128"),
        "fused_window_attention": (
            "window_attention.cu",
            "stswincl_tpu/ops/pallas_attention.py:118"),
        "whole_swin_block": ("swin_block.cu",
                             "stswincl_tpu/ops/pallas_swin_block.py:229"),
        "add_ln_mlp": ("epilogue.cu",
                       "stswincl_tpu/ops/pallas_add_ln_mlp.py:97"),
        "add_layer_norm": ("add_layernorm.cu",
                           "stswincl_tpu/ops/pallas_add_layernorm.py:110"),
        "fused_mlp": ("epilogue.cu", "stswincl_tpu/ops/pallas_mlp.py:226"),
        "fused_layer_norm": ("add_layernorm.cu",
                             "stswincl_tpu/ops/pallas_layernorm.py:82"),
        "conv3x3_bn_act": ("conv.cu", "stswincl_tpu/ops/pallas_conv.py:132"),
        "linear_sm90": (
            "gemm_sm90.cu", "the matmuls of stswincl_tpu/ops/"
            "pallas_block_attention.py:179 and :405, pallas_add_ln_mlp.py:704 "
            "and :181"),
        "gelu_bwd_sm90": (
            "gemm_sm90.cu", "the fc1 recompute and dh of stswincl_tpu/ops/"
            "pallas_add_ln_mlp.py:181 (:213-233)"),
        "wgrad_sm90": (
            "gemm_sm90.cu", "the weight-gradient matmuls of stswincl_tpu/ops/"
            "pallas_block_attention.py:405 and pallas_add_ln_mlp.py:181"),
    }
    rows = []
    for k, (src, replaces) in meta.items():
        by_path = {path: counts[k] for path, counts in launches.items()}
        ops_ms = sum(c.get("ops_ms", 0.0) for c in results[k])
        bytes_ms = sum(c.get("bytes_ms", 0.0) for c in results[k])
        # the line carries each case's bound_ms and bound_by, not the two
        # times it is the larger of
        cases = [{n: v for n, v in c.items() if n not in ("ops_ms",
                                                         "bytes_ms")}
                 for c in results[k]]
        lib = [c["library_ms"] for c in cases]
        rows.append({
            "name": k, "route": "cuda",
            "source": f"stswincl_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": sum(c["ms"] for c in cases),
            "plain_ms": sum(c["plain_ms"] for c in cases),
            "bound_ms": sum(c["bound_ms"] for c in cases),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None if None in lib else sum(lib),
            "cases": cases})
        if all("device_ms" in c for c in cases):  # rows 14, 15 and 17
            rows[-1]["device_ms"] = sum(c["device_ms"] for c in cases)
    row16 = next(r for r in rows if r["name"] == "whole_swin_block")
    row16["pair_ms"] = pair_ms  # its yardstick; not a library call
    next(r for r in rows if r["name"] == "add_ln_mlp")[
        "add_ln_linear_gelu_linear_ms"] = row13_chain  # not a library call
    next(r for r in rows if r["name"] == "fused_mlp")[
        "mlp_module_ms"] = mlp_module_ms
    for name, design in (
            ("fused_mlp", "two launches of the Hopper GEMM's bf16 form "
             "(gemm_sm90.cu)"),
            ("add_ln_mlp", "K2's LN pass, then row 12's two bf16-form "
             "Hopper GEMM launches"),
            ("whole_swin_block", "one persistent launch: the Hopper GEMM "
             "tile (sm90_tile.cuh) for its four products, K1's register "
             "attention core (attention_core.cuh), K2's LN order")):
        next(r for r in rows if r["name"] == name)["design"] = design
    row16["backward"] = results["whole_swin_block_bwd"]
    next(r for r in rows if r["name"] == "patch_merge")["backward"] = k3_bwd
    for r in rows:  # rows 12 and 17: measured yardsticks, not library
        r.update(extras.get(r["name"], {}))  # calls
    print(json.dumps({"kernels": rows}))
    print(smi)
    if FAILED:
        raise SystemExit(f"chip_smoke: {len(FAILED)} checks failed: "
                         + "; ".join(FAILED))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def phase_offpath_kernels(dev, bf16, randn, uniform, median_ms, compare):
    """Phase 2e: rows 12, 15 and 17 against their twins at full width
    (through `compare`, which also times them). Returns, by kernel, the
    ms by case of two yardsticks that are not one library call: row 12's
    three cuBLAS calls, and at the ASPP shapes the model's own cuDNN call
    (the conv with its bias, channels_last) that row 17 could replace."""
    import torch
    import torch.nn.functional as F
    from stswincl_tpu_torch.ops.conv import (conv3x3_bn_act,
                                             conv3x3_bn_act_ref)
    from stswincl_tpu_torch.ops.layernorm import (fused_layer_norm,
                                                  layer_norm_ref)
    from stswincl_tpu_torch.ops.mlp import fused_mlp, mlp_ref
    from stswincl_tpu_torch.tools.profile_conv_kernel import (
        cudnn_conv_bn_act)
    from stswincl_tpu_torch.tools.profile_swin_kernels import device_ms
    f32 = torch.float32


    # row 12 at the batch-8 block shapes; its yardstick: F.linear ->
    # F.gelu -> F.linear on cuBLAS, bf16 (three calls)
    yardstick, model_conv = {}, {}
    for C, R, exact in ((512, 163840, True), (512, 163840, False),
                        (1024, 40960, True)):
        hidden = 4 * C
        xt = randn(R, C)
        p12 = (uniform(hidden, C, fan_in=C),
               uniform(hidden, fan_in=C, dtype=f32),
               uniform(C, hidden, fan_in=hidden),
               uniform(C, fan_in=hidden, dtype=f32))
        case = f"({R}, {C}) -> {hidden} {'erf' if exact else 'tanh'}"
        compare("fused_mlp", case, lambda: fused_mlp(xt, *p12, exact),
                lambda: mlp_ref(xt, *p12, exact),
                (4 * R * C * hidden,
                 2 * R * C * 2 + 2 * C * hidden * 2 + (hidden + C) * 4),
                device=True)
        b1, b2 = p12[1].to(bf16), p12[3].to(bf16)
        approx = "none" if exact else "tanh"

        def chain():
            return F.linear(F.gelu(F.linear(xt, p12[0], b1),
                                   approximate=approx), p12[2], b2)
        yardstick[case] = {"ms": median_ms(chain),
                           "device_ms": device_ms(chain, 20)}
        print(f"  {'F.linear-F.gelu-F.linear':22s} {case:34s} "
              f"{yardstick[case]['ms']:.3f} ms, back to back "
              f"{yardstick[case]['device_ms']:.4f} ms (cuBLAS, bf16)",
              flush=True)
        del xt, p12
        torch.cuda.empty_cache()

    # row 15; its library call F.layer_norm, fp32 weights on the bf16 x
    # where PyTorch takes them, else cast to bf16 (printed)
    for C, R in ((512, 163840), (1024, 40960), (2048, 40960)):
        xt = randn(R, C)
        scale = 1.0 + randn(C, scale=0.5, dtype=f32)
        shift = randn(C, scale=0.5, dtype=f32)
        try:
            F.layer_norm(xt, (C,), scale, shift, 1e-5)
            lib_w, how = (scale, shift), "fp32 weights"
        except RuntimeError:
            lib_w, how = (scale.to(bf16), shift.to(bf16)), "weights cast"
        case = f"({R}, {C})"
        compare("fused_layer_norm", case,
                lambda: fused_layer_norm(xt, scale, shift),
                lambda: layer_norm_ref(xt, scale, shift),
                (8 * R * C, 2 * R * C * 2 + 2 * C * 4, PEAK_F32),
                lambda: F.layer_norm(xt, (C,), *lib_w, 1e-5), device=True)
        print(f"  {'':22s} {case:34s} F.layer_norm with {how}", flush=True)
        want = layer_norm_ref(xt, scale, shift)
        planted("fused_layer_norm", case, "without its bias",
                rel_err(layer_norm_ref(xt, scale, torch.zeros_like(shift)),
                    want))
        del xt, want
        torch.cuda.empty_cache()

    # row 17 at three of the conv profiler's shapes, and at the serving
    # ASPP's dilated branches (not routed there): the model's shape, the
    # stage-2 output (bs 2, 32x40, `models/stswin.py:126`), and 64x80; the
    # library call: cuDNN's channels_last conv with the BN folded in, +
    # residual, ReLU
    for name, N, Hc, Wc, cin, cout, d, with_res in (
            ("layer5 512->512 d4 N4 res", 4, 64, 80, 512, 512, 4, True),
            ("layer4 256->256 d2 N32", 32, 64, 80, 256, 256, 2, False),
            ("layer1 64->64 d1 N4 res", 4, 128, 160, 64, 64, 1, True),
            ("ASPP 1024->512 d12 N2 32x40", 2, 32, 40, 1024, 512, 12, False),
            ("ASPP 1024->512 d18 N2 32x40", 2, 32, 40, 1024, 512, 18, False),
            ("ASPP 1024->512 d12 N2 64x80", 2, 64, 80, 1024, 512, 12, False),
            ("ASPP 1024->512 d18 N2 64x80", 2, 64, 80, 1024, 512, 18, False)):
        x = randn(N, Hc, Wc, cin)
        w = randn(cout, cin, 3, 3, scale=(9 * cin) ** -0.5)
        scale = 0.5 + torch.rand(cout, device=dev)
        shift = randn(cout, scale=0.5, dtype=f32)
        res = randn(N, Hc, Wc, cout) if with_res else None
        kw = dict(dilation=d, relu=True, residual=res)
        nbytes = (N * Hc * Wc * (cin + cout * (2 if with_res else 1)) * 2
                  + 9 * cin * cout * 2 + 2 * cout * 4)
        compare("conv3x3_bn_act", name,
                lambda: conv3x3_bn_act(x, w, scale, shift, **kw),
                lambda: conv3x3_bn_act_ref(x, w, scale, shift, **kw),
                (2 * N * Hc * Wc * 9 * cin * cout, nbytes),
                lambda: cudnn_conv_bn_act(x, w, scale, shift, d,
                                          residual=res), device=True)
        want = conv3x3_bn_act_ref(x, w, scale, shift, **kw)
        planted("conv3x3_bn_act", name, f"at dilation {d + 1}",
                rel_err(conv3x3_bn_act_ref(x, w, scale, shift,
                                       **dict(kw, dilation=d + 1)), want))
        # the tap order: w flipped along kx reads every tap's box at the
        # mirror offset ((kx - 1) d -> (1 - kx) d)
        planted("conv3x3_bn_act", name, "with w flipped along kx",
                rel_err(conv3x3_bn_act_ref(x, w.flip(-1), scale, shift,
                                           **kw), want))
        if with_res:
            planted("conv3x3_bn_act", name, "without its residual",
                    rel_err(conv3x3_bn_act_ref(x, w, scale, shift,
                                           **dict(kw, residual=None)),
                        want))
        if name.startswith("ASPP"):
            # models/aspp.py's own call (bf16 conv with its bias,
            # channels_last; its BatchNorm follows), with cuDNN's TF32
            # switch as this script sets it and at PyTorch's default
            xc = x.permute(0, 3, 1, 2)
            wc = w.to(memory_format=torch.channels_last)
            bc = shift.to(bf16)
            model_conv[name] = {}
            for tf32 in (False, True):
                torch.backends.cudnn.allow_tf32 = tf32
                model_conv[name][f"allow_tf32={tf32}"] = median_ms(
                    lambda: F.conv2d(xc, wc, bc, 1, d, d))
            torch.backends.cudnn.allow_tf32 = False
            print(f"  {'cuDNN conv alone':22s} {name:34s} the model's call "
                  f"(bf16, bias, channels_last): {model_conv[name]} ms",
                  flush=True)
        del x, w, res, want
        torch.cuda.empty_cache()
    return {"fused_mlp": {"linear_gelu_linear_ms": yardstick},
            "conv3x3_bn_act": {"aspp_model_conv_ms": model_conv}}


def phase_entry_points(dev, bf16, randn, wrappers, launches) -> dict:
    """Phase 6: the `Mlp` and `FusedLayerNorm` modules and the conv
    profiler, each with every launch count set to 0 first. Returns the
    `Mlp` module's forward time back to back beside cuBLAS's."""
    import torch
    from stswincl_tpu_torch.models.init import init_weights
    from stswincl_tpu_torch.models.swin import Mlp
    import torch.nn.functional as F
    from stswincl_tpu_torch.ops.layernorm import FusedLayerNorm
    from stswincl_tpu_torch.tools import profile_conv_kernel
    from stswincl_tpu_torch.tools.profile_swin_kernels import device_ms


    def drive(path, mod, plain, kname):
        """One forward without autograd and one with it, then backward,
        against the plain route on the same weights: one `kname` launch
        a forward and no other kernel."""
        reset_launches(wrappers)
        x = randn(2 * BS, 2, 64, 80, 512)  # the stage-1 serving clip
        with torch.no_grad():
            errs = {"forward": rel_err(mod(x), plain(x))}
        out, ref = mod(x), plain(x)
        g = randn(*out.shape)
        out.backward(g)
        ref.backward(g)
        torch.cuda.synchronize()
        launches[path], forms = read_launches(wrappers)
        check_gemm_launches(path, launches[path], forms, m_saved=0)
        for (n, a), b in zip(mod.named_parameters(), plain.parameters()):
            errs[n] = rel_err(a.grad, b.grad)
        print(f"  [{path}] {kname} launches {launches[path][kname]}; rel "
              f"err against the plain route: {errs}", flush=True)
        # the Hopper GEMM rows count the library's forms, which
        # check_gemm_launches holds above (row 12: two bf16 a forward)
        for k, n in launches[path].items():
            if k not in GEMM_ROWS:
                check(n == (2 if k == kname else 0), f"{path}: {k} "
                      f"launched {n} times in two forwards")
        for n, e in errs.items():
            check(e <= TOL_REL, f"{path}: {n} relative error {e}")

    gen = torch.Generator().manual_seed(0)
    mlp = init_weights(Mlp(512, 2048, 512, dtype=bf16), gen).to(dev)
    plain = Mlp(512, 2048, 512, dtype=bf16, kernels=False).to(dev)
    plain.load_state_dict(mlp.state_dict())
    drive("mlp_module", mlp, plain, "fused_mlp")
    # the module's forward back to back beside cuBLAS's three calls on the
    # same input and weights (bf16), after the path's counts were read
    x = randn(2 * BS, 2, 64, 80, 512)
    w16 = [t.detach().to(bf16) for t in (mlp.fc1.weight, mlp.fc1.bias,
                                         mlp.fc2.weight, mlp.fc2.bias)]
    with torch.no_grad():
        mod_ms = device_ms(lambda: mlp(x), 20)
        lib_ms = device_ms(lambda: F.linear(F.gelu(F.linear(
            x, w16[0], w16[1])), w16[2], w16[3]), 20)
    print(f"  [mlp_module] forward back to back {mod_ms:.4f} ms (row 12), "
          f"F.linear -> F.gelu -> F.linear {lib_ms:.4f} ms (cuBLAS) at "
          f"{tuple(x.shape)}", flush=True)
    module_ms = {"device_ms": mod_ms, "linear_gelu_linear_device_ms": lib_ms}
    del x

    ln = FusedLayerNorm(512).to(dev)
    with torch.no_grad():
        ln.weight.add_(randn(512, scale=0.5, dtype=torch.float32))
        ln.bias.add_(randn(512, scale=0.5, dtype=torch.float32))
    ln_plain = FusedLayerNorm(512, kernels=False).to(dev)
    ln_plain.load_state_dict(ln.state_dict())
    drive("layer_norm_module", ln, ln_plain, "fused_layer_norm")

    reset_launches(wrappers)
    reps = 3
    rows = profile_conv_kernel.main(["--reps", str(reps)])
    launches["profile_conv"], forms = read_launches(wrappers)
    check_gemm_launches("profile_conv", launches["profile_conv"], forms)
    want = sum(r["in_envelope"] for r in rows) * (
        reps + profile_conv_kernel.UNTIMED_CALLS)
    print(f"  [profile_conv] launches {launches['profile_conv']}; "
          f"{sum(r['in_envelope'] for r in rows)} of {len(rows)} shapes in "
          "the envelope", flush=True)
    for k, n in launches["profile_conv"].items():
        check(n == (want if k == "conv3x3_bn_act" else 0),
              f"profile_conv: {k} launched {n} times (expected "
              f"{want if k == 'conv3x3_bn_act' else 0})")
    return module_ms


def contrast_gates(dev, bf16, seed: int = CONTRAST_SEED) -> dict:
    """Phase 8 (a) on the batch of `seed`: stage-2 pretraining at full
    width, `ContrastEncoder(12, swin_dim 512, heads 4, depths (3, 3), bf16,
    256x448)`, its segmentor warm-started through
    `translate_seg_to_pretrain` from a seeded TswinPlus state,
    `ContrastTrainConfig`'s defaults (batch 4, six views of 4 frames, LARS
    base 1.0 scaled by 4 / 256 on the warmup-cosine schedule, EMA momentum
    0.99). One step on the plain route (each swin block recomputed in the
    backward, as phase 4's), one on the control route 'pallas_windows' and
    one on the kernel route, from the same weights and seeded batch: the
    loss within TOL_TRAIN_LOSS, the query gradients held as phase 4's
    (`hold_gradients`: the 1 - cosine against the control's; the floor,
    as repaired, at TOL_CONTRAST_GRAD_COS_FLOOR), both branches' BatchNorm
    statistics within TOL_STATS, on every route the EMA'd key parameters
    equal to m k + (1 - m) q of the step's inputs within 1e-6 and the
    `momentum` metric equal to `contrast_momentum(0)`. Returns the
    cosines by route."""
    import torch
    import torch.utils.checkpoint
    from stswincl_tpu_torch.ckpt import translate_seg_to_pretrain
    from stswincl_tpu_torch.configs import ContrastTrainConfig, DataConfig
    from stswincl_tpu_torch.models import ContrastEncoder, TswinPlus
    from stswincl_tpu_torch.models.aspp import ConvBNRelu
    from stswincl_tpu_torch.models.init import init_weights
    from stswincl_tpu_torch.models.swin import SpaceTimeSwinBlock
    from stswincl_tpu_torch.tools import profile_contrast
    from stswincl_tpu_torch.train import train_contrast as tc
    from stswincl_tpu_torch.train.optim import (make_lars, scale_lr_linear,
                                                warmup_cosine_schedule)

    cfg = ContrastTrainConfig(data=DataConfig(
        dataset="synthetic", crop_hw=CONTRAST_HW, batch_size=CONTRAST_BATCH))
    m_cfg = cfg.model
    kw = dict(num_classes=cfg.data.num_classes, swin_dim=m_cfg.swin_dim,
              num_heads=m_cfg.num_heads,
              swin_depths=tuple(m_cfg.swin_depths), dtype=bf16,
              input_hw=CONTRAST_HW)
    seg = init_weights(TswinPlus(**kw), torch.Generator().manual_seed(0))
    enc = init_weights(ContrastEncoder(**kw),
                       torch.Generator().manual_seed(1))
    init_state, skipped = translate_seg_to_pretrain(seg.state_dict(),
                                                    enc.state_dict())
    check(skipped == [], f"contrast: the warm start skipped {skipped}")
    del seg, enc
    # six views a sample, blocky labels (a class in [0, 12) per 32x32
    # block), a colour per class under noise, as `seeded_batch` draws them
    clips, labels = profile_contrast.seeded_batch(CONTRAST_BATCH, CONTRAST_HW,
                                                  seed)
    clips = torch.from_numpy(clips).to(dev)
    labels = torch.from_numpy(labels).to(dev).long()
    print(f"  ContrastEncoder {kw}, batch {CONTRAST_BATCH} (seed {seed}), "
          f"clips {tuple(clips.shape)}, labels {tuple(labels.shape)}",
          flush=True)
    total = cfg.num_epochs * CONTRAST_STEPS
    schedule = warmup_cosine_schedule(
        scale_lr_linear(cfg.base_lr, CONTRAST_BATCH),
        cfg.warmup_epochs * CONTRAST_STEPS, total,
        warmup_multiplier=cfg.warmup_multiplier)

    def one_step(route, kernels=None):
        """One contrast step from the initial weights on `route`; returns
        the loss, the query gradients, both branches' statistics, the
        image-pool modules (`few_value_batchnorms`) and the zero-gradient
        biases."""
        model = ContrastEncoder(**kw, attn_impl=route, kernels=kernels)
        model.load_state_dict(init_state)
        model.to(dev)
        state = tc.ContrastTrainState.create(model, lambda p: make_lars(
            p, schedule, weight_decay=cfg.weight_decay,
            trust_coefficient=cfg.lars_trust_coef))
        if kernels is False:
            for mod in itertools.chain(state.query.modules(),
                                       state.key.modules()):
                if isinstance(mod, SpaceTimeSwinBlock):
                    mod.forward = functools.partial(
                        torch.utils.checkpoint.checkpoint, mod.forward,
                        use_reentrant=False)
        step = tc.make_contrast_train_step(state, cfg.data.num_classes,
                                           total, cfg.momentum)
        q0 = {n: p.detach().clone() for n, p in state.query.named_parameters()}
        k0 = {n: p.detach().clone() for n, p in state.key.named_parameters()}
        grads, few = {}, set()
        state.opt.register_step_pre_hook(lambda *_: grads.update(
            {n: p.grad.detach().clone()
             for n, p in state.query.named_parameters()}))
        ts = time.perf_counter()
        with few_value_batchnorms(state.query, few):
            metrics = step(clips, labels)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        sec = time.perf_counter() - ts
        m = float(metrics["momentum"])
        check(m == tc.contrast_momentum(0, total, cfg.momentum),
              f"contrast {route}: momentum {m}")
        ema = max(((p - (k0[n] * m + q0[n] * (1 - m))).norm()
                   / (k0[n] * m + q0[n] * (1 - m)).norm().clamp(min=1e-30)
                   ).item() for n, p in state.key.named_parameters())
        check(ema <= 1e-6, f"contrast {route}: EMA'd key parameters off "
              f"m k + (1 - m) q by rel {ema}")
        stats = {f"{b}.{n}": t.detach().clone()
                 for b, mod in (("query", state.query), ("key", state.key))
                 for n, t in mod.named_buffers()
                 if n.endswith(("running_mean", "running_var"))}
        # biases whose gradient is zero in exact arithmetic: a conv bias
        # that feeds a train-mode BatchNorm, and the two whose per-channel
        # constant reaches the projector's BatchNorm through 1x1 convs
        # only (the ASPP's output conv, through the concat and linear1)
        zero_grad = {f"{n}.conv.bias" for n, mod in
                     state.query.named_modules()
                     if isinstance(mod, ConvBNRelu)}
        zero_grad |= {"segmentor.aspp.out_conv.bias", "projector.linear1.bias"}
        print(f"  (8a) [{route}{'' if kernels is None else ' plain'}] loss "
              f"{loss:.6f}, momentum {m}, EMA rel {ema:.2e}, step "
              f"{sec:.2f} s", flush=True)
        del state, step, model
        torch.cuda.empty_cache()
        return loss, grads, stats, few, zero_grad

    torch.cuda.reset_peak_memory_stats()
    loss_p, grads_p, stats_p, _, _ = one_step("pallas_full", kernels=False)
    results = {}
    for route in ("pallas_windows", "pallas_full"):
        loss_k, grads_k, stats_k, few, zero_grad = one_step(route)
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        print(f"  (8a) [{route}] loss kernel route {loss_k:.6f} plain route "
              f"{loss_p:.6f} (rel {loss_rel:.2e})", flush=True)
        check(loss_rel <= TOL_TRAIN_LOSS, f"contrast {route}: loss rel "
              f"{loss_rel}")
        control = results.get("pallas_windows")
        results[route] = hold_gradients(
            "(8a control)" if control is None else "(8a)", route, grads_k,
            grads_p, zero_grad, few, control,
            floor=TOL_CONTRAST_GRAD_COS_FLOOR)
        stat_rel = {n: ((stats_k[n] - b).norm() / b.norm()).item()
                    for n, b in stats_p.items()}
        worst = max(stat_rel.items(), key=lambda kv: kv[1])
        print(f"  (8a) [{route}] BatchNorm statistics of both branches after "
              f"the step: max rel {worst[1]:.2e} ({worst[0]}) over "
              f"{len(stat_rel)}", flush=True)
        check(worst[1] <= TOL_STATS, f"contrast {route}: BN statistic "
              f"{worst}")
        del grads_k
    del grads_p
    print(f"  (8a) peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          "allocated", flush=True)
    torch.cuda.empty_cache()
    return results


def phase_contrast(dev, bf16, smi, wrappers, launches) -> None:
    """Phase 8: (a) `contrast_gates` on the batch of CONTRAST_SEED; (b)
    `run_contrast_pretraining`, the entry point, on the synthetic contrast
    set at that configuration: one epoch of CONTRAST_STEPS steps, the
    checkpoints in a temporary directory deleted at the end. Finite
    losses, the query parameters moved and the key's apart from them, the
    checkpoint read back by `load_checkpoint` equal to the state, each
    kernel launched once per call of the block it serves (K1 and K2 per
    block call of the six key and two query forwards, K5 and K6 per block
    call with grad, K3 per patch merge) and the Hopper GEMMs by form;
    the median ms/step of steps 4-8 (CUDA events), samples/s and the peak
    memory. Its launches are the `contrast` path of the kernels line."""
    import tempfile

    import torch
    from stswincl_tpu_torch.ckpt import latest_step, load_checkpoint
    from stswincl_tpu_torch.configs import ContrastTrainConfig, DataConfig
    from stswincl_tpu_torch.models.swin import (PatchMerging,
                                                SpaceTimeSwinBlock)
    from stswincl_tpu_torch.ops.add_ln_mlp import mlp_output_saved
    from stswincl_tpu_torch.pipelines.contrast import run_contrast_pretraining
    from stswincl_tpu_torch.train import train_contrast as tc

    contrast_gates(dev, bf16)
    cfg = ContrastTrainConfig(data=DataConfig(
        dataset="synthetic", crop_hw=CONTRAST_HW, batch_size=CONTRAST_BATCH))
    steps_per_epoch = CONTRAST_STEPS

    # (b): the entry point
    calls = {"block": 0, "grad_block": 0, "merge": 0, "m_saved": 0}
    events, losses, hooked, q_first = [], [], [], {}

    def counter(mod, inputs, _):
        if isinstance(mod, PatchMerging):
            calls["merge"] += 1
            return
        calls["block"] += 1
        if torch.is_grad_enabled():
            calls["grad_block"] += 1
            calls["m_saved"] += mlp_output_saved(
                inputs[0].shape[-1], mod.mlp.fc1.weight.shape[0], bf16)

    real_call = tc.ContrastTrainStep.__call__

    def timed_call(self, clips_, labels_):
        if not hooked:
            for model in (self.state.query, self.state.key):
                hooked.extend(mod.register_forward_hook(counter)
                              for mod in model.modules()
                              if isinstance(mod, (SpaceTimeSwinBlock,
                                                  PatchMerging)))
            q_first.update({n: p.detach().clone() for n, p in
                            self.state.query.named_parameters()})
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = real_call(self, clips_, labels_)
        b.record()
        events.append((a, b))
        losses.append(out["loss"])
        return out

    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        cfg_b = ContrastTrainConfig(
            data=cfg.data, num_epochs=1,
            ckpt_dir=os.path.join(tmp, "ckpt"),
            log_dir=os.path.join(tmp, "log"))
        reset_launches(wrappers)
        torch.cuda.reset_peak_memory_stats()
        clocks = [gpu_clocks()]
        with unittest.mock.patch.object(tc.ContrastTrainStep, "__call__",
                                        timed_call):
            state = run_contrast_pretraining(cfg_b, device=dev)
        torch.cuda.synchronize()
        clocks.append(gpu_clocks())
        peak = torch.cuda.max_memory_allocated()
        launches["contrast"], forms = read_launches(wrappers)
        for h in hooked:
            h.remove()
        saved_step = latest_step(cfg_b.ckpt_dir)
        saved = load_checkpoint(cfg_b.ckpt_dir)
        live = state.state_dict()
        same = (saved["step"] == live["step"] == state.step
                and saved["opt"]["count"] == state.opt.count
                and all(torch.equal(saved[b][n], t.cpu())
                        for b in ("query", "key")
                        for n, t in live[b].items()))
        check(saved_step == state.step and same, f"contrast: checkpoint step "
              f"{saved_step} does not read back equal to the state at step "
              f"{state.step}")
    losses = [float(v) for v in losses]
    step_ms = [a.elapsed_time(b) for a, b in events]
    n = len(step_ms)
    print(f"  (8b) run_contrast_pretraining: {n} steps, losses "
          f"{[round(v, 5) for v in losses]}; launches {launches['contrast']};"
          f" swin block calls {calls['block']} ({calls['grad_block']} with "
          f"grad), patch merges {calls['merge']}", flush=True)
    check(n == steps_per_epoch and state.step == n,
          f"contrast: {n} steps, state at {state.step}")
    check(all(math.isfinite(v) for v in losses), f"contrast losses {losses}")
    big = [k for k, p in state.query.named_parameters() if p.dim() > 1]
    qparams = dict(state.query.named_parameters())
    kparams = dict(state.key.named_parameters())
    unmoved = [k for k in big if torch.equal(qparams[k], q_first[k])]
    check(unmoved == [], f"contrast: query parameters did not move: "
          f"{unmoved[:5]}")
    with_key = [k for k in big if torch.equal(qparams[k], kparams[k])]
    check(with_key == [], f"contrast: key parameters equal to the query's: "
          f"{with_key[:5]}")
    got = launches["contrast"]
    for k, want in (("swin_block_attention", calls["block"]),
                    ("swin_block_epilogue", calls["block"]),
                    ("patch_merge", calls["merge"]),
                    ("swin_block_attention_bwd", calls["grad_block"]),
                    ("swin_block_epilogue_bwd", calls["grad_block"])):
        check(got[k] == want and want > 0, f"contrast: {k} launched {got[k]} "
              f"times for {want} calls")
    # 8 steps x (6 key + 2 query forwards) x 14 block calls, 2 x 14 with grad
    check(calls["block"] == n * 8 * 14 and calls["grad_block"] == n * 2 * 14,
          f"contrast: block calls {calls}")
    for k in ("windowed_attention_image", "fused_window_attention",
              "whole_swin_block", "upsample_argmax"):
        check(got[k] == 0, f"contrast: {k} launched {got[k]} times")
    check_gemm_launches("contrast", got, forms, m_saved=calls["m_saved"])
    first = 3
    med = statistics.median(step_ms[first:])
    print(f"  (8b) [pallas_full] stage-2 pretraining {med:.2f} ms/step median "
          f"of steps {first + 1}-{n} (CUDA events), "
          f"{CONTRAST_BATCH / (med / 1e3):.2f} samples/s at batch "
          f"{CONTRAST_BATCH}, peak {peak / 2**30:.2f} GiB allocated on "
          f"{smi}", flush=True)
    print(f"  (8b) step ms {[round(v, 1) for v in step_ms]}; SM clock, power "
          f"draw, temperature before / after: {clocks}", flush=True)
    del state
    torch.cuda.empty_cache()


def phase_fp32(dev, wrappers, launches) -> None:
    """Phase 7: `build_model` with `ModelConfig(dtype="float32")` builds the
    model on the plain twins (`kernels=False`: the kernels take bf16 only).
    It serves `init_and_predict` + `predict_next` at full width, bs 2, and
    takes one stage-1 train step at batch 2: predictions in [0, 12), a
    finite loss, and no kernel launched."""
    import torch
    from stswincl_tpu_torch.configs import (DataConfig, ModelConfig,
                                            SegTrainConfig)
    from stswincl_tpu_torch.models.init import init_weights
    from stswincl_tpu_torch.pipelines.common import build_model
    from stswincl_tpu_torch.pipelines.seg import make_tx
    from stswincl_tpu_torch.pipelines.streaming import StreamingSegmenter
    from stswincl_tpu_torch.train.train_seg import make_seg_train_step

    cfg = SegTrainConfig(model=ModelConfig(dtype="float32"),
                         data=DataConfig(batch_size=BS))
    reset_launches(wrappers)
    model, classes = build_model(cfg.model, cfg.data, device=dev)
    check(model.kernels is False, "fp32 build_model: kernels "
          f"{model.kernels}, expected False")
    init_weights(model, torch.Generator().manual_seed(0))
    model.to(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    frames = torch.rand((BS, 5, H, W, 3), generator=gen, device=dev) * 2 - 1
    seg = StreamingSegmenter(model.eval(), out_hw=OUT_HW)
    ts = time.perf_counter()
    cache, pred0 = seg.init_and_predict(frames[:, 0:4])
    _, pred = seg.predict_next(cache, frames[:, 4])
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - ts
    for p in (pred0, pred):
        check(p.shape == (BS, *OUT_HW) and p.dtype == torch.int32,
              f"fp32 prediction {p.shape} {p.dtype}")
        check(0 <= int(p.min()) and int(p.max()) < classes,
              "fp32: class out of range")
    del seg, cache
    images, labels = seeded_batch(BS, seed=6)
    opt, schedule = make_tx(cfg, 1, model)
    step = make_seg_train_step(model, opt, schedule, cfg.loss,
                               ohem_thresh=cfg.ohem_thresh)
    torch.cuda.reset_peak_memory_stats()
    ts = time.perf_counter()
    loss = float(step(torch.from_numpy(images).to(dev),
                      torch.from_numpy(labels).to(dev).long())["loss"])
    torch.cuda.synchronize()
    step_s = time.perf_counter() - ts
    launches["fp32"] = read_launches(wrappers)[0]
    print(f"  [fp32] init_and_predict + predict_next {serve_s:.2f} s, "
          f"classes {torch.bincount(pred.flatten(), minlength=12).tolist()};"
          f" train step at batch {BS}: loss {loss:.6f}, {step_s:.2f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{launches['fp32']}", flush=True)
    check(math.isfinite(loss), f"fp32 train loss {loss}")
    for k, n in launches["fp32"].items():
        check(n == 0, f"fp32: {k} launched {n} times")
    del model, opt, step
    torch.cuda.empty_cache()


# a train-mode BatchNorm whose batch statistics cover at most this many
# values per channel (the ASPP image pool: one value per image and channel)
# normalises bf16 rounding by a variance of a few samples: the gradients
# through it (its own and its conv's) are held against a control route's
# 1 - cosine only, not against TOL_GRAD_COS_FLOOR (ROADMAP Queue 3)
BN_FEW_VALUES = 8


@contextlib.contextmanager
def few_value_batchnorms(model, found: set):
    """While the block runs, add to `found` the module of every train-mode
    BatchNorm of `model` (its parent: the conv + BatchNorm unit) whose
    batch statistics cover at most BN_FEW_VALUES values per channel."""
    from stswincl_tpu_torch.models.norm import BatchNorm
    names = {mod: n for n, mod in model.named_modules()}

    def hook(mod, args):
        x = args[0]
        if mod.training and x.numel() // x.shape[-1] <= BN_FEW_VALUES:
            found.add(names[mod].rsplit(".", 1)[0])
    handles = [mod.register_forward_pre_hook(hook)
               for mod in model.modules() if isinstance(mod, BatchNorm)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def noise_share(cosines, control):
    """Each gradient's 1 - cosine over its bound from the control's:
    TOL_NOISE_FACTOR times the control's plus TOL_NOISE_FLOOR."""
    return {n: (1 - c) / (TOL_NOISE_FACTOR * max(1 - control[n], 0)
                          + TOL_NOISE_FLOOR)
            for n, c in cosines.items()}


def cosines_of(grads_k, grads_p) -> dict:
    return {n: (grads_k[n].float().flatten() @ gp.float().flatten()
                / (grads_k[n].float().norm() * gp.float().norm())).item()
            for n, gp in grads_p.items()}


def hold_gradients(tag, route, grads_k, grads_p, zero_grad, few, control,
                   floor=TOL_GRAD_COS_FLOOR):
    """Hold a kernel route's gradients against its plain route's: the
    gradients in `zero_grad` (conv biases feeding a train-mode BatchNorm:
    zero in exact arithmetic) to a norm bound; every other gradient's
    cosine at or above `floor`, except those under a module of `few`
    (`few_value_batchnorms`), whose cosines are printed; with
    `control` (the cosines of a sound route on the same batch), every
    gradient's 1 - cosine within its `noise_share` bound. Returns the
    cosines."""
    top = max(g.float().norm().item() for g in grads_p.values())
    for n in zero_grad:
        for which, gr in (("kernel", grads_k[n]), ("plain", grads_p[n])):
            check(gr.float().norm().item() <= 1e-3 * top,
                  f"{n} ({route}, {which}): gradient norm "
                  f"{gr.float().norm().item()} of a zero-gradient parameter "
                  f"against {top}")
    cosines = cosines_of(grads_k, {n: g for n, g in grads_p.items()
                                   if n not in zero_grad})
    exempt = {n for n in cosines if any(n.startswith(m + ".") for m in few)}
    held = {n: c for n, c in cosines.items() if n not in exempt}
    worst = sorted(held.items(), key=lambda kv: kv[1])[:5]
    print(f"  {tag} [{route}] gradient cosine, {len(held)} parameters held "
          f"to the floor {floor}: min {worst[0][1]:.5f} "
          f"({worst[0][0]}); lowest five {worst}; {len(zero_grad)} "
          f"zero-gradient conv biases below 1e-3 of the largest gradient "
          f"norm ({top:.3e})", flush=True)
    print(f"  {tag} [{route}] behind a BatchNorm of <= {BN_FEW_VALUES} "
          f"values a channel ({sorted(few)}), not held to the floor: "
          f"{ {n: round(cosines[n], 5) for n in sorted(exempt)} }",
          flush=True)
    low = {n: c for n, c in cosines.items() if c < TOL_GRAD_COS}
    print(f"  {tag} [{route}] {len(low)} gradient cosines below "
          f"{TOL_GRAD_COS}: {low}", flush=True)
    for n, c in held.items():
        check(c >= floor, f"{route}: gradient of {n}: cosine {c} below "
              f"{floor}")
    if control is not None:
        # 1 - cosine against the control's: rounding alone keeps the two
        # alike, a fault in this route's kernels lifts this one
        share = noise_share(cosines, control)
        top5 = sorted(share.items(), key=lambda kv: -kv[1])[:5]
        print(f"  {tag} [{route}] 1 - cos over its bound from the "
              f"control ({TOL_NOISE_FACTOR} x the control's + "
              f"{TOL_NOISE_FLOOR}): max {top5[0][1]:.3f} ({top5[0][0]}: "
              f"1 - cos {1 - cosines[top5[0][0]]:.3e}, control "
              f"{1 - control[top5[0][0]]:.3e}); highest five {top5}",
              flush=True)
        for n, r in share.items():
            check(r <= 1.0, f"{route}: gradient of {n}: 1 - cos "
                  f"{1 - cosines[n]} against the control's {1 - control[n]}")
    return cosines


def image_pool_bn_on_running_stats(model) -> None:
    """The planted fault of the image-pool path: the ASPP image pool's
    BatchNorm normalising with its running statistics in place of the
    batch's (as if left in eval mode)."""
    import torch
    bn = model.aspp.branch_img.bn

    def forward(x):
        x = x.float()
        return (x - bn.running_mean) * (
            torch.rsqrt(bn.running_var + bn.eps) * bn.weight) + bn.bias
    bn.forward = forward


def gpu_clocks() -> str:
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def phase_train(dev, bf16, smi, wrappers, route_kernel, launches,
                route_seed=ROUTE_TRAIN_SEED) -> None:
    """Phases 4, 4d and 4e, the latter two on the batch of `route_seed`;
    each train path's launches go into `launches`."""
    import torch
    import torch.utils.checkpoint
    from stswincl_tpu_torch.configs import SegTrainConfig
    from stswincl_tpu_torch.models import TswinPlus
    from stswincl_tpu_torch.models.aspp import ConvBNRelu
    from stswincl_tpu_torch.models.init import init_weights
    from stswincl_tpu_torch.models import swin as swin_models
    from stswincl_tpu_torch.models.swin import (PatchMerging,
                                                SpaceTimeSwinBlock)
    from stswincl_tpu_torch.ops.add_ln_mlp import mlp_output_saved
    from stswincl_tpu_torch.ops.swin_block import whole_swin_block_pair
    from stswincl_tpu_torch.pipelines.seg import make_tx
    from stswincl_tpu_torch.train.train_seg import make_seg_train_step

    cfg = SegTrainConfig()  # stage 1: Adam 3e-4 constant, OHEM 0.7
    TB = cfg.data.batch_size
    kw = dict(num_classes=cfg.model.num_classes, swin_dim=cfg.model.swin_dim,
              num_heads=cfg.model.num_heads,
              swin_depths=tuple(cfg.model.swin_depths),
              gelu_exact=cfg.model.gelu_exact, dtype=bf16, input_hw=(H, W))
    init_state = init_weights(TswinPlus(**kw),
                              torch.Generator().manual_seed(0)).state_dict()
    batches = {}
    for seed in (3, route_seed):
        images, labels = seeded_batch(TB, seed=seed)
        batches[seed] = (torch.from_numpy(images).to(dev),
                         torch.from_numpy(labels).to(dev).long())
    print(f"  TswinPlus {kw}, batch {TB}, clips {tuple(images.shape)}",
          flush=True)

    def new_model(route, kernels=None, whole_block=False):
        m = TswinPlus(**kw, attn_impl=route, kernels=kernels,
                      whole_block=whole_block)
        m.load_state_dict(init_state)
        return m.to(dev)

    def new_step(m, steps_per_epoch):
        opt, schedule = make_tx(cfg, steps_per_epoch, m)
        return make_seg_train_step(m, opt, schedule, cfg.loss,
                                   ohem_thresh=cfg.ohem_thresh), opt

    def one_step(m, images, labels):
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

    def compare_routes(route, tag, images, labels, whole_block=False,
                       control=None, pair_m=False, plant_image_pool=False):
        """One step on the route's kernels and one on its plain form from
        the same weights and batch, held against each other
        (`hold_gradients`). The plain form recomputes each swin block in
        its backward (torch.utils.checkpoint, same numbers) so its twins'
        fp32 intermediates fit the card at batch 8. Every gradient cosine,
        a control run's too, is held at or above TOL_GRAD_COS_FLOOR but
        those behind a BatchNorm of at most BN_FEW_VALUES values a channel
        (the ASPP image pool at batch 8); those below the 0.99 of
        TOL_GRAD_COS are printed, not held: 0.99 sits at the bf16 noise
        floor of the few gradients that are sums over every token (the
        last blocks' LN and MLP biases: 0.9898-0.9910 on sound routes).
        `control`: the gradient cosines of a sound route on the same
        batch, each of which this route's 1 - cosine must also stay near.
        `pair_m` (with `whole_block`): the kernel route's W-MSA blocks run
        row 16's function on the pair's kernels (`whole_swin_block_pair`
        with m rounded: K1, K2's m-output form, K6 taking that m, K5) in
        place of row 16; the plain route is the same as without it.
        `plant_image_pool` (with `control`): one more plain step with the
        image-pool BatchNorm on its running statistics
        (`image_pool_bn_on_running_stats`), whose gradients behind that
        BatchNorm must miss their control bound tenfold. Returns the peak
        memory and the cosines."""
        torch.cuda.reset_peak_memory_stats()
        model = new_model(route, whole_block=whole_block)
        route = f"{route} whole_block" if whole_block else route
        blocks = contextlib.nullcontext()
        if pair_m:
            route = f"{route} (pair, m rounded)"
            blocks = unittest.mock.patch.object(
                swin_models, "whole_swin_block",
                functools.partial(whole_swin_block_pair, m_out=True))
        few = set()
        with blocks, few_value_batchnorms(model, few):
            loss_k, grads_k, stats_k, sec_k = one_step(model, images, labels)
        # a conv bias that feeds a train-mode BatchNorm has a zero
        # gradient in exact arithmetic (the BatchNorm removes the channel
        # mean): both routes hold rounding noise there, so it is held to a
        # norm bound
        zero_grad = {f"{n}.conv.bias" for n, mod in model.named_modules()
                     if isinstance(mod, ConvBNRelu)}
        del model

        def plain_step(fault=None):
            plain = new_model(route.split()[0], kernels=False,
                              whole_block=whole_block)
            for mod in plain.modules():
                if isinstance(mod, SpaceTimeSwinBlock):
                    mod.forward = functools.partial(
                        torch.utils.checkpoint.checkpoint, mod.forward,
                        use_reentrant=False)
            if fault is not None:
                fault(plain)
            out = one_step(plain, images, labels)
            del plain
            torch.cuda.empty_cache()
            return out

        loss_p, grads_p, stats_p, sec_p = plain_step()
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        print(f"  {tag} [{route}] loss kernel route {loss_k:.6f} plain route "
              f"{loss_p:.6f} (rel {loss_rel:.2e}); step {sec_k:.2f} s / "
              f"{sec_p:.2f} s", flush=True)
        check(loss_rel <= TOL_TRAIN_LOSS, f"{route}: train loss rel "
              f"{loss_rel}")
        cosines = hold_gradients(tag, route, grads_k, grads_p, zero_grad,
                                 few, control)
        stat_rel = {n: ((stats_k[n] - b).norm() / b.norm()).item()
                    for n, b in stats_p.items()}
        worst_stat = max(stat_rel.items(), key=lambda kv: kv[1])
        print(f"  {tag} [{route}] BatchNorm statistics after the step: max "
              f"rel {worst_stat[1]:.2e} ({worst_stat[0]}) over "
              f"{len(stat_rel)}", flush=True)
        check(worst_stat[1] <= TOL_STATS, f"{route}: BN statistic "
              f"{worst_stat}")
        if plant_image_pool:
            _, grads_f, _, _ = plain_step(image_pool_bn_on_running_stats)
            exempt = {n for n in cosines
                      if any(n.startswith(m + ".") for m in few)}
            share = noise_share(cosines_of(
                grads_k, {n: grads_f[n] for n in exempt}), control)
            print(f"  {tag} [{route}] planted fault, the plain route's image-"
                  f"pool BatchNorm on its running statistics: 1 - cos over "
                  f"the control bound {share}", flush=True)
            check(len(exempt) > 0 and max(share.values()) >= 10.0,
                  f"{route}: the planted image-pool fault moves the gated "
                  f"gradients by only {share} of their bound")
        return torch.cuda.max_memory_allocated(), cosines

    def train_path(route, n_steps, tag, peak_a, images, labels,
                   whole_block=False):
        """`n_steps` kernel-route steps on the repeated batch, the route's
        train main path: finite, falling losses, each kernel launched once
        per call of the block it serves, ms/step and peak memory. With
        `whole_block` row 16 serves the W-MSA blocks; their backward
        recomputes the K1 + K2 pair, so K1 and K2, like K5 and K6, run
        once per block call."""
        model = new_model(route, whole_block=whole_block)
        step, _ = new_step(model, n_steps)
        calls = {"block": 0, "merge": 0, "w": 0, "m_saved": 0}

        def counter(mod, inputs, _):
            if isinstance(mod, PatchMerging):
                calls["merge"] += 1
                return
            calls["block"] += 1
            calls["w"] += mod.shift_size == 0
            # the blocks whose K2 saves m for K6 (stage 2): the JAX routing
            calls["m_saved"] += mlp_output_saved(
                inputs[0].shape[-1], mod.mlp.fc1.weight.shape[0], bf16)
        hooks = [mod.register_forward_hook(counter)
                 for mod in model.modules()
                 if isinstance(mod, (SpaceTimeSwinBlock, PatchMerging))]
        path = ("train_whole_block" if whole_block else "train"
                if route == "pallas_full" else f"train_{route}")
        reset_launches(wrappers)
        torch.cuda.reset_peak_memory_stats()
        clocks = [gpu_clocks()]
        losses, events, host_s = [], [], []
        for _ in range(n_steps):
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
        launches[path], forms = read_launches(wrappers)
        for h in hooks:
            h.remove()
        peak = torch.cuda.max_memory_allocated()
        losses = [float(v) for v in losses]
        step_ms = [a.elapsed_time(b) for a, b in events]
        print(f"  {tag} [{route}] losses {[round(v, 5) for v in losses]}",
              flush=True)
        print(f"  {tag} [{route}] train-path launches {launches[path]}; swin "
              f"block calls {calls['block']}, patch merges {calls['merge']}",
              flush=True)
        check(all(math.isfinite(v) for v in losses), "non-finite train loss")
        check(losses[-1] < losses[0], f"{route}: loss did not fall: {losses}")
        whole = launches[path]["whole_swin_block"]
        check(whole == (calls["w"] if whole_block else 0),
              f"{route}: whole_swin_block: {whole} launches for "
              f"{calls['w']} W-MSA block calls (whole_block {whole_block})")
        per_block = [route_kernel[route], "swin_block_epilogue",
                     "swin_block_epilogue_bwd"]
        if route == "pallas_full":
            per_block.append("swin_block_attention_bwd")
        for k in per_block:
            check(launches[path][k] == calls["block"], f"{route}: {k}: "
                  f"{launches[path][k]} launches for {calls['block']} swin "
                  "block calls")
        for k in set(route_kernel.values()) - set(per_block):
            check(launches[path][k] == 0, f"{route}: {k} launched")
        if route != "pallas_full":
            check(launches[path]["swin_block_attention_bwd"] == 0,
                  f"{route}: K5 launched")
        check(launches[path]["patch_merge"] == calls["merge"],
              f"{route}: patch_merge: {launches[path]['patch_merge']} for "
              f"{calls['merge']}")
        check_gemm_launches(f"{tag} {route}", launches[path], forms,
                            m_saved=calls["m_saved"])
        first = min(3, n_steps - 2)
        med = statistics.median(step_ms[first:])
        print(f"  {tag} [{route}] {med:.2f} ms/step median of steps "
              f"{first + 1}-{n_steps} (CUDA events; host "
              f"{1e3 * statistics.median(host_s[first:]):.2f} ms), "
              f"{TB / (med / 1e3):.2f} clips/s at batch {TB}, peak "
              f"{peak / 2**30:.2f} GiB allocated (route comparison "
              f"{peak_a / 2**30:.2f} GiB) on {smi}", flush=True)
        print(f"  {tag} [{route}] step ms {[round(v, 1) for v in step_ms]}; "
              f"SM clock, power draw, temperature before / after the steps: "
              f"{clocks}", flush=True)

    # phase 4: (a) the 'pallas_full' kernel route against its plain form,
    # (b, c) ten steps of it. Each gradient cosine is held at or above
    # TOL_GRAD_COS_FLOOR, and its 1 - cos against that of a sound control
    # on the same batch: the 'pallas_windows' route. The two share the
    # register attention core forward (K1's attention step is row 11's
    # kernel), the Hopper GEMM (through K2), K2, K3 and K6, so a fault
    # there lifts both and the relative check cannot see it: the
    # absolute floor, and the kernel-against-twin and planted-fault
    # checks of phases 2, 2b and 2c, hold those kernels. They differ in
    # K1's qkv and proj GEMMs and its backward, K5.
    batch = batches[3]
    _, control = compare_routes("pallas_windows", "(4 control)", *batch)
    train_path("pallas_full", TRAIN_STEPS, "(b, c)",
               compare_routes("pallas_full", "(a)", *batch, control=control,
                              plant_image_pool=True)[0], *batch)
    # phases 4d and 4e run on a second batch. The control of 4d is phase
    # 4's route on that batch: it shares the same kernels as above (and
    # rows 10 and 11 run the same core). The control of 4e is its own
    # route with row 16's function on the pair's kernels: the W-MSA blocks
    # run K1 and K2's m-output form (m rounded before the residual add, as
    # row 16, its twin and the TPU kernel round it; 'pallas_full' adds the
    # fp32 m at stage 1), their backward K6 taking that m and K5, and the
    # plain route is 4e's own. Rounding m amplifies the kernel-against-
    # twin noise of the gradients that sum over every token, so a control
    # that adds the fp32 m calibrates 4e's bound too low: on this batch the
    # pair with m rounded, which runs no row 16, reads 1.20 of it on the
    # layers_4_sw relative-bias gradient (PERF.md). Both 4e runs are
    # printed against the 4d control too. All are held to the absolute
    # floor as well.
    batch = batches[route_seed]
    _, control = compare_routes("pallas_full", "(4d control)", *batch)
    for route in ("pallas", "pallas_windows"):
        train_path(route, ROUTE_TRAIN_STEPS, "(4d)",
                   compare_routes(route, "(4d)", *batch,
                                  control=control)[0], *batch)
    _, control_m = compare_routes("pallas_full", "(4e control)", *batch,
                                  whole_block=True, pair_m=True)
    peak, cosines = compare_routes("pallas_full", "(4e)", *batch,
                                   whole_block=True, control=control_m)
    for tag, cos in (("(4e control)", control_m), ("(4e)", cosines)):
        top = sorted(noise_share(cos, control).items(),
                     key=lambda kv: -kv[1])[:3]
        print(f"  {tag} 1 - cos over the bound from the 4d control (printed,"
              f" not held): highest three {top}", flush=True)
    train_path("pallas_full", ROUTE_TRAIN_STEPS, "(4e)", peak, *batch,
               whole_block=True)


if __name__ == "__main__":
    main()
