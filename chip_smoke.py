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
     tap) must drop the share of equal pixels to 0.99 or below. K4 also at
     the CaDIS protocol (the model's upsample 64x80 -> 512x640 composed
     with the half-pixel resize to 540x960, `align_out=False`, 9 classes)
     at B = 1 and 2, and at DeepLabV3+ ResNet50-OS16's head (B = 1,
     32x40 -> 1024x1280, output stride 16), to the same share and with
     the same two planted faults. K3 and K4 also record `device_ms`, the
     mean of back-to-back calls;
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
     ms/step, samples/s and peak memory (`phase_contrast`);
  9. stage 3, evaluation and the CLI at full width (`phase_eval`): (a)
     `cli.main(["finetune-cl", "--device", "cuda", ...])` in process on
     the synthetic set at 512x640, batch 8, 2 epochs of SGD on the poly
     schedule with `streaming_eval` and an evaluation every epoch,
     warm-started from a stage-2 checkpoint that `save_checkpoint` writes
     from a seeded `ContrastEncoder`: the encoder's entries equal the
     checkpoint's and the classifier keeps its init, the LR equals the
     poly schedule at every step, finite losses, the latest and `best/`
     checkpoints, each step's launches exact (K1, K2, K5, K6 14, K3 1,
     K2's m 8 through the GEMM forms), K4 once an evaluated frame;
     ms/step, clips/s, peak memory; (b) `test` on that checkpoint through
     the CLI, streamed and full clip: 7 of 8 frames streamed, the two
     summaries within TOL_EVAL_METRIC, the full-clip predictions against
     the plain route's (`kernels=False`) on >= TOL_PLAIN_SHARE of pixels,
     K4 once a frame, one PNG a frame at the label's size; eval frames/s
     and `sec_per_frame`; (c) `evaluate_split` streaming on a seeded
     EndoVis18 test tree (2 sequences of 12 frames, labels RGB at
     1024x1280 through `labels.json`): frames below t fall back, the rest
     stream, the summary within TOL_EVAL_METRIC of the plain route's; (d)
     the same on a seeded CaDIS test video (540x960 raw 36-class labels,
     tag 1): `eval_hw` becomes (540, 960), K4 at that geometry once a
     frame, PA / PAC / mIoU within TOL_EVAL_METRIC of the plain route's;
  10. the rest of the user's pipeline (`phase_rest`), at full width, on
     trees the phase writes: (a) `prepare_endovis.main` on a raw
     EndoVis18 release (1024x1280 frames and RGB labels, `labels.json`):
     the processed tree 640x512, labels decoded and subsampled, read by
     `EndovisDataset`, host seconds a frame; (b) the DeepLab pre-stage
     through `cli.main(["train-seg", "--device", "cuda",
     "model.arch=puredeeplab18", "data.t=1", ...])` at batch 8: finite
     losses, no swin-stack kernel in a step, K4 once an evaluated frame on
     DeepLab's head-resolution logits, kernel vs plain route on >=
     TOL_PLAIN_SHARE of pixels, `best/` written, ms/step; (c) stage 1
     through the CLI warm-started from (b) with `model.remat=true`: the
     resnet entries (b)'s, the rest as the tolerant merge gives them,
     each step's launches exactly REMAT_STEP (the forward kernels twice a
     block call); (d) remat against no remat on phase 4's batch and
     weights, and with `whole_block`: the loss bit-equal, the gradients
     within phase 4's gate and within TOL_REMAT_FACTOR of the same step's
     run-to-run spread without remat, the peak memory lower, ms/step of
     both; planted faults in one block's remat (without the graph; its
     recompute fed its two frames swapped) missing the spread's bound
     tenfold, another (its recompute one bf16 ulp off) printed;
     (e) stage 2 through `cli.main(["pretrain-contrast", ...,
     "data.rand_augment=rand-m9-mstd0.5"])` on a contrast tree: finite
     losses, 255 label pixels from the geometric ops reaching the loss
     and left out of it, launches per block call, host seconds a sample
     with and without the augment; (f) `DeepLabV3Plus(layers=50)`: bf16
     train steps at batch 2 (the median of the warmed ones printed), one
     evaluated frame with K4 once, its prediction against K4's twin on
     the same head logits on >= TOL_K4_SHARE of pixels; (g)
     `utils.profiling`: `device_trace` around two steps of (c) holds
     their `annotate` ranges and CUDA kernel events, `StepTimer` agrees
     with CUDA events within TOL_STEP_TIMER.

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
written once), and its launches per fine-tune step (batch 8), per
evaluated frame (B = 1, full clip and streamed), per stage-1 step with
remat (batch 8) and per evaluated DeepLabV3+ frame; the card's name and
power limit (`nvidia-smi`); and, last,
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
# the CaDIS eval protocol: tag 1's classes (CADIS_CLASS_NUM["1"], ignore
# included), scored at 540x960
CADIS_CLASSES, CADIS_HW = 9, (540, 960)
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


def check_gemm_launches(tag, counts, forms, m_saved=None,
                        m_used=None) -> None:
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
    None where the path does not say); `m_used`, where it differs, the
    K6 launches that take a saved m (with remat K2 saves m in the forward
    and again in the recompute, and K6 takes one of them)."""
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
        m_used = m_saved if m_used is None else m_used
        rules += [("resid_f32", forms["resid_f32"], k2 - m_saved),
                  ("gelu_bwd", forms["gelu_bwd"], m_used if k6 else 0)]
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

    def k4_case(x, ah, aw, s_h, s_w, exact, case, out_hw):
        """K4 on logits x with the matrix pair (ah, aw) and its spans,
        against its twin: the share of equal pixels, both timed."""
        k4 = functools.partial(upsample_argmax, x, ah, aw, exact,
                               spans=(s_h, s_w))
        got, want = k4(), upsample_argmax_ref(x, ah, aw, exact)
        torch.cuda.synchronize()
        check(got.shape == (x.shape[0], *out_hw) and got.dtype == torch.int32,
              f"upsample_argmax {case}: {got.shape} {got.dtype}")
        share = (got == want).float().mean().item()
        row = {"case": case,
               "max_abs_err": (got - want).abs().max().item(),
               "equal_share": share, "ms": median_ms(k4),
               "plain_ms": median_ms(
                   lambda: upsample_argmax_ref(x, ah, aw, exact)),
               "library_ms": None, "device_ms": device_ms(k4, 20),
               **bound(*k4_work(x.shape, s_h, s_w),
                       PEAK_F32 if exact else PEAK_BF16)}
        results.setdefault("upsample_argmax", []).append(row)
        print(f"  {'upsample_argmax':22s} {row['case']:34s} equal "
              f"{share:.6f} kernel {row['ms']:.4f} ms plain "
              f"{row['plain_ms']:.3f} ms back to back "
              f"{row['device_ms']:.4f} ms bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})", flush=True)
        check(share >= TOL_K4_SHARE, f"upsample_argmax {row['case']}: "
              f"{share} of pixels equal < {TOL_K4_SHARE}")

    def k4_faults(x, ah, aw, s_h, s_w, label):
        """Planted faults in the twin: each must drop the share of equal
        pixels to 0.99 or below, missing TOL_K4_SHARE's 1e-3 tenfold."""
        want = upsample_argmax_ref(x, ah, aw)
        for fault, (fh, fw) in (
                ("with the column matrix shifted by one output column",
                 (ah, aw.roll(1, dims=0))),
                ("with every span missing its last tap",
                 (without_last_tap(ah, s_h), without_last_tap(aw, s_w)))):
            share = (upsample_argmax_ref(x, fh, fw) == want).float().mean()
            print(f"  {'':22s} {label:34s} the twin {fault}: equal "
                  f"{share.item():.6f}", flush=True)
            check(share.item() <= 1 - 10 * (1 - TOL_K4_SHARE),
                  f"upsample_argmax {label}: the twin {fault} keeps "
                  f"{share.item()} of pixels equal")

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
        k4_case(lcf, ah, aw, s_h, s_w, exact,
                f"{tuple(lcf.shape)} {pair} exact={exact}", OUT_HW)
    k4_faults(lcf, mh, mw, sh, sw, "composed")
    # the CaDIS protocol (`pipelines/evaluate.eval_resolution`): the
    # model's half-pixel upsample 64x80 -> 512x640 composed with the
    # half-pixel eval resize to 540x960 (`align_out=False`), tag 1's
    # classes, at evaluation's batch 1 and at 2
    ch, cw = (m.to(dev) for m in composed_matrices(
        64, 80, (H, W), CADIS_HW, align_out=False))
    csh, csw = interp_spans(ch), interp_spans(cw)
    for b in (1, 2):
        lc = randn(b, CADIS_CLASSES, 64, 80, dtype=torch.float32)
        k4_case(lc, ch, cw, csh, csw, False,
                f"{tuple(lc.shape)} cadis -> {CADIS_HW}", CADIS_HW)
        if b == 1:
            k4_faults(lc, ch, cw, csh, csw, "cadis")
    # DeepLabV3+ ResNet50-OS16's head (phase 10 (f)): output stride 16, so
    # 32x40 -> 1024x1280 composed, each input column spanning 32 output
    # columns; evaluation's batch 1, the bf16 model's rounding (not exact)
    oh, ow = (m.to(dev) for m in composed_matrices(
        H // 16, W // 16, (H, W), OUT_HW))
    osh, osw = interp_spans(oh), interp_spans(ow)
    lo = randn(1, 12, H // 16, W // 16, dtype=torch.float32)
    k4_case(lo, oh, ow, osh, osw, False, f"{tuple(lo.shape)} os16 -> "
            f"{OUT_HW}", OUT_HW)
    k4_faults(lo, oh, ow, osh, osw, "os16")
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
    control4 = phase_train(dev, bf16, smi, wrappers, route_kernel, launches)
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

    # ---- phase 9: stage 3, evaluation and the CLI ------------------------
    t0 = time.perf_counter()
    eval_counts = phase_eval(dev, bf16, smi, wrappers, launches)
    print(f"phase 9 stage 3, test and the data paths: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 10: the rest of the pipeline ------------------------------
    t0 = time.perf_counter()
    rest_counts = phase_rest(dev, bf16, smi, wrappers, launches, control4)
    print(f"phase 10 the rest of the pipeline: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

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
        # phase 9: a fine-tune step at batch 8, an evaluated frame at B = 1
        r["per_finetune_step"] = eval_counts["per_finetune_step"][r["name"]]
        r["per_eval_frame"] = {mode: counts[r["name"]] for mode, counts
                               in eval_counts["per_eval_frame"].items()}
        # phase 10: a stage-1 step with remat at batch 8 (c), an evaluated
        # DeepLabV3+ frame at B = 1 (b)
        r["per_remat_step"] = rest_counts["per_remat_step"][r["name"]]
        r["per_deeplab_eval_frame"] = rest_counts[
            "per_deeplab_eval_frame"][r["name"]]
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


# ---- phase 9: stage 3, evaluation and the CLI ------------------------------

# phase 9 (a): the stage-3 run that `finetune-cl` drives: 2 epochs of the
# synthetic set (64 clips at batch 8: 8 steps an epoch), an evaluation
# after each, SGD on the poly schedule at the `finetune-cl` defaults' rate
FT_EPOCHS, FT_STEPS_PER_EPOCH, FT_LR = 2, 8, 1e-3
FT_ENCODER_SEED = 5   # the stage-2 checkpoint's encoder weights
# a training step at depths (3, 3) under final_pair_only: 14 swin block
# calls with grad (6 at stage 1, 8 at stage 2, whose K2 saves m:
# `mlp_output_saved` at C 1024) and one patch merge
FT_BLOCKS, FT_M_SAVED, FT_MERGES = 14, 8, 1
# a summary metric: streamed vs full clip, kernel route vs plain route
TOL_EVAL_METRIC = 1e-3
EV_SEQS, EV_FRAMES = (1, 2), 12     # phase 9 (c)'s EndoVis18 test tree
CADIS_VIDEO, CADIS_FRAMES = 2, 12   # phase 9 (d)'s CaDIS test video


def launch_delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def metric_diff(a: dict, b: dict) -> float:
    """The largest difference between two summaries' metrics (numbers and
    per-class / per-sequence lists, NaN equal to NaN; not the times or
    frame counts)."""
    import numpy as np
    worst = 0.0
    for k, v in a.items():
        if k in ("sec_per_frame", "streamed_frames", "frames"):
            continue
        x, y = np.asarray(v, np.float64), np.asarray(b[k], np.float64)
        d = np.where(np.isnan(x) & np.isnan(y), 0.0, np.abs(x - y))
        worst = max(worst, float(np.nan_to_num(d, nan=np.inf).max()))
    return worst


class EvalSpy:
    """Stands in for `evaluate_split` where a pipeline calls it: records
    each call's wall seconds, summary and kernel launches (the counts read
    before and after it; reading them does not synchronise)."""

    def __init__(self, real, wrappers):
        self.real, self.wrappers, self.calls = real, wrappers, []

    def __call__(self, *args, **kw):
        import torch
        before, forms0 = read_launches(self.wrappers)
        t = time.perf_counter()
        summary = self.real(*args, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        after, forms1 = read_launches(self.wrappers)
        self.calls.append({"summary": summary, "wall": wall,
                           "launches": launch_delta(after, before),
                           "forms": launch_delta(forms1, forms0)})
        return summary


def pngs(d: str) -> dict:
    """The PNGs under `d` by file name, as arrays."""
    import glob

    import numpy as np
    from PIL import Image
    return {os.path.basename(p): np.asarray(Image.open(p))
            for p in sorted(glob.glob(os.path.join(d, "*.png")))}


def plain_twin(num_classes, state_dict, dev, input_hw=(H, W)):
    """The TswinPlus of `ModelConfig()` (full width, bf16) with
    `state_dict` on the plain twins (`kernels=False`), on the card."""
    from stswincl_tpu_torch.configs import ModelConfig
    from stswincl_tpu_torch.models import TswinPlus
    from stswincl_tpu_torch.pipelines.common import resolve_dtype
    cfg = ModelConfig()
    m = TswinPlus(num_classes, swin_dim=cfg.swin_dim,
                  num_heads=cfg.num_heads,
                  swin_depths=tuple(cfg.swin_depths),
                  dtype=resolve_dtype(cfg.dtype), input_hw=input_hw,
                  kernels=False)
    m.load_state_dict(state_dict)
    return m.to(dev).eval()


def eval_rate(tag, spy_call, smi) -> None:
    s = spy_call["summary"]
    print(f"  [{tag}] {s['frames']} frames at B = 1: "
          f"{s['frames'] / spy_call['wall']:.2f} frames/s over the split "
          f"(host decode overlapped), sec_per_frame {s['sec_per_frame']:.5f}"
          f" (median, device work and the copy back) on {smi}", flush=True)


def phase_finetune(dev, bf16, smi, wrappers, launches, tmp) -> tuple:
    """Phase 9 (a): stage 3 through the CLI's `main`, in process.

    A stage-2 checkpoint written with `save_checkpoint` from a seeded
    `ContrastEncoder` (its query branch) warm-starts `finetune-cl
    --device cuda data.dataset=synthetic` at 512x640, batch 8, for
    FT_EPOCHS epochs of SGD on the poly schedule with `streaming_eval` and
    an evaluation every epoch. Held: the encoder's entries equal the
    checkpoint's after the warm start and the classifier keeps its init;
    the LR of both parameter groups equals the poly schedule at every
    step; finite losses; the latest and `best/` checkpoints; each step's
    launches exactly what its block calls imply (K1, K2 FT_BLOCKS, K5, K6
    FT_BLOCKS, K3 FT_MERGES, K2's m FT_M_SAVED through the GEMM forms),
    none of K4; each evaluation's K4 once a frame. Prints ms/step (CUDA
    events, median of the steps after the third), clips/s and the peak
    memory. Returns (the checkpoint directory, the per-step launches)."""
    import torch
    from stswincl_tpu_torch import cli
    from stswincl_tpu_torch.ckpt import latest_step, save_checkpoint
    from stswincl_tpu_torch.configs import ContrastTrainConfig, DataConfig
    from stswincl_tpu_torch.models.swin import (PatchMerging,
                                                SpaceTimeSwinBlock)
    from stswincl_tpu_torch.ops.add_ln_mlp import mlp_output_saved
    from stswincl_tpu_torch.pipelines import seg as seg_pipeline
    from stswincl_tpu_torch.pipelines.contrast import build_contrast_encoder
    from stswincl_tpu_torch.train import train_seg
    from stswincl_tpu_torch.train.optim import poly_schedule

    stage2 = os.path.join(tmp, "stage2")
    enc = build_contrast_encoder(ContrastTrainConfig(data=DataConfig(
        crop_hw=(H, W), seed=FT_ENCODER_SEED)), 12, dev)
    save_checkpoint(stage2, 0, {"query": enc.state_dict(), "step": 0})
    query = {k: v.detach().cpu() for k, v in enc.state_dict().items()}
    del enc
    torch.cuda.empty_cache()

    calls = {"block": 0, "grad_block": 0, "merge": 0, "m_saved": 0}
    warm, steps, hooks = {}, [], []

    def counter(mod, inputs, _):
        if isinstance(mod, PatchMerging):
            calls["merge"] += 1
            return
        calls["block"] += 1
        if torch.is_grad_enabled():
            calls["grad_block"] += 1
            calls["m_saved"] += mlp_output_saved(
                inputs[0].shape[-1], mod.mlp.fc1.weight.shape[0], bf16)

    real_warm = seg_pipeline._warm_start

    def spy_warm(cfg, model, logger):
        warm["init"] = {k: v.detach().cpu().clone()
                        for k, v in model.state_dict().items()}
        out = real_warm(cfg, model, logger)
        warm["after"] = {k: v.detach().cpu().clone()
                         for k, v in model.state_dict().items()}
        hooks.extend(m.register_forward_hook(counter) for m in model.modules()
                     if isinstance(m, (SpaceTimeSwinBlock, PatchMerging)))
        return out

    real_call = train_seg.SegTrainStep.__call__

    def timed_call(self, images, labels):
        before, forms0 = read_launches(wrappers)
        calls0 = dict(calls)
        step = self.step
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = real_call(self, images, labels)
        b.record()
        after, forms1 = read_launches(wrappers)
        steps.append({"step": step, "events": (a, b), "loss": out["loss"],
                      "lrs": [g["lr"] for g in self.opt.param_groups],
                      "mults": [g["lr_mult"] for g in self.opt.param_groups],
                      "opt": type(self.opt).__name__,
                      "launches": launch_delta(after, before),
                      "forms": launch_delta(forms1, forms0),
                      "calls": launch_delta(calls, calls0)})
        return out

    ckpt = os.path.join(tmp, "stage3")
    argv = ["finetune-cl", "--device", "cuda", "data.dataset=synthetic",
            f"data.crop_hw=({H},{W})", "data.batch_size=8",
            "optimizer=sgd", f"lr={FT_LR}", "lr_scheduler=poly",
            f"num_epochs={FT_EPOCHS}", "eval_every=1", "streaming_eval=true",
            f"pretrain_checkpoint={stage2}", f"ckpt_dir={ckpt}",
            f"log_dir={os.path.join(tmp, 'stage3_log')}"]
    print(f"  (9a) python -m stswincl_tpu_torch.cli {' '.join(argv)}",
          flush=True)
    spy = EvalSpy(seg_pipeline.evaluate_split, wrappers)
    reset_launches(wrappers)
    torch.cuda.reset_peak_memory_stats()
    with unittest.mock.patch.object(seg_pipeline, "_warm_start", spy_warm), \
            unittest.mock.patch.object(train_seg.SegTrainStep, "__call__",
                                       timed_call), \
            unittest.mock.patch.object(seg_pipeline, "evaluate_split", spy):
        cli.main(argv)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    for h in hooks:
        h.remove()

    # the warm start: the encoder subtrees from the checkpoint's query
    # branch, the classifier at its seeded init
    moved = [k for k, v in warm["after"].items() if not k.startswith(
        "classifier.") and not torch.equal(v, query["segmentor." + k])]
    kept = [k for k, v in warm["after"].items() if k.startswith(
        "classifier.") and torch.equal(v, warm["init"][k])]
    n_cls = sum(k.startswith("classifier.") for k in warm["after"])
    print(f"  (9a) warm start: {len(warm['after']) - n_cls} encoder entries "
          f"from the stage-2 checkpoint ({len(moved)} differ), {len(kept)} "
          f"of {n_cls} classifier entries at their init", flush=True)
    check(moved == [] and len(kept) == n_cls > 0,
          f"finetune: warm start: encoder entries not from the checkpoint "
          f"{moved[:5]}, classifier entries kept {len(kept)} of {n_cls}")

    n = len(steps)
    total = FT_EPOCHS * FT_STEPS_PER_EPOCH
    check(n == total and [s["step"] for s in steps] == list(range(total)),
          f"finetune: {n} steps, expected {total}")
    poly = poly_schedule(FT_LR, total)
    lr_err = max(abs(lr - poly(s["step"]) * m) for s in steps
                 for lr, m in zip(s["lrs"], s["mults"]))
    print(f"  (9a) optimizer {steps[0]['opt']}, {len(steps[0]['lrs'])} "
          f"groups (lr_mult {steps[0]['mults']}); LR by step "
          f"{[round(s['lrs'][0], 8) for s in steps]}; largest difference "
          f"from the poly schedule {lr_err:.3e}", flush=True)
    check(steps[0]["opt"] == "SGD" and lr_err <= 1e-15,
          f"finetune: {steps[0]['opt']}, LR off the poly schedule by "
          f"{lr_err}")
    losses = [float(s["loss"]) for s in steps]
    check(all(math.isfinite(v) for v in losses), f"finetune losses {losses}")
    check(latest_step(ckpt) == total
          and latest_step(os.path.join(ckpt, "best")) is not None,
          f"finetune: latest checkpoint {latest_step(ckpt)}, best "
          f"{latest_step(os.path.join(ckpt, 'best'))}")

    per_step = steps[-1]["launches"]
    for s in steps:
        got, c = s["launches"], s["calls"]
        for k, want in (("swin_block_attention", FT_BLOCKS),
                        ("swin_block_epilogue", FT_BLOCKS),
                        ("patch_merge", FT_MERGES),
                        ("swin_block_attention_bwd", FT_BLOCKS),
                        ("swin_block_epilogue_bwd", FT_BLOCKS),
                        ("upsample_argmax", 0)):
            check(got[k] == want, f"finetune step {s['step']}: {k} launched "
                  f"{got[k]} times, the step implies {want}")
        check((c["grad_block"], c["merge"], c["m_saved"])
              == (FT_BLOCKS, FT_MERGES, FT_M_SAVED),
              f"finetune step {s['step']}: block calls {c}")
        check_gemm_launches(f"finetune step {s['step']}", got, s["forms"],
                            m_saved=c["m_saved"])
    launches["finetune"] = {k: sum(s["launches"][k] for s in steps)
                            for k in per_step}
    check(len(spy.calls) == FT_EPOCHS, f"finetune: {len(spy.calls)} "
          f"evaluations for {FT_EPOCHS} epochs")
    launches["finetune_eval"] = {k: sum(c["launches"][k] for c in spy.calls)
                                 for k in per_step}
    for i, c in enumerate(spy.calls):
        s = c["summary"]
        check(c["launches"]["upsample_argmax"] == s["frames"]
              and s["streamed_frames"] == s["frames"] - 1,
              f"finetune evaluation {i}: K4 {c['launches']['upsample_argmax']}"
              f" launches, {s['streamed_frames']} of {s['frames']} frames "
              "streamed")
        check_gemm_launches(f"finetune evaluation {i}", c["launches"],
                            c["forms"], m_saved=0)
        eval_rate(f"finetune evaluation {i}", c, smi)
    step_ms = [a.elapsed_time(b) for a, b in (s["events"] for s in steps)]
    med = statistics.median(step_ms[3:])
    print(f"  (9a) [pallas_full] stage-3 fine-tune {med:.2f} ms/step median "
          f"of steps 4-{n} (CUDA events), {8 / (med / 1e3):.2f} clips/s at "
          f"batch 8, peak {peak / 2**30:.2f} GiB allocated on {smi}; losses "
          f"{[round(v, 4) for v in losses]}; per-step launches {per_step}",
          flush=True)
    return ckpt, per_step


def phase_test(dev, smi, wrappers, launches, ckpt, tmp) -> dict:
    """Phase 9 (b): `test` on phase 9 (a)'s checkpoint through the CLI's
    `main`, once with `streaming_eval=true` and once without, each
    dumping its predictions: 7 of the 8 frames streamed, every metric of
    the two summaries within TOL_EVAL_METRIC, K4 once a frame, one PNG a
    frame at the label's size; the full-clip predictions against the
    plain route's (`kernels=False`, the same weights) on >=
    TOL_PLAIN_SHARE of pixels. Prints eval frames/s and sec_per_frame.
    Returns the launches per evaluated frame, full clip and streamed."""
    import numpy as np
    import torch
    from stswincl_tpu_torch import cli
    from stswincl_tpu_torch.ckpt import load_checkpoint
    from stswincl_tpu_torch.configs import DataConfig, SegTrainConfig
    from stswincl_tpu_torch.data.loader import SyntheticSegDataset
    from stswincl_tpu_torch.pipelines import evaluate as evaluate_mod

    spy = EvalSpy(evaluate_mod.evaluate_split, wrappers)
    viz = {}
    for streaming in (True, False):
        viz[streaming] = os.path.join(tmp, f"viz_streaming_{streaming}")
        argv = ["test", "--device", "cuda", "data.dataset=synthetic",
                f"data.crop_hw=({H},{W})", f"test_checkpoint={ckpt}",
                f"streaming_eval={str(streaming).lower()}",
                f"viz_dir={viz[streaming]}",
                f"log_dir={os.path.join(tmp, 'test_log')}"]
        reset_launches(wrappers)
        with unittest.mock.patch.object(evaluate_mod, "evaluate_split", spy):
            cli.main(argv)
        launches[f"test_streaming_{str(streaming).lower()}"] = \
            spy.calls[-1]["launches"]
    streamed, full = (c["summary"] for c in spy.calls)
    diff = metric_diff(streamed, full)
    print(f"  (9b) test, streamed {streamed}", flush=True)
    print(f"  (9b) test, full clip {full}", flush=True)
    print(f"  (9b) streamed vs full clip: largest metric difference "
          f"{diff:.3e}; {streamed['streamed_frames']} of "
          f"{streamed['frames']} frames streamed", flush=True)
    check(streamed["streamed_frames"] == streamed["frames"] - 1,
          f"test: {streamed['streamed_frames']} of {streamed['frames']} "
          "frames streamed")
    check(diff <= TOL_EVAL_METRIC, f"test: streamed vs full clip metrics "
          f"differ by {diff} > {TOL_EVAL_METRIC}")
    for c, mode in zip(spy.calls, ("streamed", "full clip")):
        check(c["launches"]["upsample_argmax"] == c["summary"]["frames"],
              f"test {mode}: K4 launched {c['launches']['upsample_argmax']} "
              f"times for {c['summary']['frames']} frames")
        check_gemm_launches(f"test {mode}", c["launches"], c["forms"],
                            m_saved=0)
        eval_rate(f"test {mode}", c, smi)
    per_frame = {mode: {k: v / c["summary"]["frames"]
                        for k, v in c["launches"].items()}
                 for c, mode in zip(spy.calls, ("streamed", "full_clip"))}

    # the plain route on the same weights and frames
    ds = SyntheticSegDataset(length=8, t=4, hw=(H, W), num_classes=12)
    label_hw = ds.get(0)["label"].shape
    dumps = {m: pngs(viz[m]) for m in viz}
    plain = plain_twin(12, load_checkpoint(ckpt)["model"], dev, (H, W))
    plain_dir = os.path.join(tmp, "viz_plain")
    reset_launches(wrappers)
    evaluate_mod.evaluate_split(plain, ds, SegTrainConfig(
        data=DataConfig(dataset="synthetic"), viz_dir=plain_dir),
        streaming=False)
    plain_launches = read_launches(wrappers)[0]
    ref = pngs(plain_dir)
    check(all(len(d) == len(ds) and all(a.shape == (*label_hw, 3)
                                        for a in d.values())
              for d in (*dumps.values(), ref)),
          f"test: viz dumps {[len(d) for d in dumps.values()]} PNGs, not "
          f"one a frame at {label_hw}")
    share = float(np.mean([(dumps[False][k] == ref[k]).all(-1).mean()
                           for k in ref]))
    print(f"  (9b) kernel route == plain route (full clip): {share:.6f} of "
          f"pixels over {len(ref)} frames", flush=True)
    check(share >= TOL_PLAIN_SHARE, f"test: kernel vs plain route {share} "
          f"< {TOL_PLAIN_SHARE}")
    check(sum(plain_launches.values()) == 0,
          f"test: the plain route launched kernels {plain_launches}")
    del plain
    torch.cuda.empty_cache()
    return per_frame


def endovis_tree(root: str) -> None:
    """A seeded EndoVis18-layout test split: `Processed_test/seq_N/
    left_frames/frame%03d.png` at 512x640, `test/seq_N/labels/
    frame%03d.png` RGB at 1024x1280 (blocks of the challenge colours, so
    that PNG encodes fast) and `train/labels.json`."""
    import numpy as np
    from PIL import Image
    from stswincl_tpu_torch.eval.visualization import ENDOVIS_COLORMAP
    rng = np.random.default_rng(12)
    os.makedirs(os.path.join(root, "train"))
    with open(os.path.join(root, "train", "labels.json"), "w") as f:
        json.dump([{"name": f"class{i}", "color": c.tolist(), "classid": i}
                   for i, c in enumerate(ENDOVIS_COLORMAP)], f)
    palette = rng.integers(0, 256, (12, 3))
    for s in EV_SEQS:
        imdir = os.path.join(root, "Processed_test", f"seq_{s}",
                             "left_frames")
        lbdir = os.path.join(root, "test", f"seq_{s}", "labels")
        os.makedirs(imdir)
        os.makedirs(lbdir)
        for i in range(EV_FRAMES):
            ids = rng.integers(0, 12, (16, 20))
            lab = np.kron(ids, np.ones((64, 64), np.int64))
            Image.fromarray(ENDOVIS_COLORMAP[lab]).save(
                os.path.join(lbdir, f"frame{i:03d}.png"))
            img = palette[np.kron(ids, np.ones((32, 32), np.int64))]
            img = img + rng.integers(-20, 21, (16, 20, 1)).repeat(
                32, 0).repeat(32, 1)
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                os.path.join(imdir, f"frame{i:03d}.png"))


def cadis_tree(root: str) -> None:
    """A seeded CaDIS-layout test video: `Video02/Images/*.png` and
    `Labels/*.png` at 540x960, the labels in raw 36-class ids (blocks)."""
    import numpy as np
    from PIL import Image
    rng = np.random.default_rng(13)
    imdir = os.path.join(root, f"Video{CADIS_VIDEO:02d}", "Images")
    lbdir = os.path.join(root, f"Video{CADIS_VIDEO:02d}", "Labels")
    os.makedirs(imdir)
    os.makedirs(lbdir)
    palette = rng.integers(0, 256, (36, 3))
    for i in range(CADIS_FRAMES):
        ids = rng.integers(0, 36, (9, 16))
        Image.fromarray(np.kron(ids, np.ones((60, 60), np.int64)).astype(
            np.uint8)).save(os.path.join(lbdir, f"frame{i:04d}.png"))
        img = palette[np.kron(ids, np.ones((60, 60), np.int64))]
        Image.fromarray(img.astype(np.uint8)).save(
            os.path.join(imdir, f"frame{i:04d}.png"))


def host_split(tag, ds, dataset, call) -> None:
    """Where an evaluated frame's time goes on the host: decoding one
    sample (`ds.get`, on the prefetch thread) and scoring one prediction
    (the metrics, on the loop's thread), medians of 3 on frame 0 against
    the split's wall time a frame; the card's busy share of a frame is at
    most sec_per_frame (device work, the copies and the host's launches)
    over that."""
    import numpy as np
    from stswincl_tpu_torch.eval import ConfusionMatrix, EndovisEvaluator
    sample = ds.get(0)
    label = sample["label"]
    pred = np.roll(label, 7, axis=1)
    get_s, score_s = [], []
    for _ in range(3):
        t = time.perf_counter()
        ds.get(0)
        get_s.append(time.perf_counter() - t)
        t = time.perf_counter()
        if dataset == "cadis":
            ConfusionMatrix(CADIS_CLASSES - 1).update(label, pred)
        else:
            EndovisEvaluator().update(label, pred, 1)
        score_s.append(time.perf_counter() - t)
    frame_s = call["wall"] / call["summary"]["frames"]
    print(f"  [{tag}] host a frame: decode {statistics.median(get_s):.4f} s "
          f"(prefetch thread), metrics {statistics.median(score_s):.4f} s; "
          f"{frame_s:.4f} s a frame over the split, sec_per_frame "
          f"{call['summary']['sec_per_frame']:.4f} s: the card busy at "
          f"most {call['summary']['sec_per_frame'] / frame_s:.3f} of a "
          "frame", flush=True)


def phase_datasets(dev, smi, wrappers, launches, ckpt, tmp) -> None:
    """Phases 9 (c) and (d): `evaluate_split` streaming on seeded EndoVis18
    and CaDIS test trees (written here), with models warm-started from
    phase 9 (a)'s checkpoint (`init_checkpoint`: the CaDIS model's last
    conv has 9 classes and keeps its init). (c): frames below t fall back
    to a full clip, the rest stream; (d): `eval_hw` becomes (540, 960) and
    K4 runs at that geometry. Each summary within TOL_EVAL_METRIC of the
    plain route's (`kernels=False`, the same weights, full clips), K4
    once a frame."""
    import logging

    import torch
    from stswincl_tpu_torch.configs import DataConfig, SegTrainConfig
    from stswincl_tpu_torch.data.cadis import CADIS_CLASS_NUM
    from stswincl_tpu_torch.ops import resize
    from stswincl_tpu_torch.pipelines import seg as seg_pipeline
    from stswincl_tpu_torch.pipelines.common import (build_model,
                                                     build_seg_dataset,
                                                     init_model_variables)
    from stswincl_tpu_torch.pipelines.evaluate import (eval_resolution,
                                                       evaluate_split)

    check(CADIS_CLASSES == CADIS_CLASS_NUM["1"], f"CADIS_CLASSES "
          f"{CADIS_CLASSES} != {CADIS_CLASS_NUM['1']}")
    logger = logging.getLogger("stswincl")
    for tag, dataset, write in (("endovis18", "endovis18", endovis_tree),
                                ("cadis", "cadis", cadis_tree)):
        t0 = time.perf_counter()
        root = os.path.join(tmp, tag)
        write(root)
        cfg = SegTrainConfig(
            data=DataConfig(dataset=dataset, root=root, tag="1"),
            init_checkpoint=ckpt, streaming_eval=True)
        if dataset == "endovis18":
            from stswincl_tpu_torch.data.endovis18 import EndovisDataset
            ds = EndovisDataset(root, "test", sequences=EV_SEQS,
                                frames_per_seq={s: EV_FRAMES
                                                for s in EV_SEQS})
            want_streamed = len(EV_SEQS) * (EV_FRAMES - 5)
        else:
            ds = build_seg_dataset(cfg.data, "test")
            want_streamed = CADIS_FRAMES - 6
        model, _ = build_model(cfg.model, cfg.data, dev)
        init_model_variables(model, cfg.data)
        seg_pipeline._warm_start(cfg, model, logger)
        eval_hw, align = eval_resolution(cfg)
        print(f"  (9{'c' if tag == 'endovis18' else 'd'}) [{tag}] "
              f"{len(ds)} frames written in {time.perf_counter() - t0:.1f} "
              f"s; eval_hw {eval_hw}, align_corners {align}", flush=True)
        shapes = []
        real_k4 = resize.upsample_argmax

        def k4_spy(x, mh, mw, *a, **k):
            shapes.append((tuple(x.shape), mh.shape[0], mw.shape[0]))
            return real_k4(x, mh, mw, *a, **k)

        spy = EvalSpy(evaluate_split, wrappers)
        reset_launches(wrappers)
        with unittest.mock.patch.object(resize, "upsample_argmax", k4_spy):
            got = spy(model, ds, cfg)
        launches[f"eval_{tag}"] = spy.calls[-1]["launches"]
        plain = plain_twin(model.num_classes, model.state_dict(), dev,
                           model.input_hw)
        del model
        want = evaluate_split(plain, ds, cfg, streaming=False)
        del plain
        torch.cuda.empty_cache()
        diff = metric_diff(got, want)
        print(f"  [{tag}] kernel route, streamed: {got}", flush=True)
        print(f"  [{tag}] plain route, full clips: {want}", flush=True)
        print(f"  [{tag}] largest metric difference {diff:.3e}; "
              f"{got['streamed_frames']} of {got['frames']} frames streamed;"
              f" K4 calls {len(shapes)} at {sorted(set(shapes))}",
              flush=True)
        eval_rate(f"{tag} streamed", spy.calls[-1], smi)
        host_split(tag, ds, dataset, spy.calls[-1])
        check(got["streamed_frames"] == want_streamed
              and got["frames"] == len(ds),
              f"{tag}: {got['streamed_frames']} of {got['frames']} frames "
              f"streamed, expected {want_streamed} of {len(ds)}")
        check(diff <= TOL_EVAL_METRIC, f"{tag}: kernel vs plain route "
              f"metrics differ by {diff} > {TOL_EVAL_METRIC}")
        out_hw = CADIS_HW if dataset == "cadis" else OUT_HW
        nc = CADIS_CLASSES if dataset == "cadis" else 12
        check(eval_hw == out_hw and len(shapes) == len(ds)
              and set(shapes) == {((1, nc, H // 8, W // 8), *out_hw)},
              f"{tag}: K4 at {set(shapes)}, {len(shapes)} calls for "
              f"{len(ds)} frames, eval_hw {eval_hw}")
        check(spy.calls[-1]["launches"]["upsample_argmax"] == len(ds),
              f"{tag}: K4 launched {spy.calls[-1]['launches']} times")


def phase_eval(dev, bf16, smi, wrappers, launches) -> dict:
    """Phase 9: (a) `phase_finetune`, (b) `phase_test`, (c) and (d)
    `phase_datasets`, in a temporary directory inside the checkout,
    deleted at the end. Returns the launches per fine-tune step and per
    evaluated frame for the kernels line."""
    import tempfile
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        t0 = time.perf_counter()
        ckpt, per_step = phase_finetune(dev, bf16, smi, wrappers, launches,
                                        tmp)
        print(f"phase 9 (a) stage 3 through the CLI: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        per_frame = phase_test(dev, smi, wrappers, launches, ckpt, tmp)
        print(f"phase 9 (b) test through the CLI: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        phase_datasets(dev, smi, wrappers, launches, ckpt, tmp)
        print(f"phase 9 (c, d) the EndoVis18 and CaDIS data paths: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {"per_finetune_step": per_step, "per_eval_frame": per_frame}


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
    """Each gradient's cosine to its counterpart; 0 where either is zero
    (a gradient that never arrived)."""
    out = {}
    for n, gp in grads_p.items():
        a, b = grads_k[n].float().flatten(), gp.float().flatten()
        den = (a.norm() * b.norm()).item()
        out[n] = (a @ b).item() / den if den > 0 else 0.0
    return out


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
                route_seed=ROUTE_TRAIN_SEED) -> dict:
    """Phases 4, 4d and 4e, the latter two on the batch of `route_seed`;
    each train path's launches go into `launches`. Returns phase 4's
    control cosines (the 'pallas_windows' kernel route against its plain
    form on the phase-4 batch), which phase 10 (d) holds remat to."""
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
    control4 = control
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
    return control4


# ---- phase 10: the rest of the pipeline -------------------------------------

# (a) the raw EndoVis18 release the phase writes: train and test sequences
# of 1024x1280 frames with RGB labels. The datasets' sequence and frame
# tables (the real release's 15 x 149 train and 4 x ~250 test frames) are
# set to this tree's while the CLI runs (the CLI has no option for them).
P10_SEQS, P10_TRAIN_FRAMES, P10_TEST_FRAMES = (1, 2), 8, 3
# (b) the DeepLab pre-stage and (c) stage 1 with remat: 16 train clips at
# batch 8, 2 steps an epoch; one evaluation, after the last epoch
P10_DEEPLAB_EPOCHS, P10_REMAT_EPOCHS = 2, 3
P10_STEPS_PER_EPOCH = len(P10_SEQS) * P10_TRAIN_FRAMES // 8
# (c) a stage-1 step with remat: each swin block call's forward kernels run
# twice (the forward, and its recompute in the backward); the patch merge
# (K3) is outside the checkpoint; the backward kernels run once a call
REMAT_STEP = {"swin_block_attention": 2 * FT_BLOCKS,
              "swin_block_epilogue": 2 * FT_BLOCKS,
              "patch_merge": FT_MERGES,
              "swin_block_attention_bwd": FT_BLOCKS,
              "swin_block_epilogue_bwd": FT_BLOCKS, "upsample_argmax": 0}
# (g) steps 1-3 of (c) timed by `StepTimer` (step 0 skipped) and CUDA
# events, which must agree within TOL_STEP_TIMER; steps 4-5 traced
P10_TIMED, P10_TRACED = (1, 2, 3), (4, 5)
TOL_STEP_TIMER = 0.10
# (d) the block whose remat the planted faults break
P10_FAULT_BLOCK = "layers_1_w"
P10_GATE_STEPS = 3   # timed steps after each gate step
# (d) remat's gradients against no remat's: 1 - cos within TOL_REMAT_FACTOR
# times that of the same step run twice without remat (the run-to-run
# spread of a backward that is not deterministic) plus TOL_NOISE_FLOOR
TOL_REMAT_FACTOR = 4.0
# (f) DeepLabV3+ ResNet50-OS16's train steps timed after the first
P10_D50_STEPS = 3
# (e) stage 2 with RandAugment on a contrast tree of 4 sequences (3 other
# videos give the negative clips), 4 anchor frames each: 16 samples, 4
# steps at batch 4. An anchor frame f < 4 reads the frames up to f + 4
# (the sampler's future-frame fallback), so 8 frames a sequence are on disk
P10_CONTRAST_SEQS, P10_CONTRAST_FRAMES = (1, 2, 3, 4), 4
P10_CONTRAST_ON_DISK = P10_CONTRAST_FRAMES + 4
RAND_AUGMENT = "rand-m9-mstd0.5"
# a DeepLabV3+ step runs none of the swin stack's kernels
SWIN_ROWS = ("swin_block_attention", "swin_block_epilogue", "patch_merge",
             "swin_block_attention_bwd", "swin_block_epilogue_bwd",
             "windowed_attention_image", "fused_window_attention",
             "whole_swin_block", "linear_sm90", "gelu_bwd_sm90",
             "wgrad_sm90")


def raw_endovis_release(root: str) -> dict:
    """A seeded raw EndoVis18 release as `prepare_endovis` reads it:
    `train/labels.json` (the challenge colours), `{train,test}/seq_N/
    left_frames/frame%03d.png` RGB at 1024x1280 and `labels/frame%03d.png`
    RGB colour labels (16 x 20 blocks of 64 pixels, each a class, so that
    PNG encodes fast): P10_TRAIN_FRAMES train frames a sequence, and
    P10_TEST_FRAMES scored test frames plus the 3 after them that their
    clips read. Returns the class-id blocks by (split, seq, frame)."""
    import numpy as np
    from PIL import Image
    from stswincl_tpu_torch.eval.visualization import ENDOVIS_COLORMAP
    rng = np.random.default_rng(14)
    os.makedirs(os.path.join(root, "train"))
    with open(os.path.join(root, "train", "labels.json"), "w") as f:
        json.dump([{"name": f"class{i}", "color": c.tolist(), "classid": i}
                   for i, c in enumerate(ENDOVIS_COLORMAP)], f)
    palette = rng.integers(0, 256, (12, 3))
    ids_of = {}
    # a scored test frame below t reads the t - 1 frames after it
    for split, n in (("train", P10_TRAIN_FRAMES),
                     ("test", P10_TEST_FRAMES + 3)):
        for s in P10_SEQS:
            imdir = os.path.join(root, split, f"seq_{s}", "left_frames")
            lbdir = os.path.join(root, split, f"seq_{s}", "labels")
            os.makedirs(imdir)
            os.makedirs(lbdir)
            for i in range(n):
                ids = rng.integers(0, 12, (16, 20))
                ids_of[split, s, i] = ids
                block = np.ones((64, 64), np.int64)
                Image.fromarray(ENDOVIS_COLORMAP[np.kron(ids, block)]).save(
                    os.path.join(lbdir, f"frame{i:03d}.png"))
                img = palette[np.kron(ids, block)] + rng.integers(
                    -20, 21, (16, 20, 1)).repeat(64, 0).repeat(64, 1)
                Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                    os.path.join(imdir, f"frame{i:03d}.png"))
    return ids_of


@contextlib.contextmanager
def endovis_tables():
    """The EndoVis18 dataset's sequence and frame tables set to the tree
    of `raw_endovis_release` (train: P10_SEQS x P10_TRAIN_FRAMES; test:
    P10_SEQS x P10_TEST_FRAMES, sequences 3-4 empty)."""
    from stswincl_tpu_torch.data import endovis18
    test = {s: (P10_TEST_FRAMES if s in P10_SEQS else 0)
            for s in endovis18.TEST_FRAMES}
    with unittest.mock.patch.object(endovis18, "TRAIN_SEQUENCES", P10_SEQS), \
            unittest.mock.patch.object(endovis18, "TRAIN_FRAMES",
                                       P10_TRAIN_FRAMES), \
            unittest.mock.patch.object(endovis18, "TEST_FRAMES", test):
        yield


def phase_prepare(tmp) -> str:
    """Phase 10 (a): `prepare_endovis.main` (the `python -m
    stswincl_tpu_torch.data.prepare_endovis` entry point) on the raw
    release the phase writes, both splits, into the same root (the test
    split's labels stay raw, where `EndovisDataset` reads them). Held:
    every processed frame 640x512 RGB, every train label a 640x512
    class-id PNG equal to the raw label decoded and subsampled 2x, and
    the processed tree read by `EndovisDataset` (train clips (4, 512, 640,
    3) with (512, 640) labels, test labels at 1024x1280). Prints the host
    seconds a frame. Returns the root."""
    import numpy as np
    from PIL import Image
    from stswincl_tpu_torch.data import prepare_endovis
    from stswincl_tpu_torch.data.endovis18 import EndovisDataset
    root = os.path.join(tmp, "endovis18")
    t = time.perf_counter()
    ids_of = raw_endovis_release(root)
    written = time.perf_counter() - t
    secs = {}
    for split in ("train", "test"):
        t = time.perf_counter()
        prepare_endovis.main(["--src", root, "--dst", root, "--split", split])
        secs[split] = time.perf_counter() - t
    n_train = len(P10_SEQS) * P10_TRAIN_FRAMES
    n_test = len(P10_SEQS) * P10_TEST_FRAMES
    n_raw_test = len(P10_SEQS) * (P10_TEST_FRAMES + 3)
    print(f"  (10a) raw release written in {written:.1f} s; prepare_endovis "
          f"{secs['train'] / n_train:.4f} s a train frame (resize + colour "
          f"decode of the 1024x1280 label + 2x subsampling), "
          f"{secs['test'] / n_raw_test:.4f} s a test frame (resize), on the "
          "host", flush=True)
    bad = []
    for (split, s, i), ids in ids_of.items():
        sub = "Processed_train" if split == "train" else "Processed_test"
        d = os.path.join(root, sub, f"seq_{s}")
        im = Image.open(os.path.join(d, "left_frames", f"frame{i:03d}.png"))
        if im.size != (640, 512) or im.mode != "RGB":
            bad.append(f"{split} {s} {i} image {im.size} {im.mode}")
        if split == "train":
            lab = Image.open(os.path.join(d, "labels",
                                          f"grayframe{i:03d}.png"))
            want = np.kron(ids, np.ones((32, 32), np.int64))
            if lab.size != (640, 512) or not np.array_equal(
                    np.asarray(lab), want):
                bad.append(f"train {s} {i} label {lab.size}")
    check(bad == [], f"prepare_endovis: processed tree wrong at {bad[:5]}")
    with endovis_tables():
        train = EndovisDataset(root, "train")
        test = EndovisDataset(root, "test")
        a = train.get(0, np.random.default_rng(0))
        b = test.get(len(test) - 1)
    check(len(train) == n_train and len(test) == n_test
          and a["image"].shape == (4, H, W, 3) and a["label"].shape == (H, W)
          and b["label"].shape == OUT_HW and b["label"].max() < 12,
          f"prepare_endovis: EndovisDataset reads {len(train)} / "
          f"{len(test)} samples, {a['image'].shape}, {a['label'].shape}, "
          f"{b['label'].shape}")
    return root


def seg_cli(argv, wrappers, step_probe=None) -> dict:
    """`cli.main(argv)` in process with every count set to 0 first, its
    train steps, warm start, evaluations and K4 calls spied. Returns
    {"steps": each step's loss, CUDA events and launches (and GEMM forms),
    "calls": the swin block calls with grad of each step, "evals":
    `EvalSpy` calls, "k4": K4's (input shape, OH, OW) a call, "warm": the
    model's state before and after the warm start, "peak": bytes}.
    `step_probe(i)` gives a context manager that each step i runs in."""
    import torch
    from stswincl_tpu_torch import cli
    from stswincl_tpu_torch.models.swin import (PatchMerging,
                                                SpaceTimeSwinBlock)
    from stswincl_tpu_torch.ops import resize
    from stswincl_tpu_torch.ops.add_ln_mlp import mlp_output_saved
    from stswincl_tpu_torch.pipelines import seg as seg_pipeline
    from stswincl_tpu_torch.train import train_seg

    out = {"steps": [], "k4": [], "warm": {}}
    calls = {"grad_block": 0, "merge": 0, "m_saved": 0}
    hooks = []

    def counter(mod, inputs, _):
        if not torch.is_grad_enabled():
            return
        if isinstance(mod, PatchMerging):
            calls["merge"] += 1
            return
        calls["grad_block"] += 1
        calls["m_saved"] += mlp_output_saved(
            inputs[0].shape[-1], mod.mlp.fc1.weight.shape[0],
            torch.bfloat16)

    real_warm = seg_pipeline._warm_start

    def spy_warm(cfg, model, logger):
        out["warm"]["init"] = {k: v.detach().cpu().clone()
                               for k, v in model.state_dict().items()}
        r = real_warm(cfg, model, logger)
        out["warm"]["after"] = {k: v.detach().cpu().clone()
                                for k, v in model.state_dict().items()}
        hooks.extend(m.register_forward_hook(counter) for m in model.modules()
                     if isinstance(m, (SpaceTimeSwinBlock, PatchMerging)))
        return r

    real_call = train_seg.SegTrainStep.__call__

    def timed_call(self, images, labels):
        i = len(out["steps"])
        probe = (step_probe(i) if step_probe is not None
                 else contextlib.nullcontext())
        before, forms0 = read_launches(wrappers)
        calls0 = dict(calls)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with probe:
            a.record()
            m = real_call(self, images, labels)
            b.record()
        after, forms1 = read_launches(wrappers)
        out["steps"].append({"events": (a, b), "loss": m["loss"],
                             "shape": tuple(images.shape),
                             "launches": launch_delta(after, before),
                             "forms": launch_delta(forms1, forms0),
                             "calls": launch_delta(calls, calls0)})
        return m

    real_k4 = resize.upsample_argmax

    def k4_spy(x, mh, mw, *a, **k):
        out["k4"].append((tuple(x.shape), mh.shape[0], mw.shape[0]))
        return real_k4(x, mh, mw, *a, **k)

    spy = EvalSpy(seg_pipeline.evaluate_split, wrappers)
    reset_launches(wrappers)
    torch.cuda.reset_peak_memory_stats()
    with unittest.mock.patch.object(seg_pipeline, "_warm_start", spy_warm), \
            unittest.mock.patch.object(train_seg.SegTrainStep, "__call__",
                                       timed_call), \
            unittest.mock.patch.object(seg_pipeline, "evaluate_split", spy), \
            unittest.mock.patch.object(resize, "upsample_argmax", k4_spy), \
            endovis_tables():
        cli.main(argv)
    torch.cuda.synchronize()
    out["peak"] = torch.cuda.max_memory_allocated()
    out["evals"] = spy.calls
    for h in hooks:
        h.remove()
    return out


def step_rate(tag, run, batch, smi, first=1) -> float:
    """Print a CLI run's median ms/step (CUDA events, the steps from
    `first`), clips/s and peak memory; returns the ms."""
    ms = [a.elapsed_time(b) for a, b in (s["events"] for s in run["steps"])]
    med = statistics.median(ms[first:])
    print(f"  {tag} {med:.2f} ms/step median of steps {first + 1}-{len(ms)} "
          f"(CUDA events; all {[round(v, 1) for v in ms]}), "
          f"{batch / (med / 1e3):.2f} clips/s at batch {batch}, peak "
          f"{run['peak'] / 2**30:.2f} GiB allocated on {smi}", flush=True)
    return med


def phase_deeplab(dev, smi, wrappers, launches, root, tmp) -> tuple:
    """Phase 10 (b): the DeepLab ResNet-init pre-stage through the CLI,
    `train-seg --device cuda model.arch=puredeeplab18 data.t=1` on (a)'s
    tree at batch 8 and 512x640 (the pipeline's optimiser, Adam 3e-4,
    OHEM), P10_DEEPLAB_EPOCHS epochs, then its evaluation with the
    predictions dumped. Held: finite losses, no swin-stack kernel or
    Hopper GEMM launched in a step, K4 once an evaluated frame on
    DeepLab's head-resolution logits ((1, 12, 64, 80) -> 1024x1280), the
    predictions against those of the plain route (`kernels=False`, the
    same weights) on >= TOL_PLAIN_SHARE of pixels with no launch there,
    and the `best/` checkpoint. Prints ms/step, clips/s, peak memory.
    Returns (the best checkpoint, the launches an evaluated frame)."""
    import numpy as np
    import torch
    from stswincl_tpu_torch.ckpt import latest_step, load_checkpoint
    from stswincl_tpu_torch.configs import DataConfig, SegTrainConfig
    from stswincl_tpu_torch.models import DeepLabV3Plus
    from stswincl_tpu_torch.pipelines.evaluate import evaluate_split
    from stswincl_tpu_torch.pipelines.common import build_seg_dataset

    ckpt = os.path.join(tmp, "deeplab")
    viz = os.path.join(tmp, "deeplab_viz")
    argv = ["train-seg", "--device", "cuda", f"data.root={root}",
            "model.arch=puredeeplab18", "data.t=1", "lr=3e-4",
            "optimizer=adam", "loss=ohem", f"num_epochs={P10_DEEPLAB_EPOCHS}",
            f"eval_every={P10_DEEPLAB_EPOCHS}", f"viz_dir={viz}",
            f"ckpt_dir={ckpt}", f"log_dir={os.path.join(tmp, 'deeplab_log')}"]
    print(f"  (10b) python -m stswincl_tpu_torch.cli {' '.join(argv)}",
          flush=True)
    run = seg_cli(argv, wrappers)
    steps = run["steps"]
    n = P10_DEEPLAB_EPOCHS * P10_STEPS_PER_EPOCH
    losses = [float(s["loss"]) for s in steps]
    print(f"  (10b) losses {[round(v, 5) for v in losses]}; first step's "
          f"launches {steps[0]['launches'] if steps else None}", flush=True)
    check(len(steps) == n and all(s["shape"] == (8, 1, H, W, 3)
                                  for s in steps),
          f"deeplab: {len(steps)} steps of {[s['shape'] for s in steps]}")
    check(all(math.isfinite(v) for v in losses), f"deeplab losses {losses}")
    for i, s in enumerate(steps):
        swin = {k: s["launches"][k] for k in SWIN_ROWS if s["launches"][k]}
        check(swin == {} and s["launches"]["upsample_argmax"] == 0,
              f"deeplab step {i}: launched {swin}")
    launches["deeplab_train"] = {k: sum(s["launches"][k] for s in steps)
                                 for k in wrappers}
    best = os.path.join(ckpt, "best")
    check(len(run["evals"]) == 1 and latest_step(best) == n,
          f"deeplab: {len(run['evals'])} evaluations, best checkpoint at "
          f"{latest_step(best)}")
    ev = run["evals"][-1]
    frames = ev["summary"]["frames"]
    launches["deeplab_eval"] = ev["launches"]
    print(f"  (10b) evaluation {ev['summary']}; K4 calls "
          f"{sorted(set(run['k4']))}", flush=True)
    check(frames == len(P10_SEQS) * P10_TEST_FRAMES
          and ev["launches"]["upsample_argmax"] == frames
          and run["k4"] == [((1, 12, H // 8, W // 8), *OUT_HW)] * frames,
          f"deeplab eval: K4 {ev['launches']['upsample_argmax']} launches "
          f"at {set(run['k4'])} for {frames} frames")
    check(all(ev["launches"][k] == 0 for k in SWIN_ROWS),
          f"deeplab eval launched {ev['launches']}")
    eval_rate("10b deeplab", ev, smi)
    step_rate("(10b) [DeepLabV3+ ResNet18-OS8] pre-stage", run, 8, smi)

    # the plain route (K4's twin) on the best weights and the same frames
    plain = DeepLabV3Plus(12, width=64, dtype=torch.bfloat16, kernels=False)
    plain.load_state_dict(load_checkpoint(best)["model"])
    plain = plain.to(dev).eval()
    plain_dir = os.path.join(tmp, "deeplab_viz_plain")
    cfg = SegTrainConfig(data=DataConfig(root=root, t=1), viz_dir=plain_dir)
    reset_launches(wrappers)
    with endovis_tables():
        evaluate_split(plain, build_seg_dataset(cfg.data, "test"), cfg)
    plain_launches = read_launches(wrappers)[0]
    got, ref = pngs(viz), pngs(plain_dir)
    share = float(np.mean([(got[k] == ref[k]).all(-1).mean() for k in ref]))
    print(f"  (10b) kernel route == plain route: {share:.6f} of pixels over "
          f"{len(ref)} frames", flush=True)
    check(len(ref) == len(got) == frames and share >= TOL_PLAIN_SHARE,
          f"deeplab: kernel vs plain route {share} over {len(ref)} frames")
    check(sum(plain_launches.values()) == 0,
          f"deeplab: the plain route launched {plain_launches}")
    del plain
    torch.cuda.empty_cache()
    return best, {k: v / frames for k, v in ev["launches"].items()}


class RematProbe:
    """Phase 10 (g) inside (c)'s CLI run: steps P10_TIMED under a
    `StepTimer` (its first skipped), steps P10_TRACED inside one
    `device_trace`, each in an `annotate` range."""

    def __init__(self, trace_dir):
        from stswincl_tpu_torch.utils.profiling import StepTimer
        self.trace_dir = trace_dir
        self.timer = StepTimer(skip_first=1)
        self.stack = contextlib.ExitStack()

    @contextlib.contextmanager
    def __call__(self, i):
        from stswincl_tpu_torch.utils.profiling import annotate, device_trace
        if i == P10_TRACED[0]:
            self.stack.enter_context(device_trace(self.trace_dir))
        if i in (0,) + P10_TIMED:
            with self.timer:
                yield
        else:
            with annotate(f"remat_step_{i}"):
                yield
        if i == P10_TRACED[-1]:
            self.stack.close()


def phase_remat(dev, smi, wrappers, launches, root, deeplab_best,
                tmp) -> dict:
    """Phase 10 (c) and (g): stage 1 through the CLI, warm-started from
    (b)'s checkpoint, with remat: `train-seg --device cuda
    init_checkpoint=<(b)/best> model.remat=true` on (a)'s tree, batch 8,
    P10_REMAT_EPOCHS epochs. Held: every `resnet.*` entry equal to (b)'s
    checkpoint, every other entry what the tolerant merge gives (the
    checkpoint's where name and shape agree, else the seeded init: the
    swin stack and the projections at their init); each step's launches
    exactly REMAT_STEP (the forward kernels twice a block call, K3 once,
    K5 and K6 once) and its GEMM forms, K2's m form twice a stage-2
    block; finite losses. (g): `device_trace` around steps P10_TRACED
    writes a Chrome trace holding their `annotate` ranges and CUDA kernel
    events; `StepTimer.summary()` over steps P10_TIMED within
    TOL_STEP_TIMER of their CUDA-event median. Returns the launches of
    one step."""
    import glob

    import torch
    from stswincl_tpu_torch.ckpt import load_checkpoint
    from stswincl_tpu_torch.ckpt.checkpoint import _merge

    ckpt = os.path.join(tmp, "stage1_remat")
    trace_dir = os.path.join(tmp, "trace")
    probe = RematProbe(trace_dir)
    argv = ["train-seg", "--device", "cuda", f"data.root={root}",
            "data.batch_size=8", "data.t=4", "lr=3e-4", "optimizer=adam",
            "loss=ohem", f"num_epochs={P10_REMAT_EPOCHS}",
            f"eval_every={P10_REMAT_EPOCHS}", "model.remat=true",
            f"init_checkpoint={deeplab_best}", f"ckpt_dir={ckpt}",
            f"log_dir={os.path.join(tmp, 'stage1_remat_log')}"]
    print(f"  (10c) python -m stswincl_tpu_torch.cli {' '.join(argv)}",
          flush=True)
    run = seg_cli(argv, wrappers, probe)
    steps = run["steps"]

    # the warm start from the DeepLab checkpoint
    prev = load_checkpoint(deeplab_best)["model"]
    init, after = run["warm"]["init"], run["warm"]["after"]
    skipped = []
    want = _merge(init, prev, skipped)
    wrong = [k for k in after if not torch.equal(after[k], want[k])]
    resnet = [k for k in after if k.startswith("resnet.")]
    moved = [k for k in resnet if not torch.equal(after[k], prev[k])]
    fresh = [k for k in after if k.startswith(("swin.", "project"))
             and not torch.equal(after[k], init[k])]
    loaded = sorted(k for k in after if not k.startswith("resnet.")
                    and k in prev and torch.equal(after[k], prev[k]))
    print(f"  (10c) warm start from the DeepLab checkpoint: {len(resnet)} "
          f"resnet entries ({len(moved)} differ from it); of the rest, "
          f"{len(loaded)} of matching name and shape loaded {loaded}; "
          f"{len(skipped)} skipped by the merge", flush=True)
    check(wrong == [] and moved == [] and fresh == [] and len(resnet) > 0,
          f"remat warm start: off the merge {wrong[:5]}, resnet entries not "
          f"from the checkpoint {moved[:5]}, swin / projections not at "
          f"their init {fresh[:5]}")

    # launches a step
    n = P10_REMAT_EPOCHS * P10_STEPS_PER_EPOCH
    losses = [float(s["loss"]) for s in steps]
    check(len(steps) == n, f"remat: {len(steps)} steps, expected {n}")
    check(all(math.isfinite(v) for v in losses), f"remat losses {losses}")
    for i, s in enumerate(steps):
        got, c = s["launches"], s["calls"]
        for k, want_n in REMAT_STEP.items():
            check(got[k] == want_n, f"remat step {i}: {k} launched {got[k]} "
                  f"times, the step implies {want_n}")
        check((c["grad_block"], c["merge"], c["m_saved"])
              == (FT_BLOCKS, FT_MERGES, FT_M_SAVED),
              f"remat step {i}: block calls {c}")
        check_gemm_launches(f"remat step {i}", got, s["forms"],
                            m_saved=2 * c["m_saved"], m_used=c["m_saved"])
    per_step = steps[P10_TIMED[0]]["launches"]
    launches["train_remat"] = {k: sum(s["launches"][k] for s in steps)
                               for k in per_step}
    launches["train_remat_eval"] = run["evals"][-1]["launches"]
    print(f"  (10c) losses {[round(v, 5) for v in losses]}; per-step "
          f"launches {per_step}", flush=True)
    step_rate("(10c) [pallas_full remat] stage 1 through the CLI", run, 8,
              smi)

    # (g) the timer against the events, and the trace
    ev_ms = [steps[i]["events"][0].elapsed_time(steps[i]["events"][1])
             for i in P10_TIMED]
    summary = probe.timer.summary()
    rel = abs(summary["p50_s"] * 1e3 - statistics.median(ev_ms)) \
        / statistics.median(ev_ms)
    print(f"  (10g) StepTimer {summary} against CUDA events {ev_ms} ms "
          f"(median {statistics.median(ev_ms):.2f}): rel {rel:.4f}",
          flush=True)
    check(summary["steps"] == len(P10_TIMED) and rel <= TOL_STEP_TIMER,
          f"StepTimer p50 {summary.get('p50_s')} s against CUDA events "
          f"{ev_ms} ms: rel {rel}")
    files = glob.glob(os.path.join(trace_dir, "trace_*.json"))
    events = []
    for f in files:
        with open(f) as fh:
            events += json.load(fh).get("traceEvents", [])
    ranges = {e.get("name") for e in events
              if str(e.get("name", "")).startswith("remat_step_")}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names = sorted({e.get("name", "")[:40] for e in kernels})
    print(f"  (10g) device_trace: {len(files)} file(s), {len(events)} events,"
          f" ranges {sorted(ranges)}, {len(kernels)} CUDA kernel events "
          f"({len(names)} names, e.g. {names[:4]})", flush=True)
    check(len(files) == 1 and ranges == {f"remat_step_{i}"
                                         for i in P10_TRACED}
          and len(kernels) > 0,
          f"device_trace: {len(files)} files, ranges {ranges}, "
          f"{len(kernels)} kernel events")
    return per_step


def phase_remat_gates(dev, bf16, smi, wrappers, launches, control) -> None:
    """Phase 10 (d): remat against no remat on phase 4's batch 8 and
    weights (`SegTrainConfig`'s stage-1 step, 'pallas_full'). Held: the
    loss bit-equal (the recompute runs the same kernels on the same
    input); each gradient's 1 - cosine against the non-remat route's
    within phase 4's gate against `control` (phase 4's control route)
    and the cosine floor (`hold_gradients`); the peak memory lower with
    remat; and, tighter, each gradient's 1 - cosine within
    `spread_share`'s bound from the same step run twice without remat
    (the backward's run-to-run spread; remat adds none, as the recompute
    runs the same kernels on the same input). The same with
    `whole_block`, against its own spread. Printed: the bit-equal
    gradients and ms/step of both (CUDA events, P10_GATE_STEPS steps
    after the gate step). Planted faults in the remat of one block
    (P10_FAULT_BLOCK): its forward without the graph (a remat that never
    connects the block to the backward) must miss both bounds tenfold;
    its recompute fed its two frames swapped (activations of the wrong
    frame under each output's gradient) must miss the spread's bound
    tenfold; its recompute fed an input one bf16 ulp off is printed with
    its factors."""
    import torch
    import torch.utils.checkpoint
    from stswincl_tpu_torch.configs import SegTrainConfig
    from stswincl_tpu_torch.models import TswinPlus
    from stswincl_tpu_torch.models.aspp import ConvBNRelu
    from stswincl_tpu_torch.models.init import init_weights
    from stswincl_tpu_torch.pipelines.seg import make_tx
    from stswincl_tpu_torch.train.train_seg import make_seg_train_step

    cfg = SegTrainConfig()
    kw = dict(num_classes=cfg.model.num_classes, swin_dim=cfg.model.swin_dim,
              num_heads=cfg.model.num_heads,
              swin_depths=tuple(cfg.model.swin_depths),
              gelu_exact=cfg.model.gelu_exact, dtype=bf16, input_hw=(H, W))
    init_state = init_weights(TswinPlus(**kw),
                              torch.Generator().manual_seed(0)).state_dict()
    images, labels = seeded_batch(cfg.data.batch_size, seed=3)
    images = torch.from_numpy(images).to(dev)
    labels = torch.from_numpy(labels).to(dev).long()

    def run(remat, whole_block=False, fault=None, timed=0):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = TswinPlus(**kw, remat=remat, whole_block=whole_block)
        model.load_state_dict(init_state)
        model = model.to(dev)
        if fault is not None:
            fault(model)
        opt, schedule = make_tx(cfg, 1 + timed, model)
        step = make_seg_train_step(model, opt, schedule, cfg.loss,
                                   ohem_thresh=cfg.ohem_thresh)
        grads = {}
        hook = opt.register_step_pre_hook(lambda *_: grads.update(
            {n: (p.grad.detach().clone() if p.grad is not None
                 else torch.zeros_like(p))
             for n, p in model.named_parameters()}))
        few = set()
        with few_value_batchnorms(model, few):
            loss = step(images, labels)["loss"].item()
        hook.remove()
        peak = torch.cuda.max_memory_allocated()
        ms = []
        for _ in range(timed):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            step(images, labels)
            b.record()
            ms.append((a, b))
        torch.cuda.synchronize()
        zero_grad = {f"{n}.conv.bias" for n, mod in model.named_modules()
                     if isinstance(mod, ConvBNRelu)}
        del model, step, opt
        return {"loss": loss, "grads": grads, "peak": peak, "few": few,
                "zero_grad": zero_grad,
                "ms": [a.elapsed_time(b) for a, b in ms]}

    def bit_equal(ga, gb) -> dict:
        """Bit-equal gradients / all, by top-level module."""
        out = {}
        for n in ga:
            top = n.split(".")[0]
            eq, tot = out.get(top, (0, 0))
            out[top] = (eq + torch.equal(ga[n], gb[n]), tot + 1)
        return out

    def spread_share(r, a, spread) -> dict:
        """Each gradient of run r: 1 - cosine against run a's over
        TOL_REMAT_FACTOR times that of `spread` (a's step run again)
        plus TOL_NOISE_FLOOR."""
        held = {n: g for n, g in a["grads"].items()
                if n not in a["zero_grad"]}
        got, noise = cosines_of(r["grads"], held), cosines_of(
            spread["grads"], held)
        return {n: (1 - c) / (TOL_REMAT_FACTOR * max(1 - noise[n], 0)
                              + TOL_NOISE_FLOOR) for n, c in got.items()}

    reset_launches(wrappers)
    base = run(False, timed=P10_GATE_STEPS)
    remat = run(True, timed=P10_GATE_STEPS)
    launches["remat_gates"] = read_launches(wrappers)[0]
    # the backward's run-to-run spread: the same step again, no remat
    again = run(False)
    for wb in (False, True):
        if wb:
            reset_launches(wrappers)
            a, b = run(False, whole_block=True), run(True, whole_block=True)
            c, _ = read_launches(wrappers)
            launches["remat_gates"] = {k: launches["remat_gates"][k] + c[k]
                                       for k in c}
            a_again = run(False, whole_block=True)
            route = "pallas_full whole_block, remat"
        else:
            a, b, a_again = base, remat, again
            route = "pallas_full, remat"
        print(f"  (10d) [{route}] loss without remat {a['loss']!r}, with "
              f"{b['loss']!r}; gradients bit-equal by module (equal, all): "
              f"{bit_equal(a['grads'], b['grads'])}; peak "
              f"{a['peak'] / 2**30:.2f} GiB without, "
              f"{b['peak'] / 2**30:.2f} GiB with remat on {smi}", flush=True)
        spread = cosines_of(a_again["grads"], {
            n: g for n, g in a["grads"].items() if n not in a["zero_grad"]})
        low = sorted(spread.items(), key=lambda kv: kv[1])[:3]
        print(f"  (10d) [{route}] the same step twice without remat: loss "
              f"{a_again['loss']!r}; gradients bit-equal by module "
              f"{bit_equal(a_again['grads'], a['grads'])}; lowest cosines "
              f"{low} (the backward's run-to-run spread)", flush=True)
        check(a["loss"] == b["loss"], f"{route}: loss {b['loss']!r} with "
              f"remat, {a['loss']!r} without: a forward kernel is not "
              "deterministic")
        check(b["peak"] < a["peak"], f"{route}: peak {b['peak']} with remat,"
              f" {a['peak']} without")
        hold_gradients("(10d)", route, b["grads"], a["grads"],
                       a["zero_grad"], a["few"] | b["few"], control)
        share = spread_share(b, a, a_again)
        top = sorted(share.items(), key=lambda kv: -kv[1])[:5]
        print(f"  (10d) [{route}] 1 - cos over its bound from the spread "
              f"({TOL_REMAT_FACTOR} x the spread's + {TOL_NOISE_FLOOR}): "
              f"max {top[0][1]:.3f}; highest five {top}", flush=True)
        for n, r in share.items():
            check(r <= 1.0, f"{route}: gradient of {n}: 1 - cos "
                  f"{r:.3f} of its bound from the run-to-run spread")
    for tag, r in (("without remat", base), ("with remat", remat)):
        print(f"  (10d) [pallas_full] {tag}: "
              f"{statistics.median(r['ms']):.2f} ms/step median of "
              f"{len(r['ms'])} (CUDA events: {[round(v, 1) for v in r['ms']]}"
              f"), peak {r['peak'] / 2**30:.2f} GiB allocated on {smi}",
              flush=True)

    # planted faults in one block's remat
    def no_graph(model):
        blk = getattr(model.swin, P10_FAULT_BLOCK)

        def forward(x, out_frame=None):
            with torch.no_grad():
                return blk.block(x, out_frame)
        blk.forward = forward

    def recompute_with(change):
        """The fault: the block's recompute in the backward (its second
        call under the checkpoint) fed change(x) in place of x."""
        def fault(model):
            blk = getattr(model.swin, P10_FAULT_BLOCK)
            n_calls = [0]

            def fn(x, out_frame):
                n_calls[0] += 1
                if n_calls[0] % 2 == 0:
                    x = change(x.detach())
                return blk.block(x, out_frame)

            def forward(x, out_frame=None):
                return torch.utils.checkpoint.checkpoint(
                    fn, x, out_frame, use_reentrant=False)
            blk.forward = forward
        return fault

    frames_swapped = recompute_with(lambda x: x.flip(1).contiguous())
    one_ulp = recompute_with(lambda x: (
        x.contiguous().view(torch.int16) + 1).view(x.dtype))
    for name, fault in (("its forward without the graph", no_graph),
                        ("its recompute fed its two frames swapped",
                         frames_swapped),
                        ("its recompute fed x one bf16 ulp off", one_ulp)):
        f = run(True, fault=fault)
        share = noise_share(cosines_of(f["grads"], {
            n: g for n, g in base["grads"].items()
            if n not in base["zero_grad"]}), control)
        top = sorted(share.items(), key=lambda kv: -kv[1])[:3]
        top_spread = sorted(spread_share(f, base, again).items(),
                            key=lambda kv: -kv[1])[:3]
        blk = {n: c for n, c in cosines_of(f["grads"], remat["grads"]).items()
               if n.startswith(f"swin.{P10_FAULT_BLOCK}.")}
        low = sorted(blk.items(), key=lambda kv: kv[1])[:2]
        print(f"  (10d) planted fault, {P10_FAULT_BLOCK} with {name}: 1 - cos"
              f" over phase 4's gate's bound, highest three {top}; over the "
              f"spread's bound, highest three {top_spread}; the block's "
              f"lowest cosines to the sound remat run's {low}", flush=True)
        if fault is no_graph:
            check(top[0][1] >= 10.0, f"remat planted fault ({name}) moves "
                  f"the gated gradients by only {top[0][1]} of their bound")
        if fault is not one_ulp:
            check(top_spread[0][1] >= 10.0, f"remat planted fault ({name}) "
                  f"moves the gradients by only {top_spread[0][1]} of the "
                  "spread's bound")
    torch.cuda.empty_cache()


def contrast_release(root: str) -> None:
    """A seeded EndoVis18 stage-2 tree: `Processed_train/seq_N/
    left_frames/frame%03d.png` RGB at 270x480 (the sampler's source size)
    and `labels/grayframe%03d.png` class ids (blocks of 30 pixels),
    P10_CONTRAST_ON_DISK frames a sequence."""
    import numpy as np
    from PIL import Image
    rng = np.random.default_rng(15)
    palette = rng.integers(0, 256, (12, 3))
    for s in P10_CONTRAST_SEQS:
        d = os.path.join(root, "Processed_train", f"seq_{s}")
        os.makedirs(os.path.join(d, "left_frames"))
        os.makedirs(os.path.join(d, "labels"))
        for i in range(P10_CONTRAST_ON_DISK):
            ids = np.kron(rng.integers(0, 12, (9, 16)),
                          np.ones((30, 30), np.int64))
            img = palette[ids] + rng.integers(-20, 21, ids.shape + (1,))
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                os.path.join(d, "left_frames", f"frame{i:03d}.png"))
            Image.fromarray(ids.astype(np.uint8)).save(
                os.path.join(d, "labels", f"grayframe{i:03d}.png"))


def phase_rand_augment(dev, smi, wrappers, launches, tmp) -> None:
    """Phase 10 (e): stage 2 through the CLI with RandAugment,
    `pretrain-contrast --device cuda data.dataset=endovis18 data.root=...
    data.rand_augment=rand-m9-mstd0.5` (`ContrastTrainConfig`'s batch 4 at
    256x448) for one epoch of a contrast tree the phase writes (the
    sampler's sequence and frame tables set to the tree's: the CLI has no
    option for them). Held: the sampler built with the config's augment;
    finite losses; the labels reaching the class-sum loss hold 255 pixels
    (label pixels that the geometric ops warped in from outside the
    frame), all outside the loss's valid pixels; each kernel launched
    once per block call it serves. Prints the host seconds a sample with
    and without the augment, and samples/s."""
    import numpy as np
    import torch
    from stswincl_tpu_torch import cli
    from stswincl_tpu_torch.configs import DataConfig
    from stswincl_tpu_torch.data.contrastive import ContrastiveClipDataset
    from stswincl_tpu_torch.data.loader import _seeded_rng
    from stswincl_tpu_torch.models.swin import (PatchMerging,
                                                SpaceTimeSwinBlock)
    from stswincl_tpu_torch.pipelines import contrast as contrast_pipeline
    from stswincl_tpu_torch.train import train_contrast as tc

    root = os.path.join(tmp, "contrast")
    contrast_release(root)
    frames = {s: P10_CONTRAST_FRAMES for s in P10_CONTRAST_SEQS}
    built = []

    def dataset(cfg):
        ds = ContrastiveClipDataset(
            cfg.root, "endovis18", tag=cfg.tag, crop_hw=cfg.crop_hw,
            rand_augment=cfg.rand_augment, sequences=P10_CONTRAST_SEQS,
            frames_per_seq=frames)
        built.append((cfg.rand_augment, ds.clip_augment is not None))
        return ds

    calls = {"block": 0, "grad_block": 0, "merge": 0}
    hooks, steps, fills = [], [], []

    def counter(mod, inputs, _):
        if isinstance(mod, PatchMerging):
            calls["merge"] += 1
            return
        calls["block"] += 1
        calls["grad_block"] += torch.is_grad_enabled()

    real_encoder = contrast_pipeline.build_contrast_encoder

    def encoder(cfg, class_num, device):
        model = real_encoder(cfg, class_num, device)
        hooks.extend(m.register_forward_hook(counter) for m in model.modules()
                     if isinstance(m, (SpaceTimeSwinBlock, PatchMerging)))
        return model

    real_loss = tc.class_sum_contrastive_loss

    def loss_spy(q, q_labels, keys, class_num):
        valid = (q_labels >= 0) & (q_labels < class_num)
        fills.append(((q_labels == 255).sum().item(),
                      ((q_labels == 255) & valid).sum().item(),
                      sum((kl == 255).sum().item() for _, kl in keys)))
        return real_loss(q, q_labels, keys, class_num)

    real_call = tc.ContrastTrainStep.__call__

    def timed_call(self, clips, labels):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = real_call(self, clips, labels)
        b.record()
        steps.append({"events": (a, b), "loss": out["loss"],
                      "fill": (labels == 255).sum().item()})
        return out

    argv = ["pretrain-contrast", "--device", "cuda", "data.dataset=endovis18",
            f"data.root={root}", f"data.rand_augment={RAND_AUGMENT}",
            "num_epochs=1", f"ckpt_dir={os.path.join(tmp, 'contrast_ckpt')}",
            f"log_dir={os.path.join(tmp, 'contrast_log')}"]
    print(f"  (10e) python -m stswincl_tpu_torch.cli {' '.join(argv)}",
          flush=True)
    reset_launches(wrappers)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with unittest.mock.patch.object(contrast_pipeline,
                                    "build_contrast_dataset", dataset), \
            unittest.mock.patch.object(contrast_pipeline,
                                       "build_contrast_encoder", encoder), \
            unittest.mock.patch.object(tc, "class_sum_contrastive_loss",
                                       loss_spy), \
            unittest.mock.patch.object(tc.ContrastTrainStep, "__call__",
                                       timed_call):
        cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    launches["contrast_rand_augment"], forms = read_launches(wrappers)
    for h in hooks:
        h.remove()
    got = launches["contrast_rand_augment"]
    n = len(P10_CONTRAST_SEQS) * P10_CONTRAST_FRAMES // CONTRAST_BATCH
    losses = [float(s["loss"]) for s in steps]
    q_fill = sum(f[0] for f in fills)
    print(f"  (10e) sampler {built}; {len(steps)} steps, losses "
          f"{[round(v, 5) for v in losses]}; 255 label pixels a step at the "
          f"crop size {[s['fill'] for s in steps]}, at the loss: {q_fill} "
          f"in the query views ({sum(f[1] for f in fills)} counted valid), "
          f"{sum(f[2] for f in fills)} in the key sets; launches {got}",
          flush=True)
    check(built == [(RAND_AUGMENT, True)], f"rand_augment: sampler {built}")
    check(len(steps) == n and all(math.isfinite(v) for v in losses),
          f"rand_augment: {len(steps)} steps, losses {losses}")
    check(q_fill > 0 and sum(f[1] for f in fills) == 0,
          f"rand_augment: {q_fill} 255 pixels reach the loss, "
          f"{sum(f[1] for f in fills)} of them counted valid")
    for k, want in (("swin_block_attention", calls["block"]),
                    ("swin_block_epilogue", calls["block"]),
                    ("patch_merge", calls["merge"]),
                    ("swin_block_attention_bwd", calls["grad_block"]),
                    ("swin_block_epilogue_bwd", calls["grad_block"])):
        check(got[k] == want and want > 0, f"rand_augment: {k} launched "
              f"{got[k]} times for {want} calls")
    check(calls["block"] == n * 8 * FT_BLOCKS, f"rand_augment: block calls "
          f"{calls}")
    ms = [a.elapsed_time(b) for a, b in (s["events"] for s in steps)]
    med = statistics.median(ms[1:])

    # the sampler's host cost a sample, with and without the augment
    per = {}
    for aug in (None, RAND_AUGMENT):
        ds = ContrastiveClipDataset(root, "endovis18", crop_hw=CONTRAST_HW,
                                    rand_augment=aug,
                                    sequences=P10_CONTRAST_SEQS,
                                    frames_per_seq=frames)
        secs = []
        for i in range(3):
            t = time.perf_counter()
            ds.get(i * 5, _seeded_rng(0, 0, i))
            secs.append(time.perf_counter() - t)
        per[aug] = statistics.median(secs)
    print(f"  (10e) [pallas_full] stage 2 with RandAugment: {med:.2f} ms/step"
          f" median of steps 2-{len(ms)} (CUDA events; all "
          f"{[round(v, 1) for v in ms]}), {CONTRAST_BATCH / (med / 1e3):.2f} "
          f"samples/s on the card, {n * CONTRAST_BATCH / wall:.2f} samples/s "
          f"over the run's {wall:.1f} s (the loader's "
          f"{DataConfig().num_workers} workers, the model build and the "
          f"checkpoint included), peak {peak / 2**30:.2f} GiB on {smi}; host "
          f"s a sample (6 views of 4 frames, one process): "
          f"{per[None]:.4f} without the augment, {per[RAND_AUGMENT]:.4f} "
          "with", flush=True)
    torch.cuda.empty_cache()


def phase_deeplab50(dev, bf16, smi, wrappers, launches) -> None:
    """Phase 10 (f): `DeepLabV3Plus(layers=50)` (ResNet50-OS16, the
    256-branch ASPP) in bf16 from seeded weights: a stage-1 train step at
    batch 2 and 512x640 (Adam, OHEM on the NHWC logits) with a finite loss
    and no swin-stack kernel, P10_D50_STEPS more timed by CUDA events
    (their median printed: the first step mostly times cuDNN's first
    calls), then one evaluated frame through `make_seg_eval_step` at the
    EndoVis protocol: K4 once on the (1, 12, 32, 40) head-resolution
    logits with phase 2's os16 matrices, a (1, 1024, 1280) class map in
    [0, 12) equal to K4's twin on the same logits on >= TOL_K4_SHARE of
    pixels (phase 2 times K4 at this shape and plants its faults)."""
    import torch
    from stswincl_tpu_torch.configs import SegTrainConfig
    from stswincl_tpu_torch.models import DeepLabV3Plus
    from stswincl_tpu_torch.models.init import init_weights
    from stswincl_tpu_torch.ops import resize
    from stswincl_tpu_torch.ops.upsample_argmax import upsample_argmax_ref
    from stswincl_tpu_torch.pipelines.seg import make_tx
    from stswincl_tpu_torch.train.train_seg import (make_seg_eval_step,
                                                    make_seg_train_step)
    cfg = SegTrainConfig()
    torch.cuda.reset_peak_memory_stats()
    model = init_weights(DeepLabV3Plus(12, layers=50, dtype=bf16),
                         torch.Generator().manual_seed(6)).to(dev)
    images, labels = seeded_batch(2, seed=6)
    images = torch.from_numpy(images[:, -1:]).to(dev)
    labels = torch.from_numpy(labels).to(dev).long()
    opt, schedule = make_tx(cfg, 1 + P10_D50_STEPS, model)
    step = make_seg_train_step(model, opt, schedule, cfg.loss,
                               ohem_thresh=cfg.ohem_thresh)
    reset_launches(wrappers)
    losses, events = [], []
    for _ in range(1 + P10_D50_STEPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        losses.append(step(images, labels)["loss"])
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    launches["deeplab50_train"] = read_launches(wrappers)[0]
    losses = [v.item() for v in losses]
    ms = [a.elapsed_time(b) for a, b in events]
    check(all(map(math.isfinite, losses)) and sum(
        launches["deeplab50_train"].values()) == 0,
        f"deeplab50: losses {losses}, launches "
        f"{launches['deeplab50_train']}")
    calls = []
    real_k4 = resize.upsample_argmax

    def k4_spy(x, mh, mw, *a_, **k):
        calls.append((x.clone(), mh, mw, a_[0] if a_ else k.get("exact")))
        return real_k4(x, mh, mw, *a_, **k)

    reset_launches(wrappers)
    with unittest.mock.patch.object(resize, "upsample_argmax", k4_spy):
        pred = make_seg_eval_step(model, out_hw=OUT_HW)(images[:1])
    launches["deeplab50_eval"] = read_launches(wrappers)[0]
    shapes = [(tuple(x.shape), mh.shape[0], mw.shape[0])
              for x, mh, mw, _ in calls]
    print(f"  (10f) DeepLabV3+ ResNet50-OS16 bf16: train steps at batch 2 "
          f"{[round(v, 2) for v in ms]} ms (CUDA events), median of the "
          f"{P10_D50_STEPS} after the first {statistics.median(ms[1:]):.2f} "
          f"ms, losses {[round(v, 5) for v in losses]}, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; eval K4 at "
          f"{shapes}, prediction {tuple(pred.shape)} in "
          f"[{pred.min().item()}, {pred.max().item()}] on {smi}", flush=True)
    check(shapes == [((1, 12, H // 16, W // 16), *OUT_HW)]
          and launches["deeplab50_eval"]["upsample_argmax"] == 1
          and tuple(pred.shape) == (1, *OUT_HW) and pred.min() >= 0
          and pred.max() < 12,
          f"deeplab50 eval: K4 at {shapes}, "
          f"{launches['deeplab50_eval']['upsample_argmax']} launches, "
          f"prediction {tuple(pred.shape)}")
    if len(calls) == 1:
        x, mh, mw, exact = calls[0]
        oh, ow = (m.to(dev) for m in resize.composed_matrices(
            H // 16, W // 16, (H, W), OUT_HW))
        want = upsample_argmax_ref(x, mh, mw, exact)
        share = (pred.to(want.dtype) == want).float().mean().item()
        print(f"  (10f) the evaluated frame against K4's twin on the same "
              f"head logits (exact={exact}): {share:.6f} of pixels equal",
              flush=True)
        check(torch.equal(mh, oh) and torch.equal(mw, ow) and not exact,
              "deeplab50 eval: K4 ran on other matrices than phase 2's "
              f"os16 case (exact={exact})")
        check(share >= TOL_K4_SHARE, f"deeplab50 eval: {share} of pixels "
              f"equal to K4's twin < {TOL_K4_SHARE}")
    del model, step, opt, calls
    torch.cuda.empty_cache()


def phase_rest(dev, bf16, smi, wrappers, launches, control) -> dict:
    """Phase 10, the rest of the pipeline at full width, in a temporary
    directory inside the checkout deleted at the end: (a)
    `phase_prepare`, (b) `phase_deeplab`, (c) and (g) `phase_remat`, (d)
    `phase_remat_gates`, (e) `phase_rand_augment`, (f) `phase_deeplab50`.
    Returns the launches of a stage-1 step with remat and of an
    evaluated DeepLabV3+ frame, for the kernels line."""
    import tempfile
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        t0 = time.perf_counter()
        root = phase_prepare(tmp)
        print(f"phase 10 (a) prepare_endovis: {time.perf_counter() - t0:.1f}"
              " s", flush=True)
        t0 = time.perf_counter()
        best, per_frame = phase_deeplab(dev, smi, wrappers, launches, root,
                                        tmp)
        print(f"phase 10 (b) the DeepLab pre-stage through the CLI: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        per_step = phase_remat(dev, smi, wrappers, launches, root, best, tmp)
        print(f"phase 10 (c, g) stage 1 with remat through the CLI, traced: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        phase_remat_gates(dev, bf16, smi, wrappers, launches, control)
        print(f"phase 10 (d) remat against no remat: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        phase_rand_augment(dev, smi, wrappers, launches, tmp)
        print(f"phase 10 (e) stage 2 with RandAugment through the CLI: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_deeplab50(dev, bf16, smi, wrappers, launches)
    print(f"phase 10 (f) DeepLabV3+ ResNet50-OS16: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {"per_remat_step": per_step, "per_deeplab_eval_frame": per_frame}


if __name__ == "__main__":
    main()
