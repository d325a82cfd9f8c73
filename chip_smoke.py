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
  2g. the backwards at every window and width their forwards take
     (`phase_envelope_kernels`): K5 in bf16 at K5_ENVELOPE, (TN, hd) =
     (128, 192), (128, 256), (128, 288), (144, 64), (176, 208) (its two
     passes) and (32, 512) (its one-pass slot kernel), beside both
     training shapes; K6 in bf16 and fp32 at C 384, 768, 1536 (K6_ENVELOPE,
     row 7 shifted, row 9 with row 8's m) beside 512 and 1024; each
     against its twin (TOL_REL, fp32 TOL_F32_REL) with the planted faults
     of phase 2b missing tenfold, bit-equal across two calls, timed
     beside the twin and its bound; K3's backward and `wgrad_sm90` alone
     bit-equal across two calls;
  2i. every widened kernel at the widths off C % 128 and hd % 32
     (`phase_widths_kernels`): (C, heads) = (32, 4), (64, 4), (96, 4),
     (192, 4) (hd 8, 16, 24, 48) at both stages' windows (TN 128 at (4,
     2, 64, 80), TN 32 at (4, 2, 32, 40)), in bf16 and fp32: K1 (W-MSA,
     SW-MSA), K2 (rows 2, 3 and 8), K5 (SW-MSA), K6 (rows 7 and 9), rows
     10 and 11, and K5 bf16's two passes at TN 144 x hd 24; each within
     TOL_REL (bf16) or TOL_F32_REL (fp32) of its twin, bit-equal across
     two calls, a planted fault missing tenfold, exact launches (the
     library's GEMM forms too), timed beside the twin and the bound; and
     `wgrad_sm90` alone at ragged M and N;
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
  2h. (after phase 4; `phase_envelope_train`) (a) the bf16 stage-1 step
     twice under PyTorch's deterministic algorithms and cuDNN
     deterministic: loss and every gradient bit-equal; (b) whether row 16
     takes `num_heads=2`'s windows (printed); (c) `phase_config_train`
     on `ModelConfig(num_heads=2)` (bf16) and `ModelConfig(swin_dim=384)`
     (bf16 and fp32): `build_model` and `SegTrainStep`, three steps at
     batch 8:
     finite losses, K1, K2, K5, K6 once a block call and K3 once a merge,
     ms/step; the first step's gradients gated as phase 4 (bf16, against
     the twin step) and 7 (d) (fp32, `fp32_step_gate` at batch 2);
  2j. (after phase 2h; `phase_widths_models`) `ModelConfig(swin_dim=96)`
     and `(swin_dim=64)` through `build_model` on 'pallas_full', and
     `swin_dim` 96 with `whole_block=True` (row 16 on its W-MSA blocks),
     bf16 and fp32: served at bs 2 (8 `predict_next`s, launches as
     SERVE_STEP, kernel route == plain route on >= TOL_PLAIN_SHARE of
     pixels, ms a `predict_next`), then `phase_config_train` on them (3
     stage-1 steps at batch 8, exact launches, ms/step, peak memory, the
     first step's gradients gated as 2h gates them);
  2k. (after phase 2j; `phase_f32_streamed`) the fp32 forms of K1, K5 and
     rows 10-11 at windows past their resident instances (F32_STREAMED),
     `num_heads=2` and `swin_dim=768` served in fp32, 768 stepped once at
     the largest batch that fits;
  2l. (after phase 2k; `phase_attn_streamed`) K1, rows 10 and 11, K5's
     attention backward alone and K5 at the head dims past the bf16
     resident pair (ATTN_STREAMED: TN 128 x hd 296-640, TN 144 x hd 320,
     TN 176 x hd 216 / 320, TN 32 x hd 1208-2048) in bf16 and fp32
     against their twins, bit-equal, planted faults (a QK^T without its
     last column chunk among them) tenfold out, the library's streamed
     launches exactly where the plans stream, timed beside SDPA; windows
     outside the envelope refused before any launch; `num_heads=1` and
     `swin_dim=1280` served at bs 2 in both dtypes, on 'pallas_full' and
     with `whole_block=True` (the same build), `num_heads=1` trained (3
     steps at batch 8, gated as 2h), 1280 stepped once at the largest
     batch that fits;
  2m. (after phase 2l; `phase_whole_block_envelope`) row 16 in both forms
     at every shape K1 + K2 take (WHOLE_ENVELOPE: C 32-2560, hd 8-1024,
     TN 32-176, x by boxes and by the row map, resident and streamed
     pairs, one and two product tiles a tile): bit-equal to the K1 + K2
     pair with m rounded and call to call, within its bound of its twin,
     planted faults tenfold out, exact row-16 and streamed-pair launches,
     timed beside the twin, the bound and the pair; `swin_dim=1280` and
     `num_heads=1` with `whole_block=True` stepped once at batch 2 in both
     dtypes (2l (b) serves them);
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
  7. fp32 (`phase_fp32`): (a) the fp32 forms of K1, K2 (plain, shifted,
     T 1) and K3 (`csrc/fp32_forms.cu`) against their fp32 twins at both
     stages' serving shapes, TF32 off, within TOL_F32_REL, timed beside
     the twin and the bf16 kernel; planted faults (every product operand
     rounded to TF32, and phase 2's) must miss the bound tenfold; the fp32
     GEMM alone at each of their products beside cuBLAS's fp32 F.linear;
     (b) `build_model(ModelConfig(dtype="float32"))` serves
     `init_and_predict` + `predict_next` at full width, bs 2, on those
     forms and K4's exact form, each launched a predict_next as often as
     the bf16 route launches its own (K1 14, K2 14, K3 1, K4 1), its
     predictions the fp32 plain route's on >= 99.9 % of pixels; ms per
     predict_next and frames/s of both fp32 routes and of bf16; (c) fp32
     evaluation at B = 1 through `evaluate.run_test` on phase 9's
     synthetic split, streamed and full clip: frames/s, `sec_per_frame`,
     launches a frame; (a) also the fp32 training forms
     (`phase_fp32_train_kernels`, `csrc/fp32_train.cu`): K5 (Pallas row 6)
     at both stages' training shapes and the stage-2 step's, K6
     recomputing m (row 7) at C 512, K2 with m (row 8) and K6 taking it
     (row 9) at C 1024, each output within TOL_F32_REL of the fp32 twin,
     the twin on TF32 products missing the bound tenfold, each form
     bit-equal across two calls, timed beside the twin, the bf16 kernel
     and cuBLAS fp32 on its products; `wgrad_f32` alone beside
     `a.t() @ b`; (d) stage-1 training on the fp32 forms
     (`phase_fp32_train`): at batch 2 one kernel step against the fp32
     twin step (`fp32_step_gate`: the loss and every gradient within
     F32_STEP_FACTOR x the larger deviation of two controls, the twin step
     on the clips perturbed at 2^-22 and 2^-24, + F32_STEP_FLOOR; planted
     K5 and K6 faults and the step under bf16 autocast missing tenfold),
     exact launches (F32_STEP, no twin, no bf16 form), a second kernel
     step's bit-equality reported; then batch 8: ms/step and peak memory;
     (e) the stage-2 step at `ContrastTrainConfig`'s defaults on the fp32
     forms: the same gate against its twin step, then launches, ms and
     peak memory; (a) also the fp32 forms of rows 10 and 11 (both stages,
     W-MSA and SW-MSA) and of row 16 (`csrc/fp32_whole_block.cu`, both
     stages, W-MSA), each within TOL_F32_REL of its fp32 twin, bit-equal
     across two calls, its twin with q, k, v (row 16: every product
     operand) on TF32, with P rounded to bf16 and (SW-MSA) without the
     mask missing tenfold, timed beside the twin, the bf16 kernel, SDPA in
     fp32 (row 11; the kernel that ran named from torch.profiler) and, for
     row 16, the fp32 K1 + K2 pair it must equal within TOL_F32_REL;
     every (a) row prints its TFLOP/s and its share of its bound (3xTF32
     or bytes), the library call's beside them; (f) fp32 serving on
     'pallas', 'pallas_windows' and `whole_block`: each predict_next
     launches its route's fp32 forms as often as phases 3b / 3c launch
     the bf16 kernels (row 10 or 11 14, row 16 7) and no bf16 kernel,
     predictions the fp32 plain route's on >= 99.9 %, ms and frames/s;
     (g) one fp32 stage-1 step at batch 2 on 'pallas' and on
     `whole_block` through `fp32_step_gate` (planted
     faults: row 10 without the mask, row 16 with wproj transposed, K5's
     and K6's of (d) where they run, bf16 autocast), exact launches; (a)
     also the fp32 forms of rows 12 (the MLP), 13 (add + LN + MLP), 14
     (add + LN), 15 (LN) and 17 (the dilated conv) through their wrappers
     at phase 2e's shapes (`phase_fp32_offpath_kernels`), each within
     TOL_F32_REL of its fp32 twin, bit-equal across two calls, exact
     launches (two fp32 GEMMs a row 12 or 13 call, one "conv_f32" a row
     17 call, no bf16 kernel), a planted fault (TF32 products or operands;
     y dropped; the bias dropped) missing tenfold, timed beside the twin,
     the bf16 kernel and the library, and K5's fp32 form at head dim 32;
     (h) the entry points of rows 12-15 and 17 in fp32 (`Mlp`,
     `FusedLayerNorm`, the wrappers): one launch of each fp32 form, no
     bf16 kernel, within TOL_F32_REL of the plain routes; (i) one fp32
     stage-1 step of `swin_dim` 128, depths (1, 1) (hd 32 at stage 1)
     through `fp32_step_gate`, exact launches;
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
  11. data parallelism (`phase_parallel`, `stswincl_tpu_torch/parallel/`):
     (a) `torch.distributed.run --standalone --nproc_per_node=1` (torchrun)
     on this script's rank mode, which runs `python -m
     stswincl_tpu_torch.cli train-seg --device cuda` on the synthetic set
     at full width and batch 8 for one epoch: an NCCL group of one rank,
     DDP and synced BatchNorms; ms/step beside phase 4's, each step's
     launches exactly a step's block calls, K4 once a frame of rank 0's
     evaluation; (b) two ranks spawned on
     cuda:0 over gloo, stage 1: phase 4's weights and batch 8, each clip
     tinted, rank 0's half mostly ignored, 4 a rank, one Adam step
     against the one-process step on the whole batch (the loss, every
     BatchNorm statistic, each gradient's 1 - cosine and norm ratio, each
     within TOL_REMAT_FACTOR x the larger deviation of two controls, the
     one-process step on the input perturbed at 2^-9 and 2^-12, plus a
     floor; gradients whose controls read 1 - cosine above TOL_P11_WELL
     are noise-dominated and count for no planted fault), the ranks'
     parameters equal to the bit, five planted faults (BatchNorms on
     local statistics, the image-pool BatchNorm alone local, OHEM per
     rank, OHEM's sums over per-rank counts, rank 1's gradient
     unreduced) at least ten times over a bound, the launches a rank,
     ms/step with and without the gradient all-reduce (gloo through host
     memory: not a multi-GPU rate); (c) the same for stage 2 at phase
     8's shape, global batch 4, with the key pass's BatchNorms unsynced
     and the image-pool BatchNorms alone unsynced as its planted faults;
     (e) the stage-1 step of (b) in fp32 on the fp32 forms (4 a rank),
     every gradient gated (no noise-dominated exemption), the controls
     at 2^-20 and 2^-23, fp32 floors (`P11_F32_FLOORS`), BatchNorms local
     and rank 1 unreduced as its planted faults; (d) K1-K6 on cuda:1 where
     the machine has two cards, else the line "cuda:1 check not run".

Each main path (serve and train on each route, the profilers, the
modules) is driven with every launch count set to 0 just before it and
read just after. K1-K3, K5, K6, rows 12, 13 and 17 launch the Hopper
GEMMs (their fp32 forms the fp32 GEMMs) from C: the library counts those
launches by form where it makes them, and each path holds them exactly to what the kernels' own launches
imply (on a train path, with the blocks whose m is saved); row 16 runs
its products inside its one launch and adds none. Then
come three lines: a JSON object with each kernel's launches by path,
error, times and the least time the card could take for the same work
(`bound_ms`: the larger of the operations over the dense peak for their
type and the bytes over 3.35 TB/s, each input read and each output
written once), and its launches per fine-tune step (batch 8), per
evaluated frame (B = 1, full clip and streamed), per stage-1 step with
remat (batch 8) and per evaluated DeepLabV3+ frame, per DDP step through
the CLI (one rank, batch 8) and per rank of a two-rank step (batch 4 a
rank, stages 1 and 2, stage 1 in fp32), per fp32 stage-1 step (batch 8)
and per fp32 stage-2 step; the card's name and power limit (`nvidia-smi`);
and, last,
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
import warnings

TOL_REL = 1e-2        # K1-K3: ||kernel - plain|| / ||plain||
# (rows, C) of row 14's bf16 form off its warp-a-row widths (phase 2d)
ROW14_WIDE_CASES = ((40960, 48), (40960, 96), (40960, 3072))
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
STEP_MS = {}  # a train path's median ms/step, for phase 11 to print beside


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
             "gelu_bwd_sm90": ("gelu_bwd",), "wgrad_sm90": ("wgrad",),
             "linear_f32": ("fp32",), "wgrad_f32": ("wgrad_f32",)}


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
    from stswincl_tpu_torch.ops.attention import (fused_window_attention,
                                                  fused_window_attention_f32)
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
        "wgrad_sm90": gemm.wgrad_sm90,
        "swin_block_attention_f32": block_attention.swin_block_attention_f32,
        "swin_block_epilogue_f32": add_ln_mlp.swin_block_epilogue_f32,
        "patch_merge_f32": patch_merge.patch_merge_f32,
        "linear_f32": gemm.linear_f32,
        "swin_block_attention_bwd_f32":
            block_attention.swin_block_attention_bwd_f32,
        "swin_block_epilogue_bwd_f32": add_ln_mlp.swin_block_epilogue_bwd_f32,
        "wgrad_f32": gemm.wgrad_f32,
        "windowed_attention_image_f32":
            block_attention.windowed_attention_image_f32,
        "fused_window_attention_f32": fused_window_attention_f32,
        "whole_swin_block_f32": swin_block.whole_swin_block_f32,
        "fused_mlp_f32": mlp.fused_mlp_f32,
        "add_ln_mlp_f32": add_ln_mlp.add_ln_mlp_f32,
        "add_layer_norm_f32": add_layernorm.add_layer_norm_f32,
        "fused_layer_norm_f32": layernorm.fused_layer_norm_f32,
        "conv3x3_bn_act_f32": conv.conv3x3_bn_act_f32}


def reset_launches(wrappers) -> None:
    """Every kernel's launch count to 0, the library's GEMM counts and its
    counts of the attention's streamed instances too, with the card
    idle."""
    import torch
    from stswincl_tpu_torch.ops import attention as attn_ops
    from stswincl_tpu_torch.ops import block_attention as att
    from stswincl_tpu_torch.ops import gemm as gemm_ops
    from stswincl_tpu_torch.ops import swin_block as wb_ops
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    gemm_ops.launch_counts(reset=True)
    attn_ops.attn_streamed_launches(reset=True)
    attn_ops.attn_f32_streamed_launches(reset=True)
    att.attn_bwd_passes_launches(reset=True)
    att.attn_bwd_f32_streamed_launches(reset=True)
    for dt in (torch.bfloat16, torch.float32):
        wb_ops.streamed_launches(dt, reset=True)


def read_launches(wrappers) -> tuple:
    """(each kernel's launches since the reset, the library's counts by
    form). A kernel's count is its wrapper's; a Hopper GEMM row's is the
    library's, which also counts the launches made inside the C entries of
    K1, K2, K3, K5 and K6. The forms are the GEMM's, and "attn_streamed" /
    "attn_f32_streamed": the launches of the bf16 and fp32 attention
    cores' streamed instances (K1, rows 10, 11), "attn_bwd_passes" /
    "attn_bwd_f32_streamed": the runs of K5 bf16's two passes (its query
    pass streamed) and of K5 fp32's streamed passes (K5, `attn_bwd`,
    `attn_bwd_f32`), "whole_streamed" / "whole_f32_streamed": row 16's
    launches whose attention phase ran the streamed pair."""
    import torch
    from stswincl_tpu_torch.ops import attention as attn_ops
    from stswincl_tpu_torch.ops import block_attention as att
    from stswincl_tpu_torch.ops import gemm as gemm_ops
    from stswincl_tpu_torch.ops import swin_block as wb_ops
    forms = gemm_ops.launch_counts()
    forms["whole_streamed"] = wb_ops.streamed_launches(torch.bfloat16)
    forms["whole_f32_streamed"] = wb_ops.streamed_launches(torch.float32)
    forms["attn_streamed"] = attn_ops.attn_streamed_launches()
    forms["attn_f32_streamed"] = attn_ops.attn_f32_streamed_launches()
    forms["attn_bwd_passes"] = att.attn_bwd_passes_launches()
    forms["attn_bwd_f32_streamed"] = att.attn_bwd_f32_streamed_launches()
    counts = {k: fn.launches for k, fn in wrappers.items()}
    for k, fs in GEMM_ROWS.items():
        if k in counts:
            counts[k] = sum(forms[f] for f in fs)
    return counts, forms


def check_gemm_launches(tag, counts, forms, m_saved=None,
                        m_used=None, f32_recomputed=0) -> None:
    """The GEMM launches the library counted on a path against those that
    the kernels' own launches imply: K1 two bf16 products (qkv, proj); K2
    fc1 (bf16) and fc2 (bf16 m where the training forward saves it, else
    the fp32 residual); K3 one bf16 product (the 4C -> 2C reduction); K5
    two bf16 input-gradient products and two weight gradients; K6 dn2
    (f32) and two weight gradients, with m saved the fused pair, with m
    recomputed fc1 + gelu', m (bf16) and dh * gelu'; rows 12 and 13 two
    bf16 products (fc1, fc2); row 16 none (its products run inside its one
    launch); row 17 one "conv" product a call; the fp32 forms of K1 and K2
    two fp32 GEMM products each, K3's one, K5's two (dattn, dx) and K6's
    three (fc1 with gelu', dh * gelu', dn2) plus m where it recomputes m
    (`f32_recomputed` of its launches), and K5's and K6's two fp32 weight
    gradients in one fp32 weight-gradient launch each (dwqkv and dwproj,
    dw1 and dw2 in one queue); the fp32 forms of rows 12 and 13 two fp32 GEMM
    products each (fc1, fc2), row 17's one "conv_f32" product a call.
    `m_saved`: the block calls
    whose K2 saves m and whose K6 takes it (0 where nothing is trained;
    None where the path does not say); `m_used`, where it differs, the
    K6 launches that take a saved m (with remat K2 saves m in the forward
    and again in the recompute, and K6 takes one of them)."""
    k1, k2 = counts["swin_block_attention"], counts["swin_block_epilogue"]
    k3 = counts["patch_merge"]
    k5 = counts["swin_block_attention_bwd"]
    k6 = counts["swin_block_epilogue_bwd"]
    mlps = counts["fused_mlp"] + counts["add_ln_mlp"]
    mlps_f32 = (counts.get("fused_mlp_f32", 0)
                + counts.get("add_ln_mlp_f32", 0))
    rules = [("bf16 + resid_f32", forms["bf16"] + forms["resid_f32"],
              2 * k1 + 2 * k2 + k3 + 2 * k5 + forms["gelu_grad"]
              + 2 * mlps),
             ("gelu_grad + gelu_bwd", forms["gelu_grad"] + forms["gelu_bwd"],
              k6),
             ("dgelu", forms["dgelu"], forms["gelu_grad"]),
             ("f32", forms["f32"], k6),
             ("wgrad", forms["wgrad"], 2 * (k5 + k6)),
             ("conv", forms["conv"], counts["conv3x3_bn_act"]),
             ("fp32", forms["fp32"],
              2 * (counts["swin_block_attention_f32"]
                   + counts["swin_block_epilogue_f32"]
                   + counts["swin_block_attention_bwd_f32"])
              + counts["patch_merge_f32"] + 2 * mlps_f32
              + 3 * counts["swin_block_epilogue_bwd_f32"] + f32_recomputed),
             ("conv_f32", forms["conv_f32"],
              counts.get("conv3x3_bn_act_f32", 0)),
             ("wgrad_f32", forms["wgrad_f32"],
              counts["swin_block_attention_bwd_f32"]
              + counts["swin_block_epilogue_bwd_f32"])]
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


def attention_work(R: int, C: int, TN: int, heads: int, mask,
                   isz: int = 2) -> tuple:
    """(flops, bytes) of window attention over R token rows of C channels
    in windows of TN tokens: QK^T and PV, q, k, v read, the output
    written (`isz` bytes an element: 2 bf16, 4 fp32), the bias and mask
    tables read."""
    tables = heads * TN * TN * 4 + (0 if mask is None else mask.numel() * 4)
    return 4 * R * TN * C, 4 * R * C * isz + tables


def block_attention_work(x, heads: int, TN: int, mask) -> tuple:
    """K1: the qkv and proj products and the attention; x read, the
    output written, the weights read, in x's dtype."""
    C, isz = x.shape[-1], x.element_size()
    R = x.numel() // C
    fl, nb = attention_work(R, C, TN, heads, mask, isz)
    return (fl + 8 * R * C * C,
            nb - 4 * R * C * isz + 2 * R * C * isz + 4 * C * C * isz
            + 4 * C * 4)


def mlp_work(R: int, C: int, hidden: int, n_rows_io: int,
             isz: int = 2) -> tuple:
    """fc1 + fc2 over R rows; `n_rows_io` (R, C) tensors read or written
    and the weights read (`isz` bytes an element), the fp32 vectors
    read."""
    return (4 * R * C * hidden,
            n_rows_io * R * C * isz + 2 * C * hidden * isz
            + (hidden + 5 * C) * 4)


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

    # ---- phase 2g: the backwards at every window and width -------------
    t0 = time.perf_counter()
    phase_envelope_kernels(dev, results, median_ms)
    print(f"phase 2g the backwards' envelope and bits: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 2i: every kernel at the widths off C % 128 ---------------
    t0 = time.perf_counter()
    phase_widths_kernels(dev, results, median_ms)
    print(f"phase 2i the kernels at C 32-192, hd 8-48: "
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
              f"{wb_ops._slots(T, C, heads, ws, dev.index)} workspace slots",
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
    # row 14 off the warp-a-row widths: C 48 and 96 (the JAX kernel's own
    # tests) and 3072 (past 2048: the block-a-row kernel with y)
    # (a generator of their own: the later phases' inputs stay as they were)
    gen14 = torch.Generator(device=dev).manual_seed(14)
    for R, C in ROW14_WIDE_CASES:
        xt, yt = (torch.randn((R, C), generator=gen14, device=dev).to(bf16)
                  for _ in range(2))
        ln = (1.0 + 0.1 * torch.randn(C, generator=gen14, device=dev),
              0.1 * torch.randn(C, generator=gen14, device=dev))
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
        del xt, yt, ln
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

    # ---- phase 2h: a deterministic step; the models past the old
    # training envelope ---------------------------------------------------
    t0 = time.perf_counter()
    phase_envelope_train(dev, smi, wrappers, launches)
    print(f"phase 2h deterministic bf16 step, num_heads=2 and swin_dim=384 "
          f"trained: {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 2j: swin_dim 96 and 64 served and trained -----------------
    t0 = time.perf_counter()
    phase_widths_models(dev, smi, wrappers, launches)
    print(f"phase 2j swin_dim 96 and 64 served and trained: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 2k: fp32 past the resident pair ---------------------------
    t0 = time.perf_counter()
    phase_f32_streamed(dev, smi, wrappers, launches, results, median_ms)
    print(f"phase 2k fp32 attention past the resident pair, num_heads=2 and "
          f"swin_dim=768 in fp32: {time.perf_counter() - t0:.1f} s",
          flush=True)

    # ---- phase 2l: every head dim, both dtypes ---------------------------
    t0 = time.perf_counter()
    phase_attn_streamed(dev, smi, wrappers, launches, results, median_ms)
    print(f"phase 2l the attention past the bf16 resident pair, num_heads=1 "
          f"and swin_dim=1280 in both dtypes: {time.perf_counter() - t0:.1f}"
          " s", flush=True)

    # ---- phase 2m: row 16 at every shape K1 + K2 take ---------------------
    pair_ms_2m = phase_whole_block_envelope(dev, smi, wrappers, launches,
                                            results, median_ms)

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

    # ---- phase 7: fp32 serving and evaluation on the kernels -------------
    t0 = time.perf_counter()
    fp32_counts = phase_fp32(dev, smi, wrappers, launches, results,
                             median_ms)
    print(f"phase 7 fp32 forms, serving, evaluation and training: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

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

    # ---- phase 11: data parallelism --------------------------------------
    t0 = time.perf_counter()
    parallel_counts = phase_parallel(dev, bf16, smi, wrappers, launches)
    print(f"phase 11 data parallelism: {time.perf_counter() - t0:.1f} s",
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
        "whole_swin_block": ("swin_block.cuh",
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
        "swin_block_attention_f32": (
            "fp32_forms.cu", "stswincl_tpu/ops/pallas_block_attention.py:320"
            " (fp32)"),
        "swin_block_epilogue_f32": (
            "fp32_forms.cu", "stswincl_tpu/ops/pallas_add_ln_mlp.py:895 and "
            ":1012 shifted, :802 with m (fp32)"),
        "patch_merge_f32": (
            "fp32_forms.cu", "stswincl_tpu/ops/pallas_patch_merge.py:122 "
            "(fp32)"),
        "linear_f32": (
            "fp32_forms.cu", "the fp32 matmuls of stswincl_tpu/ops/"
            "pallas_block_attention.py:179, pallas_add_ln_mlp.py:704 and "
            ":940, pallas_patch_merge.py:41"),
        "swin_block_attention_bwd_f32": (
            "fp32_train.cu", "stswincl_tpu/ops/pallas_block_attention.py:547"
            " (fp32)"),
        "swin_block_epilogue_bwd_f32": (
            "fp32_train.cu", "stswincl_tpu/ops/pallas_add_ln_mlp.py:310, "
            "and :557 with m (fp32)"),
        "wgrad_f32": (
            "fp32_train.cu", "the fp32 weight-gradient matmuls of "
            "stswincl_tpu/ops/pallas_block_attention.py:405 and "
            "pallas_add_ln_mlp.py:181, :425"),
        "windowed_attention_image_f32": (
            "fp32_forms.cu", "stswincl_tpu/ops/pallas_block_attention.py:128"
            " (fp32)"),
        "fused_window_attention_f32": (
            "fp32_forms.cu", "stswincl_tpu/ops/pallas_attention.py:118 "
            "(fp32)"),
        "whole_swin_block_f32": (
            "fp32_whole_block.cuh",
            "stswincl_tpu/ops/pallas_swin_block.py:229 (fp32)"),
        "fused_mlp_f32": ("fp32_offpath.cu",
                          "stswincl_tpu/ops/pallas_mlp.py:226 (fp32)"),
        "add_ln_mlp_f32": (
            "fp32_offpath.cu",
            "stswincl_tpu/ops/pallas_add_ln_mlp.py:97 (fp32)"),
        "add_layer_norm_f32": (
            "add_layernorm.cu",
            "stswincl_tpu/ops/pallas_add_layernorm.py:110 (fp32)"),
        "fused_layer_norm_f32": (
            "add_layernorm.cu", "stswincl_tpu/ops/pallas_layernorm.py:82 "
            "(fp32)"),
        "conv3x3_bn_act_f32": ("fp32_forms.cu",
                               "stswincl_tpu/ops/pallas_conv.py:132 (fp32)"),
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
    row16["pair_ms"] = pair_ms | pair_ms_2m  # its yardstick; not a library
    # call (phase 2m's cases carry theirs, both forms)
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
             "attention core (attention_core.cuh: the resident or the "
             "streamed pair), K2's LN order; the first kernel's shapes on "
             "their own instances (swin_block.cu), every other shape K1 + "
             "K2 take on the wide ones (swin_block_wide.cu)"),
            ("whole_swin_block_f32", "one persistent launch: the fp32 GEMM "
             "tile (fp32_gemm.cuh) for its four products, K1's fp32 "
             "attention core (fp32_attention.cuh: the resident or the "
             "streamed pair), K2's fp32 LN order; the first form's shapes "
             "on their own instances (fp32_whole_block.cu), the rest on "
             "the wide ones (fp32_whole_block_wide.cu); each case's pair_ms "
             "is the fp32 K1 + K2 pair on its inputs")):
        next(r for r in rows if r["name"] == name)["design"] = design
    core = ("one launch; fp32_attention.cuh: attn32::pairs (the resident "
            "pair) where q, k and v fit a block, else attn32::pairs_streamed"
            " (a ring of 32-column q / k and 64-column v chunks) for the "
            "rest of K1's bf16 windows")
    for name, inst in (
            ("swin_block_attention_f32", core),
            ("windowed_attention_image_f32", core),
            ("fused_window_attention_f32", core),
            ("swin_block_attention_bwd_f32", "fp32_attention_bwd.cuh: "
             "q_kernel + kv_kernel (resident) where they fit, else qs_kernel "
             "+ kvs_kernel (streamed: hd in chunks, P and dS through a "
             "workspace)")):
        row = next(r for r in rows if r["name"] == name)
        row["instances"] = inst
        row["streamed_launches"] = STREAMED_LAUNCHES
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
        # phase 11: a DDP step through the CLI (one rank, batch 8), and a
        # rank's step of two (batch 4 a rank) in stage 1 and stage 2
        r["per_ddp_step"] = parallel_counts["per_ddp_step"][r["name"]]
        r["per_rank_parallel_step"] = {
            stage: parallel_counts[f"per_rank_{stage}_step"][r["name"]]
            for stage in ("seg", "contrast", "seg_fp32")}
        # phase 7: an fp32 stage-1 step at batch 8 (d), a stage-2 step (e)
        for key, by_name in fp32_counts.items():
            r[key] = by_name[r["name"]]
    print(json.dumps({"kernels": rows}))
    print(smi)
    if FAILED:
        raise SystemExit(f"chip_smoke: {len(FAILED)} checks failed: "
                         + "; ".join(FAILED))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def k5_work(x, heads: int, TN: int, mask) -> tuple:
    """K5: five attention products, the input- and weight-gradient
    products of qkv and proj; x, g, qkv, attn read, dx written, the
    weights read (in x's dtype) and their fp32 gradients written."""
    C, isz = x.shape[-1], x.element_size()
    R = x.numel() // C
    fl, tables = attention_work(R, C, TN, heads, mask, isz)
    return (2.5 * fl + 16 * R * C * C,
            tables - 4 * R * C * isz + heads * TN * TN * 4
            + 7 * R * C * isz + 4 * C * C * (isz + 4) + 4 * C * 4)


def k6_work(x, hidden: int, with_m, shift) -> tuple:
    """K6: fc1 (and fc2 without a saved m) recomputed, dh, dn2, dw1,
    dw2; x, y, g (and m) read, dx (and dy when shifted) written, the
    weights read (in x's dtype) and their fp32 gradients written."""
    C, isz = x.shape[-1], x.element_size()
    R = x.numel() // C
    n_io = 3 + bool(with_m) + 1 + bool(shift)
    return ((5 if with_m else 6) * 2 * R * C * hidden,
            n_io * R * C * isz + 2 * C * hidden * (isz + 4)
            + (2 * hidden + 9 * C) * 4)


# Phase 2g: K5 in bf16 past its one-pass slot kernel, at windows K1 takes
# (label: x's shape (B, T, H, W, C), heads, ws): head dims 192-288 at TN
# 128 (`swin_dim` 768 / 512 / 1152 over 4 / 2 / 4 heads; 512 over 2 is
# `ModelConfig(num_heads=2)`'s stage 1 at its training batch), TN 144
# (ws 6, T 4) and 176 (ws 4, T 11, hd 208: K1's widest window at its
# widest head dim), and TN 32 at hd 512 (`num_heads=2`'s stage 2, on the
# slot kernel); beside them the two training shapes (slot kernel)
K5_ENVELOPE = {
    "TN128 hd192": ((8, 2, 64, 80, 768), 4, 8),
    "TN128 hd256": ((16, 2, 64, 80, 512), 2, 8),
    "TN128 hd288": ((4, 2, 64, 80, 1152), 4, 8),
    "TN144 hd64": ((8, 4, 48, 60, 256), 4, 6),
    "TN176 hd208": ((2, 11, 32, 40, 1664), 8, 4),
    "TN32 hd512": ((16, 2, 32, 40, 1024), 2, 4),
    "stage1 TN128 hd128": ((16, 2, 64, 80, 512), 4, 8),
    "stage2 TN32 hd256": ((16, 2, 32, 40, 1024), 4, 4),
}
# K6 in both forms at widths its row passes now take (label: x's shape,
# ws): `swin_dim` 384's stage 1 (C 384) and stage 2 (C 768), C 1536 (a
# block a row), beside the training widths 512 and 1024
K6_ENVELOPE = {
    "C384": ((16, 2, 64, 80, 384), 8),
    "C768": ((16, 2, 32, 40, 768), 4),
    "C1536": ((4, 2, 32, 40, 1536), 4),
    "C512": ((16, 2, 64, 80, 512), 8),
    "C1024": ((16, 2, 32, 40, 1024), 4),
}


def hold_outputs(results, median_ms, kname, case, names, kfn, pfn, tol,
                 work, faults, peak, counter=None):
    """kfn() (twice: bit-equal) against pfn() on every output within
    `tol`; each (fault, outputs) of `faults` must miss `tol` tenfold; then
    both timed (`median_ms`, 3 calls after 2 warm-ups) beside the bound of
    `work` at `peak`, the row added to `results[kname]`. With `counter`
    (a wrapper), its launches must rise by exactly kfn's 7 calls."""
    import torch
    n0 = None if counter is None else counter.launches
    got = kfn()
    again = kfn()
    torch.cuda.synchronize()
    bit = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    want = pfn()
    rels = {n: rel_err(a, b) for n, a, b in zip(names, got, want)}
    max_abs = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got, want))
    for n, r in rels.items():
        check(r <= tol, f"{kname} {case} {n}: relative error {r} > {tol}")
    check(bit, f"{kname} {case}: two calls on the same inputs differ")
    for fault, bad in faults:
        moved = max_rel_err(bad(), want)
        print(f"  {'':24s} {case:34s} the twin {fault} moves by rel "
              f"{moved:.3e} ({moved / tol:.0f}x the bound)", flush=True)
        check(moved > 10 * tol, f"{kname} {case}: the twin {fault} "
              f"moves the output by only {moved}")
    del got, want
    torch.cuda.empty_cache()
    row = {"case": case, "max_abs_err": max_abs,
           "rel_err": max(rels.values()), "rel_errs": rels,
           "bit_equal": bit, "ms": median_ms(kfn, reps=3),
           "plain_ms": median_ms(pfn, reps=3), "library_ms": None,
           **bound(*work, peak=peak)}
    results.setdefault(kname, []).append(row)
    print(f"  {kname:24s} {case:34s} max rel {row['rel_err']:.3e} "
          f"bit-equal {bit}; kernel {row['ms']:.3f} ms plain "
          f"{row['plain_ms']:.3f} ms bound {row['bound_ms']:.3f} ms "
          f"({row['bound_ms'] / row['ms']:.2f} of it)", flush=True)
    print("      " + " ".join(f"{n} {r:.2e}" for n, r in rels.items()),
          flush=True)
    if counter is not None:
        check(counter.launches - n0 == 7, f"{kname} {case}: "
              f"{counter.launches - n0} launches for two calls and three "
              "timed ones after two warm-ups, expected 7")
    torch.cuda.empty_cache()


def phase_envelope_kernels(dev, results, median_ms) -> None:
    """Phase 2g: the training backwards at every window and width their
    forwards take, and the bf16 backward's bits. K5 bf16 at K5_ENVELOPE
    (both shifts; the one-pass slot kernel or the two passes, by shape)
    against its twin within TOL_REL, its planted faults (no dbias, no
    row-sum term) missing tenfold; K6 bf16 (TOL_REL; no LN2 path, gelu'
    as 1) and fp32 (TOL_F32_REL; the same faults, and the twin on TF32
    products printed) at K6_ENVELOPE, row 7 (m recomputed, shifted) and
    row 9 (given row 8's m); every one bit-equal across two calls on the
    same inputs, and so K3's backward and `wgrad_sm90` alone. Times
    beside the twin and the bound."""
    import torch
    from stswincl_tpu_torch.ops import add_ln_mlp as epi
    from stswincl_tpu_torch.ops import block_attention as att
    from stswincl_tpu_torch.ops import gemm as gemm_ops
    from stswincl_tpu_torch.ops import patch_merge as pm
    from stswincl_tpu_torch.ops.window import shifted_window_attention_mask

    gen = torch.Generator(device=dev).manual_seed(23)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def uniform(*shape, fan_in, dtype=bf16, gain=1.0):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1)
                * gain * fan_in ** -0.5).to(dtype)

    hold = functools.partial(hold_outputs, results, median_ms)

    attn_names = ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias")
    for label, (shape, heads, ws) in K5_ENVELOPE.items():
        B, T, h, w, C = shape
        TN, hd = T * ws * ws, C // heads
        x, g = randn(*shape), randn(*shape)
        # a peaked softmax (as phase 2b), so that the row-sum term of dS
        # is a sizeable share
        wqkv = uniform(3 * C, C, fan_in=C, gain=3.0)
        bqkv = uniform(3 * C, fan_in=C, dtype=f32)
        wproj = uniform(C, C, fan_in=C, gain=2.0)
        bproj = uniform(C, fan_in=C, dtype=f32)
        bias = randn(heads, TN, TN, dtype=f32)
        path = ("one-pass slot kernel" if att._attn_bwd_slot_takes(TN, hd)
                else "two passes")
        for shift in (0, ws // 2):
            mask = None
            if shift:
                mask = torch.from_numpy(shifted_window_attention_mask(
                    h, w, ws, shift)).repeat(1, T, T).to(dev)
            fwd = (x, wqkv, bqkv, wproj, bproj, bias, mask, heads,
                   hd ** -0.5, ws, shift)
            _, qkv, attn = att._forward_kernel(*fwd)
            n = att.swin_block_attention_bwd.launches
            hold("swin_block_attention_bwd",
                 f"{label} {shape} shift={shift} ({path})", attn_names,
                 lambda: att.swin_block_attention_bwd(
                     x, g, qkv, attn, wqkv, wproj, bias, mask, *fwd[7:]),
                 lambda: att.swin_block_attention_bwd_ref(*fwd[:7], g,
                                                          *fwd[7:]),
                 TOL_REL, k5_work(x, heads, TN, mask),
                 [("without dbias", lambda: (
                     lambda w_: w_[:5] + (torch.zeros_like(w_[5]),))(
                         att.swin_block_attention_bwd_ref(*fwd[:7], g,
                                                          *fwd[7:]))),
                  ("without the row-sum term (dS = P dP)",
                   lambda: attention_bwd_without_rowsum(*fwd[:7], g,
                                                        *fwd[7:]))],
                 PEAK_BF16)
            check(att.swin_block_attention_bwd.launches == n + 7,
                  f"swin_block_attention_bwd {label}: "
                  f"{att.swin_block_attention_bwd.launches - n} launches "
                  "for two calls and three timed ones after two warm-ups")
            del qkv, attn
        del x, g
        torch.cuda.empty_cache()

    epi_names = ("dx", "dy", "ds2", "db2", "dw1", "db1", "dw2", "dbw2",
                 "ds1", "db1n")
    for label, (shape, ws) in K6_ENVELOPE.items():
        C = shape[-1]
        hidden = 4 * C
        for dtype in (bf16, f32):
            x, y, g = randn(*shape, dtype=dtype), randn(*shape, dtype=dtype), \
                randn(*shape, dtype=dtype)
            p = (1.0 + randn(C, scale=0.1, dtype=f32),
                 randn(C, scale=0.1, dtype=f32),
                 uniform(hidden, C, fan_in=C, gain=2.0, dtype=dtype),
                 uniform(hidden, fan_in=C, dtype=f32),
                 uniform(C, hidden, fan_in=hidden, gain=2.0, dtype=dtype),
                 uniform(C, fan_in=hidden, dtype=f32),
                 1.0 + randn(C, scale=0.1, dtype=f32),
                 randn(C, scale=0.1, dtype=f32))
            bf = dtype == bf16
            kname = ("swin_block_epilogue_bwd" if bf
                     else "swin_block_epilogue_bwd_f32")
            kfn = (epi.swin_block_epilogue_bwd if bf
                   else epi.swin_block_epilogue_bwd_f32)
            for row, shift in (("row 7", ws // 2), ("row 9", 0)):
                kw = dict(gelu_exact=True, shift=shift, ws=ws)
                m = None
                if row == "row 9":
                    m = (epi._forward_kernel(x, y, *p, eps=1e-5, with_m=True,
                                             **kw)[1] if bf else
                         epi.swin_block_epilogue_f32(x, y, *p, m_out=True,
                                                     **kw)[1])
                faults = [("without the LN2 path",
                           lambda: epilogue_bwd_without_ln2_path(
                               x, y, *p, g, **kw)),
                          ("with gelu' as 1",
                           lambda: epilogue_bwd_with_unit_gelu_grad(
                               x, y, *p, g, **kw))]
                hold(kname, f"{label} {shape} {row} shift={shift}",
                     epi_names, lambda: kfn(x, y, g, m, *p[:7], **kw),
                     lambda: epi.swin_block_epilogue_bwd_ref(x, y, *p, g,
                                                             **kw),
                     TOL_REL if bf else TOL_F32_REL,
                     k6_work(x, hidden, m is not None, shift), faults,
                     PEAK_BF16 if bf else PEAK_3XTF32)
                if not bf:
                    with tf32_products():
                        bad = epi.swin_block_epilogue_bwd_ref(x, y, *p, g,
                                                              **kw)
                    moved = max_rel_err(bad, epi.swin_block_epilogue_bwd_ref(
                        x, y, *p, g, **kw))
                    del bad
                    print(f"  {'':24s} the fp32 twin on TF32 products "
                          f"moves by rel {moved:.3e} (printed)", flush=True)
                del m
            del x, y, g, p
            torch.cuda.empty_cache()

    # K3's backward and the weight-gradient GEMM alone, bit-equal
    x = randn(16, 64, 80, 512)
    scale = 1.0 + randn(2048, scale=0.1, dtype=f32)
    shift_ = randn(2048, scale=0.1, dtype=f32)
    wm = uniform(1024, 2048, fan_in=2048, dtype=f32)
    gm = randn(16, 32, 40, 1024)

    def k3_bwd():
        leaves = [t.detach().requires_grad_() for t in (x, scale, shift_, wm)]
        return torch.autograd.grad(pm.patch_merge(*leaves), leaves, gm)
    a, b = k3_bwd(), k3_bwd()
    bit = all(torch.equal(u, v) for u, v in zip(a, b))
    print(f"  K3's backward (16, 64, 80, 512): bit-equal across two calls "
          f"{bit}", flush=True)
    check(bit, "K3's backward: two calls on the same inputs differ")
    del a, b, x, gm
    dq, xr = randn(163840, 1536), randn(163840, 512)
    cases = [("dwqkv s1", dq, xr, None, (2, 64, 80, 8, 4))]
    for case, A, Bm, am, bm in cases:
        a = gemm_ops.wgrad_sm90(A, Bm, am, bm)
        b = gemm_ops.wgrad_sm90(A, Bm, am, bm)
        torch.cuda.synchronize()
        bit = torch.equal(a, b)
        rel = rel_err(a, gemm_ops.wgrad_sm90_ref(A, Bm, am, bm))
        print(f"  wgrad_sm90 {case} ({A.shape[0]} rows, {tuple(a.shape)}): "
              f"bit-equal {bit}, rel {rel:.2e} against its twin", flush=True)
        check(bit, f"wgrad_sm90 {case}: two calls differ")
        check(rel <= TOL_F32_REL * 10, f"wgrad_sm90 {case}: rel {rel}")
    del dq, xr
    torch.cuda.empty_cache()


# Phase 2h (c): the configurations past the old training envelope, each
# stage 1 at batch 8 through `build_model` and `SegTrainStep`: label ->
# (ModelConfig fields, dtype)
ENVELOPE_MODELS = {
    "num_heads=2": (dict(num_heads=2), "bfloat16"),      # hd 256 / 512
    "swin_dim=384": (dict(swin_dim=384), "bfloat16"),     # C 384 / 768
    "swin_dim=384 fp32": (dict(swin_dim=384), "float32"),
    # past the fp32 resident pair: the streamed instances (phase 2k)
    "num_heads=2 fp32": (dict(num_heads=2), "float32"),
}
ENVELOPE_STEPS = 3


def route_fields(fields) -> tuple:
    """A model entry's ModelConfig fields without "whole_block", and that
    flag (`TswinPlus(whole_block=True)`: row 16 on the W-MSA blocks, which
    ModelConfig does not carry)."""
    fields = dict(fields)
    return fields, fields.pop("whole_block", False)


def set_whole_block(model, on: bool):
    """`model` with its swin blocks' `whole_block` set to `on` (as
    `TswinPlus(whole_block=on)` builds them)."""
    from stswincl_tpu_torch.models.swin import SpaceTimeSwinBlock
    for mod in model.modules():
        if isinstance(mod, SpaceTimeSwinBlock):
            mod.whole_block = on
    return model


def envelope_model(dev, cfg, seed=0, kernels=None, state=None,
                   whole_block=False):
    """`cfg`'s model from seeded weights (`state`, or drawn from `seed`),
    in train mode: `build_model` on the kernels, or the same TswinPlus with
    `kernels=False` for the twin; with `whole_block` its W-MSA blocks on
    row 16."""
    import torch
    from stswincl_tpu_torch.models import TswinPlus
    from stswincl_tpu_torch.pipelines.common import build_model
    if kernels is None:
        m, _ = build_model(cfg.model, cfg.data, device=dev)
    else:
        mc = cfg.model
        m = TswinPlus(mc.num_classes, swin_dim=mc.swin_dim,
                      num_heads=mc.num_heads, gelu_exact=mc.gelu_exact,
                      swin_depths=tuple(mc.swin_depths),
                      dtype=getattr(torch, mc.dtype),
                      input_hw=tuple(cfg.data.crop_hw),
                      attn_impl=mc.attn_impl, kernels=kernels).to(dev)
    if state is None:
        state = envelope_state(cfg, seed)
    m.load_state_dict(state)
    return set_whole_block(m, whole_block).train()


_ENVELOPE_STATE = {}  # the last drawn weights: (shape, seed) -> state


def envelope_state(cfg, seed=0) -> dict:
    """The seeded weights of `cfg`'s model (`envelope_model`), drawn on the
    CPU: fp32 whatever the model's dtype, so the last ones drawn are kept
    and handed out again for the same shapes and seed (a 0.63 B-parameter
    `swin_dim=1280` draw takes seconds)."""
    import torch
    from stswincl_tpu_torch.models import TswinPlus
    from stswincl_tpu_torch.models.init import init_weights
    mc = cfg.model
    key = (mc.num_classes, mc.swin_dim, mc.num_heads,
           tuple(mc.swin_depths), tuple(cfg.data.crop_hw), seed)
    if key not in _ENVELOPE_STATE:
        _ENVELOPE_STATE.clear()
        _ENVELOPE_STATE[key] = init_weights(TswinPlus(
            mc.num_classes, swin_dim=mc.swin_dim, num_heads=mc.num_heads,
            swin_depths=tuple(mc.swin_depths), dtype=getattr(torch, mc.dtype),
            input_hw=tuple(cfg.data.crop_hw)),
            torch.Generator().manual_seed(seed)).state_dict()
    return _ENVELOPE_STATE[key]


def envelope_steps(cfg, m, n, x, y):
    """n steps of `m` on (x, y) with `cfg`'s optimiser and loss: (losses,
    the first step's gradients, seconds a step)."""
    import torch
    from stswincl_tpu_torch.pipelines.seg import make_tx
    from stswincl_tpu_torch.train.train_seg import make_seg_train_step
    opt, schedule = make_tx(cfg, n, m)
    step = make_seg_train_step(m, opt, schedule, cfg.loss,
                               ohem_thresh=cfg.ohem_thresh)
    grads = {}
    hook = opt.register_step_pre_hook(lambda *_: grads.update(
        {k: p.grad.detach().clone() for k, p in m.named_parameters()})
        if not grads else None)
    losses, secs = [], []
    for _ in range(n):
        ts = time.perf_counter()
        losses.append(float(step(x, y)["loss"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - ts)
    hook.remove()
    return losses, grads, secs


def phase_envelope_train(dev, smi, wrappers, launches) -> None:
    """Phase 2h: (a) a bf16 stage-1 step (`ModelConfig()`, batch 8) twice
    from the same weights and batch under PyTorch's deterministic
    algorithms and cuDNN deterministic (phase 7 (d)'s settings): the loss
    and every gradient bit-equal; (b) whether row 16 takes
    `num_heads=2`'s windows (its own envelope, not widened here); (c)
    `phase_config_train` on ENVELOPE_MODELS."""
    import torch
    from stswincl_tpu_torch.configs import SegTrainConfig
    from stswincl_tpu_torch.ops.swin_block import whole_block_plan

    imgs, lbls = seeded_batch(8, seed=3)
    images = torch.from_numpy(imgs).to(dev)
    labels = torch.from_numpy(lbls).to(dev).long()

    # (a) the bf16 step's bits under the deterministic settings
    cfg = SegTrainConfig()
    det = torch.are_deterministic_algorithms_enabled()
    cudnn_det = torch.backends.cudnn.deterministic
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            runs = [envelope_steps(cfg, envelope_model(dev, cfg), 1, images,
                                   labels) for _ in range(2)]
    finally:
        torch.use_deterministic_algorithms(det)
        torch.backends.cudnn.deterministic = cudnn_det
    (la, ga, _), (lb, gb, _) = runs
    same = [k for k in ga if torch.equal(ga[k], gb[k])]
    print(f"  [deterministic] bf16 stage-1 step at batch 8 twice: losses "
          f"{la[0]!r} / {lb[0]!r}, {len(same)} of {len(ga)} gradients "
          f"bit-equal", flush=True)
    check(la == lb and len(same) == len(ga), "bf16 stage-1 step under "
          f"the deterministic settings: {len(ga) - len(same)} gradients "
          f"differ ({[k for k in ga if k not in same][:5]}), losses {la} "
          f"/ {lb}")
    del runs, ga, gb, images, labels
    torch.cuda.empty_cache()

    # (b) row 16 on num_heads=2's windows
    for C, T, h, w, ws, heads in ((512, 2, 64, 80, 8, 2),
                                  (1024, 2, 32, 40, 4, 2)):
        try:
            whole_block_plan(8, T, h, w, C, 4 * C, heads, ws)
            took = "takes it"
        except ValueError as e:
            took = f"refuses it ({e})"
        print(f"  [row 16] num_heads=2 at C {C} (hd {C // heads}, TN "
              f"{T * ws * ws}): the whole-block kernel {took}", flush=True)

    # (c) the configurations
    phase_config_train(dev, smi, wrappers, launches, ENVELOPE_MODELS)


def phase_config_train(dev, smi, wrappers, launches, models) -> None:
    """Each of `models` (label -> (ModelConfig fields, dtype)) through
    `pipelines.build_model` and `SegTrainStep` on 'pallas_full',
    ENVELOPE_STEPS stage-1 steps at batch 8 on the kernels: finite
    losses, K1, K2, K5 and K6 launched once a block call and K3 once a
    merge (hooks count the calls), ms/step, peak memory; the first step's
    gradients held as phases 4 and 7 (d) hold theirs: bf16 against the
    twin step at batch 8 (`hold_gradients`: cosines at or above
    TOL_GRAD_COS_FLOOR, zero-gradient conv biases to their norm bound),
    fp32 by `fp32_step_gate` at batch 2 (the twin step, its controls and
    held faults). An entry with "whole_block" in its fields runs its
    W-MSA blocks on row 16 (`route_fields`), launched once a W-MSA block
    call; in bf16 it steps on phase 4e's batch and is gated as phase 4e
    gates: against the twin step and, each 1 - cosine, against a control
    with row 16's function on the pair's kernels. Phase 2h (c) runs it on
    ENVELOPE_MODELS, phase 2j on WIDTH_MODELS and WHOLE_WIDTH_MODELS."""
    import torch
    import torch.utils.checkpoint
    from stswincl_tpu_torch.configs import ModelConfig, SegTrainConfig
    from stswincl_tpu_torch.models import swin as swin_models
    from stswincl_tpu_torch.models.aspp import ConvBNRelu
    from stswincl_tpu_torch.models.swin import (PatchMerging,
                                                SpaceTimeSwinBlock)
    from stswincl_tpu_torch.ops.block_attention import (
        _attn_bwd_slot_takes, _attn_f32_bwd_resident)
    from stswincl_tpu_torch.ops.swin_block import whole_swin_block_pair

    imgs, lbls = seeded_batch(8, seed=3)
    batch3 = (torch.from_numpy(imgs).to(dev),
              torch.from_numpy(lbls).to(dev).long())
    for label, (fields, dtype) in models.items():
        fields, whole = route_fields(fields)
        cfg = SegTrainConfig(model=ModelConfig(**fields, dtype=dtype))
        f32 = dtype == "float32"
        sfx = "_f32" if f32 else ""
        tag = f"[envelope {label}]"
        images, labels = batch3
        if whole and not f32:  # phase 4e's batch (its control: below)
            imgs, lbls = seeded_batch(8, seed=ROUTE_TRAIN_SEED)
            images = torch.from_numpy(imgs).to(dev)
            labels = torch.from_numpy(lbls).to(dev).long()
        m = envelope_model(dev, cfg, whole_block=whole)
        # "past": the block calls whose window is past K5's resident
        # passes in fp32, its slot kernel in bf16; "whole": the W-MSA
        # block calls row 16 takes (whose backward re-runs K1 + K2, so
        # K1, K2, K5 and K6 still run once a block call)
        calls = {"block": 0, "merge": 0, "past": 0, "whole": 0}

        def count(mod, inputs, out):
            if isinstance(mod, PatchMerging):
                calls["merge"] += 1
            elif isinstance(mod, SpaceTimeSwinBlock):
                calls["block"] += 1
                calls["whole"] += whole and mod.shift_size == 0
                x = inputs[0]
                TN = x.shape[1] * mod.window_size ** 2
                hd = x.shape[-1] // mod.num_heads
                calls["past"] += not (_attn_f32_bwd_resident(TN, hd) if f32
                                      else _attn_bwd_slot_takes(TN, hd))
        hook = torch.nn.modules.module.register_module_forward_hook(count)
        reset_launches(wrappers)
        torch.cuda.reset_peak_memory_stats()
        try:
            losses, grads_k, secs = envelope_steps(cfg, m, ENVELOPE_STEPS, images,
                                             labels)
        finally:
            hook.remove()
        counts, forms = read_launches(wrappers)
        # K5's streamed attention backward (fp32: its streamed passes;
        # bf16: its two passes): exactly once for each block call whose
        # window is past its resident passes or slot kernel
        streamed_b = forms["attn_bwd_f32_streamed" if f32
                           else "attn_bwd_passes"]
        STREAMED_LAUNCHES[f"envelope {label}: backward in "
                          f"{ENVELOPE_STEPS} steps"] = streamed_b
        print(f"  {tag} K5{sfx}'s streamed backward ran {streamed_b} "
              f"times for {calls['past']} block calls past its resident "
              "instance", flush=True)
        check(streamed_b == calls["past"], f"{tag}: the streamed "
              f"backward ran {streamed_b} times for {calls['past']} "
              "block calls past the resident instance")
        launches[f"envelope {label}"] = counts
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        zero_grad = {f"{n}.conv.bias" for n, mod in m.named_modules()
                     if isinstance(mod, ConvBNRelu)}
        del m
        torch.cuda.empty_cache()
        ms = 1e3 * statistics.median(secs[1:])
        print(f"  {tag} C {cfg.model.swin_dim} / {2 * cfg.model.swin_dim}, "
              f"{cfg.model.num_heads} heads (hd "
              f"{cfg.model.swin_dim // cfg.model.num_heads} / "
              f"{2 * cfg.model.swin_dim // cfg.model.num_heads}), batch 8: "
              f"losses {[round(v, 5) for v in losses]}, {ms:.1f} ms/step "
              f"(median of steps 2-{ENVELOPE_STEPS}), peak {peak:.2f} GiB, "
              f"{calls} calls, launches "
              f"{ {k: v for k, v in counts.items() if v} } on {smi}",
              flush=True)
        check(all(math.isfinite(v) for v in losses), f"{tag} losses {losses}")
        for k in ("swin_block_attention", "swin_block_epilogue",
                  "swin_block_attention_bwd", "swin_block_epilogue_bwd"):
            check(counts[k + sfx] == calls["block"], f"{tag}: {k + sfx} "
                  f"launched {counts[k + sfx]} times for {calls['block']} "
                  "block calls")
        check(counts["patch_merge" + sfx] == calls["merge"],
              f"{tag}: patch_merge{sfx} launched "
              f"{counts['patch_merge' + sfx]} times for {calls['merge']}")
        check(counts["whole_swin_block" + sfx] == calls["whole"],
              f"{tag}: whole_swin_block{sfx} launched "
              f"{counts['whole_swin_block' + sfx]} times for "
              f"{calls['whole']} W-MSA block calls")
        other = ("_f32" not in k if f32 else k.endswith("_f32")
                 for k in counts)
        check(not any(n for (k, n), o in zip(counts.items(), other)
                      if o and k != "upsample_argmax"),
              f"{tag}: kernels of the other dtype launched")
        if f32:
            weights = envelope_model(dev, cfg).state_dict()
            kw = dict(num_classes=cfg.model.num_classes,
                      swin_dim=cfg.model.swin_dim,
                      num_heads=cfg.model.num_heads,
                      swin_depths=tuple(cfg.model.swin_depths),
                      input_hw=(H, W))
            b2 = images[:BS], labels[:BS]
            step_of = fp32_seg_step_of(dev, weights, kw,
                                       **({"whole_block": True} if whole
                                          else {}))
            loss_k, g2, _ = step_of(*b2)
            fp32_step_gate(f"{tag} batch {BS}", step_of, *b2, loss_k, g2)
            del weights, g2
        else:
            plain = envelope_model(dev, cfg, kernels=False,
                                   whole_block=whole)
            for mod in plain.modules():
                if isinstance(mod, SpaceTimeSwinBlock):
                    mod.forward = functools.partial(
                        torch.utils.checkpoint.checkpoint, mod.forward,
                        use_reentrant=False)
            few = set()
            with few_value_batchnorms(plain, few):
                loss_p, grads_p, _ = envelope_steps(cfg, plain, 1, images, labels)
            del plain
            rel = abs(losses[0] - loss_p[0]) / abs(loss_p[0])
            print(f"  {tag} loss kernels {losses[0]:.6f} twin "
                  f"{loss_p[0]:.6f} (rel {rel:.2e})", flush=True)
            check(rel <= TOL_TRAIN_LOSS, f"{tag}: loss rel {rel}")
            control = None
            if whole:
                # as phase 4e: a control on the same batch, the same route
                # with row 16's function on the pair's kernels (m rounded:
                # K1, K2's m form, K6 taking that m, K5), which runs no row
                # 16, itself held to the floor. Rounding m lifts the
                # kernel-against-twin noise of the gradients summed over
                # every token: on the phase-2j batch the layer1 stem-side
                # BatchNorm bias read 0.97646 with row 16 and 0.97646 with
                # this control, 0.98307 on 'pallas_full'; on phase 4e's
                # batch every cosine of the three read >= 0.9917 (my chip
                # run, PR 27)
                mc = envelope_model(dev, cfg, whole_block=True)
                with unittest.mock.patch.object(
                        swin_models, "whole_swin_block",
                        functools.partial(whole_swin_block_pair,
                                          m_out=True)):
                    _, grads_c, _ = envelope_steps(cfg, mc, 1, images,
                                                   labels)
                del mc
                control = hold_gradients(
                    f"{tag} (control)", "pallas_full (pair, m rounded)",
                    grads_c, grads_p, zero_grad, few, None)
                del grads_c
            hold_gradients(tag, "pallas_full", grads_k, grads_p, zero_grad,
                           few, control)
            del grads_p
        del grads_k
        torch.cuda.empty_cache()


# Phase 2i: the widths the JAX kernels take off C % 128 and hd % 32 (and
# 16), each at both stages' window shapes at the serving batch: label ->
# (C, heads); `swin_dim` 32 / 64 / 96 (stage 1) and 96's stage 2 (192)
WIDTHS = {"C32 hd8": (32, 4), "C64 hd16": (64, 4), "C96 hd24": (96, 4),
          "C192 hd48": (192, 4)}
WIDTH_WINDOWS = {"TN128": ((4, 2, 64, 80), 8), "TN32": ((4, 2, 32, 40), 4)}
# and K5's two passes at a head dim off 16 (TN 144: ws 6, T 4)
WIDTH_TWO_PASS = ((2, 4, 48, 60, 96), 4, 6)


def phase_widths_kernels(dev, results, median_ms) -> None:
    """Phase 2i: every widened kernel at every (C, hd) of WIDTHS and both
    windows of WIDTH_WINDOWS, in bf16 and fp32: K1 (W-MSA and SW-MSA), K2
    (row 2, row 3 shifted, row 8 with m), K5 (SW-MSA, from K1's scratch),
    K6 (row 7 shifted, row 9 with row 8's m), rows 10 and 11 (masked);
    and K5 bf16's two passes at TN 144 x hd 24. Each within its bound of
    its twin (bf16 TOL_REL, fp32 TOL_F32_REL with TF32 off), bit-equal
    across two calls, a planted fault in the twin missing tenfold (K1
    without its relative bias, K2 without its MLP branch, K5 without dbias
    and without the row-sum term, K6 without the LN2 path and with gelu'
    as 1, rows 10 and 11 without the mask), its wrapper launched exactly
    once a call, the library's GEMM launches exactly those the kernels'
    launches imply; timed beside the twin and the bound. Then
    `wgrad_sm90` alone at ragged M and N (C 96's dwqkv, C 32's dwproj)
    bit-equal and against its twin."""
    import torch
    from stswincl_tpu_torch.ops import add_ln_mlp as epi
    from stswincl_tpu_torch.ops import attention as attn_ops
    from stswincl_tpu_torch.ops import block_attention as att
    from stswincl_tpu_torch.ops import gemm as gemm_ops
    from stswincl_tpu_torch.ops.window import (partition_qkv,
                                               shifted_window_attention_mask)

    gen = torch.Generator(device=dev).manual_seed(24)
    bf16, f32 = torch.bfloat16, torch.float32
    hold = functools.partial(hold_outputs, results, median_ms)
    wrappers = kernel_wrappers()
    reset_launches(wrappers)

    def randn(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def uniform(*shape, fan_in, dtype=bf16, gain=1.0):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1)
                * gain * fan_in ** -0.5).to(dtype)

    def shifted_mask(h, w, ws, T):
        return torch.from_numpy(shifted_window_attention_mask(
            h, w, ws, ws // 2)).repeat(1, T, T).to(dev)

    attn_names = ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias")
    epi_names = ("dx", "dy", "ds2", "db2", "dw1", "db1", "dw2", "dbw2",
                 "ds1", "db1n")
    k6_recomputed_f32 = 0

    def k5_case(label, shape, heads, ws, dtype, peak, tol):
        """K5 (SW-MSA) from K1's window-order scratch, against its twin."""
        bf = dtype == bf16
        B, T, h, w, C = shape
        TN, hd = T * ws * ws, C // heads
        x, g = randn(*shape, dtype=dtype), randn(*shape, dtype=dtype)
        wqkv = uniform(3 * C, C, fan_in=C, gain=3.0, dtype=dtype)
        bqkv = uniform(3 * C, fan_in=C, dtype=f32)
        wproj = uniform(C, C, fan_in=C, gain=2.0, dtype=dtype)
        bproj = uniform(C, fan_in=C, dtype=f32)
        bias = randn(heads, TN, TN, dtype=f32)
        mask = shifted_mask(h, w, ws, T)
        fwd = (x, wqkv, bqkv, wproj, bproj, bias, mask, heads, hd ** -0.5,
               ws, ws // 2)
        _, qkv, attn = (att._forward_kernel if bf else att._forward_f32)(
            *fwd)
        k5 = (att.swin_block_attention_bwd if bf
              else att.swin_block_attention_bwd_f32)
        path = ("" if not bf else " (slot kernel)"
                if att._attn_bwd_slot_takes(TN, hd) else " (two passes)")
        hold(k5.__name__, f"{label} {shape} SW-MSA{path}", attn_names,
             lambda: k5(x, g, qkv, attn, wqkv, wproj, bias, mask, *fwd[7:]),
             lambda: att.swin_block_attention_bwd_ref(*fwd[:7], g,
                                                      *fwd[7:]),
             tol, k5_work(x, heads, TN, mask),
             [("without dbias", lambda: (
                 lambda w_: w_[:5] + (torch.zeros_like(w_[5]),))(
                     att.swin_block_attention_bwd_ref(*fwd[:7], g,
                                                      *fwd[7:]))),
              ("without the row-sum term (dS = P dP)",
               lambda: attention_bwd_without_rowsum(*fwd[:7], g, *fwd[7:]))],
             peak, counter=k5)
        del x, g, qkv, attn

    for dtype in (bf16, f32):
        bf = dtype == bf16
        sfx = "" if bf else "_f32"
        tol = TOL_REL if bf else TOL_F32_REL
        peak = PEAK_BF16 if bf else PEAK_3XTF32
        for wlabel, (C, heads) in WIDTHS.items():
            hd, hidden = C // heads, 4 * C
            for tlabel, (lead, ws) in WIDTH_WINDOWS.items():
                B, T, h, w = lead
                shape, TN = (*lead, C), T * ws * ws
                label = f"{wlabel} {tlabel}"
                mask = shifted_mask(h, w, ws, T)
                x = randn(*shape, dtype=dtype)
                # K1: weights and bias as phase 2 draws them (a peaked
                # softmax, the attention branch about as large as x)
                wqkv = uniform(3 * C, C, fan_in=C, gain=3.0, dtype=dtype)
                bqkv = uniform(3 * C, fan_in=C, dtype=f32)
                wproj = uniform(C, C, fan_in=C, gain=2.0, dtype=dtype)
                bproj = uniform(C, fan_in=C, dtype=f32)
                bias = randn(heads, TN, TN, dtype=f32)
                k1 = getattr(att, "swin_block_attention" + sfx)
                for shift in (0, ws // 2):
                    fwd = (x, wqkv, bqkv, wproj, bproj, bias,
                           mask if shift else None, heads, hd ** -0.5, ws,
                           shift)
                    hold(k1.__name__, f"{label} {shape} shift={shift}",
                         ("out",), lambda: (k1(*fwd),),
                         lambda: (att.swin_block_attention_ref(*fwd),), tol,
                         block_attention_work(x, heads, TN, fwd[6]),
                         [("without its relative bias", lambda: (
                             att.swin_block_attention_ref(
                                 *fwd[:5], torch.zeros_like(bias),
                                 *fwd[6:]),))], peak, counter=k1)
                # K2: rows 2 and 3, and 8 (m)
                y, g = randn(*shape, dtype=dtype), randn(*shape, dtype=dtype)
                p = (1.0 + randn(C, scale=0.1, dtype=f32),
                     randn(C, scale=0.1, dtype=f32),
                     uniform(hidden, C, fan_in=C, gain=2.0, dtype=dtype),
                     uniform(hidden, fan_in=C, dtype=f32),
                     uniform(C, hidden, fan_in=hidden, gain=2.0,
                             dtype=dtype),
                     uniform(C, fan_in=hidden, dtype=f32),
                     1.0 + randn(C, scale=0.1, dtype=f32),
                     randn(C, scale=0.1, dtype=f32))
                no_mlp = (*p[:4], torch.zeros_like(p[4]),
                          torch.zeros_like(p[5]), *p[6:])
                k2 = getattr(epi, "swin_block_epilogue" + sfx)
                for row, shift, with_m in (("row 2", 0, False),
                                           ("row 3", ws // 2, False),
                                           ("row 8", 0, True)):
                    kw = dict(gelu_exact=True, shift=shift, ws=ws)
                    ref = (epi.swin_block_epilogue_with_m_ref if with_m
                           else epi.swin_block_epilogue_ref)

                    def kfn(kw=kw, with_m=with_m):
                        if bf:
                            out, m = epi._forward_kernel(
                                x, y, *p, eps=1e-5, with_m=with_m, **kw)
                        else:
                            out = epi.swin_block_epilogue_f32(
                                x, y, *p, m_out=with_m, **kw)
                            out, m = out if with_m else (out, None)
                        return (out, m) if with_m else (out,)

                    def pfn(ref=ref, kw=kw, w_=p):
                        out = ref(x, y, *w_, **kw)
                        return out if isinstance(out, tuple) else (out,)
                    hold(k2.__name__, f"{label} {shape} {row}",
                         ("out", "m") if with_m else ("out",), kfn, pfn,
                         tol, mlp_work(x.numel() // C, C, hidden,
                                       3 + with_m, x.element_size()),
                         [("without its MLP branch",
                           lambda pfn=pfn: pfn(w_=no_mlp))], peak,
                         counter=k2)
                # K5, SW-MSA
                k5_case(label, shape, heads, ws, dtype, peak, tol)
                # K6: row 7 (m recomputed, shifted), row 9 (row 8's m)
                k6 = getattr(epi, "swin_block_epilogue_bwd" + sfx)
                for row, shift in (("row 7", ws // 2), ("row 9", 0)):
                    kw = dict(gelu_exact=True, shift=shift, ws=ws)
                    m = None
                    if row == "row 9":
                        m = (epi._forward_kernel(x, y, *p, eps=1e-5,
                                                 with_m=True, **kw)[1] if bf
                             else epi.swin_block_epilogue_f32(
                                 x, y, *p, m_out=True, **kw)[1])
                    elif not bf:
                        k6_recomputed_f32 += 7
                    hold(k6.__name__, f"{label} {shape} {row} shift={shift}",
                         epi_names,
                         lambda m=m, kw=kw: k6(x, y, g, m, *p[:7], **kw),
                         lambda kw=kw: epi.swin_block_epilogue_bwd_ref(
                             x, y, *p, g, **kw), tol,
                         k6_work(x, hidden, m is not None, shift),
                         [("without the LN2 path",
                           lambda kw=kw: epilogue_bwd_without_ln2_path(
                               x, y, *p, g, **kw)),
                          ("with gelu' as 1",
                           lambda kw=kw: epilogue_bwd_with_unit_gelu_grad(
                               x, y, *p, g, **kw))], peak, counter=k6)
                    del m
                del y, g, p, no_mlp
                # rows 10 and 11 (SW-MSA)
                qkv = randn(B, T, h, w, 3 * C, dtype=dtype)
                q, k, v = partition_qkv(qkv, heads, ws).contiguous()
                rbias = randn(heads, TN, TN, scale=0.5, dtype=f32)
                sc = hd ** -0.5
                r10 = getattr(att, "windowed_attention_image" + sfx)
                hold(r10.__name__, f"{label} {tuple(qkv.shape)} mask=True",
                     ("out",),
                     lambda: (r10(qkv, rbias, mask, heads, sc, ws),),
                     lambda: (att.windowed_attention_image_ref(
                         qkv, rbias, mask, heads, sc, ws),), tol,
                     attention_work(x.numel() // C, C, TN, heads, mask,
                                    x.element_size()),
                     [("without the mask", lambda: (
                         att.windowed_attention_image_ref(
                             qkv, rbias, None, heads, sc, ws),))], peak,
                     counter=r10)
                r11 = getattr(attn_ops, "fused_window_attention" + sfx)
                hold(r11.__name__, f"{label} {tuple(q.shape)} mask=True",
                     ("out",), lambda: (r11(q, k, v, rbias, mask, sc),),
                     lambda: (attn_ops.attend_tiled(q, k, v, rbias, mask,
                                                    sc),), tol,
                     attention_work(x.numel() // C, C, TN, heads, mask,
                                    x.element_size()),
                     [("without the mask", lambda: (
                         attn_ops.attend_tiled(q, k, v, rbias, None, sc),))],
                     peak, counter=r11)
                # row 11's library yardstick: SDPA in the same dtype, bias
                # + the window's mask its additive mask, the windows
                # regrouped so that it broadcasts over the images; timed
                # only, the port never calls it
                nW = mask.shape[0]
                qs, ks, vs = (t.reshape(-1, nW * heads, TN, hd)
                              for t in (q, k, v))
                am = (mask[:, None] + rbias[None]).reshape(
                    1, nW * heads, TN, TN).to(dtype)
                row = results[r11.__name__][-1]
                row["library_ms"] = median_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qs, ks, vs, attn_mask=am, scale=sc), reps=5)
                print(f"  {'':24s} {label} SDPA in {dtype}: "
                      f"{row['library_ms']:.3f} ms", flush=True)
                del x, qkv, q, k, v, qs, ks, vs, am
                torch.cuda.empty_cache()
        if bf:  # K5's two passes at a head dim off 16
            shape, heads, ws = WIDTH_TWO_PASS
            k5_case("TN144 hd24", shape, heads, ws, dtype, peak, tol)
    counts, forms = read_launches(wrappers)
    print(f"  [widths] kernel launches: "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    check_gemm_launches("widths", counts, forms,
                        f32_recomputed=k6_recomputed_f32)

    # the bf16 weight-gradient GEMM alone at ragged M and N: C 96's dwqkv
    # (x through the shifted window map) and C 32's dwproj (g through the
    # window map)
    for case, (R, M, N), am, bm in (
            ("dwqkv C96", (40960, 288, 96), None, (2, 64, 80, 8, 4)),
            ("dwproj C32", (40960, 32, 32), (2, 64, 80, 8, 0), None)):
        A, Bm = randn(R, M), randn(R, N)
        a = gemm_ops.wgrad_sm90(A, Bm, am, bm)
        b = gemm_ops.wgrad_sm90(A, Bm, am, bm)
        torch.cuda.synchronize()
        bit = torch.equal(a, b)
        rel = rel_err(a, gemm_ops.wgrad_sm90_ref(A, Bm, am, bm))
        print(f"  wgrad_sm90 {case} ({R} rows, {tuple(a.shape)}): bit-equal "
              f"{bit}, rel {rel:.2e} against its twin", flush=True)
        check(bit, f"wgrad_sm90 {case}: two calls differ")
        check(rel <= TOL_F32_REL * 10, f"wgrad_sm90 {case}: rel {rel}")
    torch.cuda.empty_cache()


# Phase 2j: the models of the widths, through `build_model` on
# 'pallas_full': label -> (ModelConfig fields, dtype)
WIDTH_MODELS = {
    "swin_dim=96": (dict(swin_dim=96), "bfloat16"),        # C 96 / 192
    "swin_dim=96 fp32": (dict(swin_dim=96), "float32"),
    "swin_dim=64": (dict(swin_dim=64), "bfloat16"),        # C 64 / 128
    "swin_dim=64 fp32": (dict(swin_dim=64), "float32"),
}
WIDTH_SERVE_STEPS = 8
# ... and with row 16 on their W-MSA blocks (`TswinPlus(whole_block=True)`):
# C 96 / 192, hd 24 / 48
WHOLE_WIDTH_MODELS = {
    "swin_dim=96 whole_block": (dict(swin_dim=96, whole_block=True),
                                "bfloat16"),
    "swin_dim=96 whole_block fp32": (dict(swin_dim=96, whole_block=True),
                                     "float32"),
}


def phase_widths_models(dev, smi, wrappers, launches) -> None:
    """Phase 2j: each of WIDTH_MODELS (`ModelConfig(swin_dim=96)` and
    `(swin_dim=64)`, 4 heads: hd 24 / 48 and 16 / 32) and
    WHOLE_WIDTH_MODELS (`swin_dim` 96 with `whole_block=True`, row 16 on
    its W-MSA blocks) served by `serve_models` (bs 2, its predictions the
    plain route's on >= TOL_PLAIN_SHARE of pixels each frame). Then
    `phase_config_train` on the same configurations: ENVELOPE_STEPS
    stage-1 steps at batch 8, finite losses, exact launches, ms/step, peak
    memory, the first step's gradients gated as phase 2h gates them."""
    serve_models(dev, smi, wrappers, launches,
                 {**WIDTH_MODELS, **WHOLE_WIDTH_MODELS}, TOL_PLAIN_SHARE)
    phase_config_train(dev, smi, wrappers, launches,
                       {**WIDTH_MODELS, **WHOLE_WIDTH_MODELS})


def serve_models(dev, smi, wrappers, launches, models, share,
                 steps=WIDTH_SERVE_STEPS, whole_too=False) -> dict:
    """Each of `models` (label -> (ModelConfig fields, dtype)) built by
    `pipelines.build_model` on 'pallas_full' from seeded weights
    (BatchNorm calibrated on the first clip) serves through
    `StreamingSegmenter` at 512x640 -> 1024x1280, bs 2: `init_and_predict`,
    then `steps` `predict_next`s, each launching K1, K2, K3 and
    K4 as often as the default model's route does (SERVE_STEP) and nothing
    of the other dtype; its predictions the plain route's (`kernels=False`,
    same weights) on >= `share` of pixels each frame; ms a `predict_next`
    (median after the first). An entry with "whole_block" in its fields
    (`route_fields`) serves with row 16 on its W-MSA blocks, both routes:
    K1 and K2 then launch half as often and row 16 as often as they. With
    `whole_too`, each model then serves again with row 16 on its W-MSA
    blocks ("<label> whole_block"), held the same way against the same
    plain predictions (whose twins differ from row 16's only in m's
    rounding). Returns, by label, the launches of the attention core's
    streamed instance in the model's dtype a `predict_next` (with
    "whole_block", row 16's launches that ran the streamed pair)."""
    import torch
    from stswincl_tpu_torch.configs import (DataConfig, ModelConfig,
                                            SegTrainConfig)
    from stswincl_tpu_torch.models import TswinPlus
    from stswincl_tpu_torch.models.init import init_weights
    from stswincl_tpu_torch.pipelines.common import build_model
    from stswincl_tpu_torch.pipelines.streaming import StreamingSegmenter

    gen = torch.Generator(device=dev).manual_seed(6)
    frames = torch.rand((BS, 4 + steps, H, W, 3), generator=gen,
                        device=dev) * 2 - 1
    streamed = {}
    for label, (fields, dtype) in models.items():
        f32 = dtype == "float32"
        sfx = "_f32" if f32 else ""
        fields, whole = route_fields(fields)
        cfg = SegTrainConfig(model=ModelConfig(**fields, dtype=dtype),
                             data=DataConfig(batch_size=BS, crop_hw=(H, W)))
        model, classes = build_model(cfg.model, cfg.data, device=dev)
        init_weights(model, torch.Generator().manual_seed(0))
        set_whole_block(model, whole).to(dev).eval()
        calibrate_batchnorm(model, frames[:, 0:4])
        plain = TswinPlus(classes, swin_dim=cfg.model.swin_dim,
                          num_heads=cfg.model.num_heads,
                          swin_depths=tuple(cfg.model.swin_depths),
                          dtype=getattr(torch, dtype), input_hw=(H, W),
                          kernels=False, whole_block=whole)
        plain.load_state_dict(model.state_dict())
        plain.to(dev).eval()

        def drive(m, path, wb):
            seg = StreamingSegmenter(m, out_hw=OUT_HW)
            reset_launches(wrappers)
            cache, pred = seg.init_and_predict(frames[:, 0:4])
            before, forms0 = read_launches(wrappers)
            preds, secs = [pred], []
            for i in range(4, 4 + steps):
                ts = time.perf_counter()
                cache, pred = seg.predict_next(cache, frames[:, i])
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - ts)
                preds.append(pred)
            launches[path], forms = read_launches(wrappers)
            per = {k: (n - before[k]) / steps
                   for k, n in launches[path].items()}
            key = "attn_f32_streamed" if f32 else "attn_streamed"
            if wb:
                key = "whole_f32_streamed" if f32 else "whole_streamed"
            per_s = (forms[key] - forms0[key]) / steps
            return preds, per, 1e3 * statistics.median(secs[1:]), per_s

        def hold(name, preds, per, ms, per_s, wb):
            tag = f"[serve {name}]"
            shares = [(a == b).float().mean().item()
                      for a, b in zip(preds, plain_preds)]
            print(f"  {tag} C {cfg.model.swin_dim} / "
                  f"{2 * cfg.model.swin_dim}, hd "
                  f"{cfg.model.swin_dim // cfg.model.num_heads} / "
                  f"{2 * cfg.model.swin_dim // cfg.model.num_heads}: "
                  f"{ms:.2f} ms a predict_next (plain route {plain_ms:.2f}; "
                  f"median of {steps - 1}) at bs {BS}; kernel "
                  f"route == plain route on min {min(shares):.6f} of pixels "
                  f"over {len(shares)} frames; launches a predict_next "
                  f"{ {k: v for k, v in per.items() if v} }, of them "
                  f"{per_s} on the {'row-16' if wb else 'core'}'s streamed "
                  f"instance, on {smi}", flush=True)
            check(min(shares) >= share, f"{tag}: kernel vs plain "
                  f"route {min(shares)} < {share}")
            for p_ in preds:
                check(p_.shape == (BS, *OUT_HW) and p_.dtype == torch.int32
                      and 0 <= int(p_.min()) and int(p_.max()) < classes,
                      f"{tag}: prediction {p_.shape} {p_.dtype}")
            rows = {"attention": "swin_block_attention" + sfx,
                    "epilogue": "swin_block_epilogue" + sfx,
                    "patch_merge": "patch_merge" + sfx,
                    "upsample_argmax": "upsample_argmax"}
            want_step = dict(SERVE_STEP)
            if wb:  # row 16 takes the W-MSA block of each of the pairs
                rows["whole"] = "whole_swin_block" + sfx
                pairs = SERVE_STEP["attention"] // 2
                want_step.update(attention=pairs, epilogue=pairs,
                                 whole=pairs)
            for key, want in want_step.items():
                check(per[rows[key]] == want, f"{tag}: {rows[key]} launched "
                      f"{per[rows[key]]} times a predict_next, expected "
                      f"{want}")
            for k, n in per.items():
                check(n == 0 or k in rows.values() or k in GEMM_ROWS,
                      f"{tag}: {k} launched {n} times a predict_next")
            streamed[name] = per_s

        preds, per, ms, per_s = drive(model, f"serve {label}", whole)
        plain_preds, plain_per, plain_ms, _ = drive(
            plain, f"serve {label} plain", whole)
        check(sum(plain_per.values()) == 0, f"[serve {label}]: the plain "
              f"route launched {plain_per}")
        hold(label, preds, per, ms, per_s, whole)
        if whole_too and not whole:
            name = f"{label} whole_block"
            set_whole_block(model, True)
            hold(name, *drive(model, f"serve {name}", True), True)
        del model, plain, preds, plain_preds
        torch.cuda.empty_cache()
    return streamed


# Phase 2k: the fp32 attention forms past the resident pair, at the
# windows K1's bf16 form takes and the fp32 resident instances do not
# (label: x's shape (B, T, H, W, C), heads, ws): head dims 152-288 at TN
# 128 (`swin_dim` 608 / 768 / 1152 over 4 heads, 512 over 2:
# `ModelConfig(num_heads=2)`'s stage 1 at its serving batch), TN 144 (ws 6,
# T 4; the backward streams past 128 tokens), TN 176 at hd 208 (K1's
# widest window at its widest head dim), and TN 32 at hd 384-1200 (the
# stage-2 windows of those models; the forward keeps its resident pair to
# hd 600, the backward streams past 256)
F32_STREAMED = {
    "TN128 hd152": ((4, 2, 64, 80, 608), 4, 8),
    "TN128 hd192": ((4, 2, 64, 80, 768), 4, 8),
    "TN128 hd256": ((4, 2, 64, 80, 512), 2, 8),
    "TN128 hd288": ((2, 2, 64, 80, 1152), 4, 8),
    "TN144 hd64": ((4, 4, 48, 60, 256), 4, 6),
    "TN176 hd208": ((1, 11, 32, 40, 1664), 8, 4),
    "TN32 hd384": ((4, 2, 32, 40, 1536), 4, 4),
    "TN32 hd512": ((4, 2, 32, 40, 1024), 2, 4),
    "TN32 hd576": ((2, 2, 32, 40, 2304), 4, 4),
    "TN32 hd1200": ((2, 2, 32, 40, 2400), 2, 4),
}
# (b) the models whose fp32 windows need the streamed instances: served at
# bs 2 (`num_heads=2` also trains in phase 2h (c), ENVELOPE_MODELS), and
# `swin_dim=768` stepped once at the largest of these batches that fits
F32_STREAMED_MODELS = {
    "num_heads=2 fp32": (dict(num_heads=2), "float32"),    # hd 256 / 512
    "swin_dim=768 fp32": (dict(swin_dim=768), "float32"),  # hd 192 / 384
}
F32_STREAMED_STEP_BATCHES = (8, 4, 2)
STREAMED_LAUNCHES = {}  # path -> the streamed instances' launches


def phase_f32_streamed(dev, smi, wrappers, launches, results,
                       median_ms) -> None:
    """Phase 2k: (a) at every F32_STREAMED window, K1's fp32 form (W-MSA
    and SW-MSA), rows 10's and 11's fp32 forms (masked), K5 fp32's
    attention backward alone (`attn_bwd_f32`, masked) and K5's fp32 form
    (shifted) against their fp32 twins with TF32 off, every output within
    TOL_F32_REL, bit-equal call to call, one launch of the form a call,
    the twin with its products on TF32 missing the bound tenfold on every
    output (K5's dbproj, g's column sums, reached by no product, excepted;
    its twin runs under `tf32_products`, the others on TF32 operands), and
    the library's streamed instances launched exactly where the plans
    (`_attn_f32_smem_bytes`, `_attn_f32_bwd_resident`) put the window past
    the resident ones. Each timed (CUDA events) beside its twin, its bound
    (3xTF32 rate or bytes) and SDPA in fp32 (its forward for the forward
    forms, its memory-efficient backward with the bias gradient for the
    backward ones: yardsticks the port never calls). (b) The models of
    F32_STREAMED_MODELS served by `serve_models` at >= TOL_F32_SHARE of the
    plain route's pixels, and `swin_dim=768` fp32 stepped once through
    `SegTrainStep` at the largest batch of F32_STREAMED_STEP_BATCHES that
    fits (`step_largest`). Phase 2l holds the refusals."""
    import torch
    import torch.nn.functional as F
    from stswincl_tpu_torch.ops import block_attention as att
    from stswincl_tpu_torch.ops.attention import (
        _attn_f32_resident_bytes, _attn_f32_smem_bytes, attend_tiled,
        fused_window_attention_f32)
    from stswincl_tpu_torch.ops.gemm import window_rows
    from stswincl_tpu_torch.ops.window import (partition_qkv,
                                               shifted_window_attention_mask)

    t_start = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(25)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def uniform(*shape, fan_in, gain=1.0):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1)
                * gain * fan_in ** -0.5)

    def hold(kname, case, form, names, kfn, pfn, bad, work, library=None,
             exempt=()):
        """kfn() (a launch of `form` a call, twice: bit-equal) against
        pfn() on every output within TOL_F32_REL; bad() (the twin on
        TF32) tenfold out on every output but `exempt`; timed beside the
        twin, the bound of `work` and `library`."""
        n = form.launches
        got = kfn()
        again = kfn()
        torch.cuda.synchronize()
        check(form.launches == n + 2, f"{kname} {case}: "
              f"{form.launches - n} launches of the form in two calls")
        bit = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        want = pfn()
        fault = bad()
        outs = {}
        for name, a, w, b in zip(names, got, want, fault):
            rel, moved = rel_err(a, w), rel_err(b, w)
            outs[name] = {"rel_err": rel, "tf32_fault": moved,
                          "max_abs_err": (a - w).abs().max().item()}
            check(rel <= TOL_F32_REL, f"{kname} {case} {name}: relative "
                  f"error {rel} > {TOL_F32_REL}")
            if name not in exempt:
                check(moved > 10 * TOL_F32_REL, f"{kname} {case} {name}: "
                      f"the twin on TF32 moves by only {moved}")
        check(bit, f"{kname} {case}: two calls on the same inputs differ")
        del got, want, fault
        torch.cuda.empty_cache()
        row = {"case": case, "outputs": outs, "bit_equal": bit,
               "max_abs_err": max(o["max_abs_err"] for o in outs.values()),
               "rel_err": max(o["rel_err"] for o in outs.values()),
               "ms": median_ms(kfn, reps=5),
               "plain_ms": median_ms(pfn, reps=3),
               "library_ms": None, **f32_bound(*work)}
        lib = ""
        if callable(library):
            row["library_ms"] = median_ms(library, reps=5)
            lib = f" SDPA {row['library_ms']:.3f} ms"
        elif library:
            lib = f" SDPA {library}"
        results.setdefault(kname, []).append(row)
        print(f"  {kname:30s} {case:44s} worst rel "
              f"{row['rel_err']:.2e}, TF32 fault min "
              f"{min(o['tf32_fault'] for n, o in outs.items() if n not in exempt) / TOL_F32_REL:.0f}x,"
              f" bit-equal {bit}; {row['ms']:.3f} ms, twin "
              f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
              f"({row['bound_by']}; {row['bound_ms'] / row['ms']:.2f} of "
              f"it){lib}", flush=True)
        return row

    for label, (shape, heads, ws) in F32_STREAMED.items():
        B, T, h, w, C = shape
        TN, hd = T * ws * ws, C // heads
        R, shift, scale = B * T * h * w, ws // 2, (C // heads) ** -0.5
        fwd_streamed = _attn_f32_smem_bytes(TN, hd) != \
            _attn_f32_resident_bytes(TN, hd)
        bwd_streamed = not att._attn_f32_bwd_resident(TN, hd)
        print(f"  [2k {label}] x {shape}, {heads} heads: forward "
              f"{'streamed' if fwd_streamed else 'resident'} "
              f"({_attn_f32_smem_bytes(TN, hd)} B), backward "
              f"{'streamed' if bwd_streamed else 'resident'} "
              f"({att._attn_f32_bwd_smem_bytes(TN, hd)} B) on {smi}",
              flush=True)
        x, g = randn(B, T, h, w, C), randn(B, T, h, w, C)
        wq, bq = uniform(3 * C, C, fan_in=C, gain=3.0), uniform(3 * C,
                                                               fan_in=C)
        wp, bp = uniform(C, C, fan_in=C, gain=2.0), uniform(C, fan_in=C)
        bias = randn(heads, TN, TN)
        mask = torch.from_numpy(shifted_window_attention_mask(
            h, w, ws, shift)).repeat(1, T, T).to(dev)
        tables = (heads * TN * TN + mask.numel()) * 4
        reset_launches(wrappers)

        # ---- K1's fp32 form, W-MSA and SW-MSA ----
        for sh in (0, shift):
            m = mask if sh else None
            a1 = (x, wq, bq, wp, bp, bias, m, heads, scale, ws, sh)
            hold("swin_block_attention_f32",
                 f"2k {label} {shape} shift={sh}",
                 att.swin_block_attention_f32, ("out",),
                 lambda a=a1: (att.swin_block_attention_f32(*a),),
                 lambda a=a1: (att.swin_block_attention_ref(*a),),
                 lambda a=a1: (block_attention_tf32(*a),),
                 block_attention_work(x, heads, TN, m))
        # ---- rows 10 and 11, masked; SDPA's fp32 forward beside them ----
        qkv_img = randn(B, T, h, w, 3 * C, scale=2.0)
        q, k, v = partition_qkv(qkv_img, heads, ws).contiguous()
        nW = mask.shape[0]
        qs, ks, vs = (t.reshape(-1, nW * heads, TN, hd) for t in (q, k, v))
        am = (mask[:, None] + bias[None]).reshape(1, nW * heads, TN, TN)

        def sdpa():
            return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=am,
                                                  scale=scale)
        awork = attention_work(R, C, TN, heads, mask, 4)
        a10 = (bias, mask, heads, scale, ws)
        hold("windowed_attention_image_f32", f"2k {label} masked",
             att.windowed_attention_image_f32, ("out",),
             lambda: (att.windowed_attention_image_f32(qkv_img, *a10),),
             lambda: (att.windowed_attention_image_ref(qkv_img, *a10),),
             lambda: (image_attention_fault(qkv_img, *a10, operands=tf32),),
             awork)
        a11 = (bias, mask, scale)
        hold("fused_window_attention_f32", f"2k {label} masked",
             fused_window_attention_f32, ("out",),
             lambda: (fused_window_attention_f32(q, k, v, *a11),),
             lambda: (attend_tiled(q, k, v, *a11),),
             lambda: (attend_fault(q, k, v, *a11, operands=tf32),),
             awork, sdpa)
        del qkv_img, q, k, v, qs, ks, vs, am
        torch.cuda.empty_cache()

        # ---- K5 fp32's attention backward alone, then K5's fp32 form ----
        with torch.no_grad():
            _, qkv, attn = att._forward_f32(x, wq, bq, wp, bp, bias, mask,
                                            heads, scale, ws, shift)
            dattn = g.reshape(R, C)[window_rows(R, (T, h, w, ws, 0),
                                                dev)] @ wp
        args = (qkv, dattn, bias, mask, heads, scale, TN)
        lib = sdpa_bwd_yardstick(*args)

        def split(r):
            return (r[0][:, :C], r[0][:, C:2 * C], r[0][:, 2 * C:], r[1])
        hold("attn_bwd_f32", f"2k {label} masked", att.attn_bwd_f32,
             ("dq", "dk", "dv", "dbias"),
             lambda: split(att.attn_bwd_f32(*args)),
             lambda: split(att.attn_bwd_f32_ref(*args)),
             lambda: split(attn_bwd_tf32(*args)),
             (10 * R * TN * C, (7 * R * C + 2 * heads * TN * TN
                                + mask.numel()) * 4), lib)
        del lib
        kargs = (x, g, qkv, attn, wq, wp, bias, mask, heads, scale, ws,
                 shift)

        def k5_twin(a=(x, wq, bq, wp, bp, bias, mask, g)):
            return att.swin_block_attention_bwd_ref(*a[:7], a[7], heads,
                                                    scale, ws, shift)

        def k5_twin_tf32():
            with tf32_products():
                return k5_twin()
        hold("swin_block_attention_bwd_f32", f"2k {label} {shape} "
             f"shift={shift}", att.swin_block_attention_bwd_f32,
             ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias"),
             lambda: att.swin_block_attention_bwd_f32(*kargs), k5_twin,
             k5_twin_tf32,
             (16 * R * C * C + 10 * R * TN * C,
              (7 * R * C + 4 * C * C + 4 * C + 2 * heads * TN * TN
               + mask.numel()) * 4), exempt=("dbproj",))
        forms = read_launches(wrappers)[1]
        fwd_n, bwd_n = (forms["attn_f32_streamed"],
                        forms["attn_bwd_f32_streamed"])
        # K1 twice in each of two shifts and five timed runs after two
        # warm-ups: 2 x (2 + 7); rows 10 and 11: 9 each; the backward
        # alone and inside K5: 9 each
        want_f = 36 if fwd_streamed else 0
        want_b = 18 if bwd_streamed else 0
        # K5's forward scratch above runs K1 once more
        want_f += 1 if fwd_streamed else 0
        print(f"  [2k {label}] streamed launches: forward {fwd_n} "
              f"(expected {want_f}), backward {bwd_n} (expected "
              f"{want_b}); P and dS {2 * R * heads * TN * 4 / 2 ** 20:.1f} "
              f"MiB", flush=True)
        check(fwd_n == want_f and bwd_n == want_b,
              f"2k {label}: streamed launches {fwd_n} / {bwd_n}, expected "
              f"{want_f} / {want_b}")
        del x, g, qkv, attn, dattn, args, kargs
        torch.cuda.empty_cache()

    print(f"phase 2k (a) the fp32 forms past the resident pair: "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- (b) the models ----
    t_b = time.perf_counter()
    per = serve_models(dev, smi, wrappers, launches, F32_STREAMED_MODELS,
                       TOL_F32_SHARE, STREAMED_SERVE_STEPS)
    for label, n in per.items():
        STREAMED_LAUNCHES[f"serve {label}: forward a predict_next"] = n
        check(n > 0, f"[serve {label}]: the streamed forward never ran")
    label = "swin_dim=768 fp32"
    step_largest(dev, smi, wrappers, launches, label,
                 *F32_STREAMED_MODELS[label], F32_STREAMED_STEP_BATCHES)
    print(f"phase 2k (b) the models: {time.perf_counter() - t_b:.1f} s",
          flush=True)


# Phase 2l: the attention kernels past the bf16 core's resident pair, in
# both dtypes (label: x's shape (B, T, H, W, C), heads, ws): head dims
# 296-640 at TN 128 (hd 320: `swin_dim=1280`'s stage 1 at its serving
# batch; hd 512: `num_heads=1`'s), TN 144 (ws 6, T 4) and TN 176 (ws 4, T
# 11) past it, and TN 32 at hd 1208-2048 (the bf16 resident pair's last
# fit at TN 32 is hd 1200). Every one is past K5 bf16's slot kernel.
ATTN_STREAMED = {
    "TN128 hd296": ((2, 2, 64, 80, 592), 2, 8),
    "TN128 hd320": ((4, 2, 64, 80, 1280), 4, 8),
    "TN128 hd440": ((2, 2, 64, 80, 880), 2, 8),
    "TN128 hd512": ((2, 2, 64, 80, 512), 1, 8),
    "TN128 hd640": ((2, 2, 64, 80, 640), 1, 8),
    "TN144 hd320": ((1, 4, 48, 60, 640), 2, 6),
    "TN176 hd216": ((1, 11, 32, 40, 864), 4, 4),
    "TN176 hd320": ((1, 11, 32, 40, 640), 2, 4),
    "TN32 hd1208": ((2, 2, 32, 40, 2416), 2, 4),
    "TN32 hd1280": ((2, 2, 32, 40, 2560), 2, 4),
    "TN32 hd2048": ((2, 2, 32, 40, 2048), 1, 4),
}
# (b) the models whose windows need the streamed instances in both dtypes:
# served at bs 2, `num_heads=1` trained (ENVELOPE_STEPS steps at batch 8),
# `swin_dim=1280` stepped once at the largest batch of
# ATTN_STREAMED_STEP_BATCHES that fits
ATTN_STREAMED_MODELS = {
    "num_heads=1": (dict(num_heads=1), "bfloat16"),        # hd 512 / 1024
    "num_heads=1 fp32": (dict(num_heads=1), "float32"),
    "swin_dim=1280": (dict(swin_dim=1280), "bfloat16"),    # hd 320 / 640
    "swin_dim=1280 fp32": (dict(swin_dim=1280), "float32"),
}
ATTN_STREAMED_STEP_BATCHES = (8, 4, 2)
# predict_nexts a model of F32_STREAMED_MODELS and ATTN_STREAMED_MODELS
# serves (`swin_dim` 768 and 1280 in fp32 take 1-3 s one on the kernel and
# on the plain route)
STREAMED_SERVE_STEPS = 3


def drop_last_chunk(t, heads: int, chunk: int):
    """t (..., heads * hd) with each head's last `chunk`-column chunk of
    the head dim (its columns from (ceil(hd / chunk) - 1) chunk on)
    zeroed: a planted fault for the streamed cores, a QK^T that lost its
    last chunk of k steps."""
    hd = t.shape[-1] // heads
    c0 = (hd - 1) // chunk * chunk
    t = t.clone()
    t.view(*t.shape[:-1], heads, hd)[..., c0:] = 0
    return t


def phase_attn_streamed(dev, smi, wrappers, launches, results,
                        median_ms) -> None:
    """Phase 2l: (a) at every ATTN_STREAMED window, in bf16 and fp32: K1
    (W-MSA and SW-MSA), rows 10 and 11 (masked), the attention backward
    alone (`attn_bwd` / `attn_bwd_f32`, masked) and K5 (SW-MSA) against
    their twins (bf16 within TOL_REL, fp32 within TOL_F32_REL with TF32
    off), bit-equal call to call, one launch of the form a call, planted
    faults missing the bound tenfold on the largest output's error: the
    twin with the last column chunk of QK^T dropped (q's columns of each
    head's last 64-column chunk zeroed in bf16, 32 in fp32: the streamed
    cores' chunks) on every form but K5, K1 without its relative bias,
    rows 10-11 without the mask, the backward without dbias or without
    the row-sum term (bf16), every product on TF32 operands (fp32); the
    library's streamed launches (`attn_streamed_launches`,
    `attn_f32_streamed_launches`, `attn_bwd_passes_launches`,
    `attn_bwd_f32_streamed_launches`) exactly where the plans put the
    window; timed beside the twin, the bound and SDPA (its forward beside
    row 11, its memory-efficient backward with the bias gradient beside
    the backward alone; yardsticks the port never calls). Windows outside
    the envelope (TN 192, a head dim off 8) are refused with ValueError
    before any launch in both dtypes. (b) The models of
    ATTN_STREAMED_MODELS served by `serve_models` (bf16 at
    TOL_PLAIN_SHARE, fp32 at TOL_F32_SHARE of the plain route's pixels),
    on 'pallas_full' and then with `whole_block=True` (row 16's streamed
    pair, phase 2m's serving of them), `num_heads=1` trained by
    `phase_config_train` in both dtypes, and
    `swin_dim=1280` stepped once in both dtypes at the largest batch that
    fits (`step_largest`)."""
    phase_attn_streamed_kernels(dev, smi, wrappers, results, median_ms)
    t_b = t = time.perf_counter()
    for dt, share in (("bfloat16", TOL_PLAIN_SHARE),
                      ("float32", TOL_F32_SHARE)):
        models = {k: v for k, v in ATTN_STREAMED_MODELS.items()
                  if v[1] == dt}
        # and with `whole_block=True` (phase 2m's serving of these
        # models: row 16's streamed pair at stage 1 in both dtypes)
        per = serve_models(dev, smi, wrappers, launches, models, share,
                           STREAMED_SERVE_STEPS, whole_too=True)
        for label, n in per.items():
            STREAMED_LAUNCHES[f"serve {label}: forward a predict_next"] = n
            check(n > 0, f"[serve {label}]: the streamed forward never ran")
    print(f"  [2l (b)] served, also with whole_block: "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    phase_config_train(dev, smi, wrappers, launches,
                       {k: v for k, v in ATTN_STREAMED_MODELS.items()
                        if k.startswith("num_heads=1")})
    print(f"  [2l (b)] num_heads=1 trained: {time.perf_counter() - t:.1f} s",
          flush=True)
    t = time.perf_counter()
    for label in ("swin_dim=1280", "swin_dim=1280 fp32"):
        step_largest(dev, smi, wrappers, launches, label,
                     *ATTN_STREAMED_MODELS[label], ATTN_STREAMED_STEP_BATCHES)
    print(f"  [2l (b)] swin_dim=1280 stepped: {time.perf_counter() - t:.1f} s",
          flush=True)
    print(f"phase 2l (b) the models: {time.perf_counter() - t_b:.1f} s",
          flush=True)


def phase_attn_streamed_kernels(dev, smi, wrappers, results,
                                median_ms) -> None:
    """Phase 2l (a) (`phase_attn_streamed`)."""
    import torch
    import torch.nn.functional as F
    from stswincl_tpu_torch.ops import attention as attn_ops
    from stswincl_tpu_torch.ops import block_attention as att
    from stswincl_tpu_torch.ops.gemm import window_rows
    from stswincl_tpu_torch.ops.window import (partition_qkv,
                                               shifted_window_attention_mask)

    t_start = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(26)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, scale=1.0, dtype=f32):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def uniform(*shape, fan_in, gain=1.0, dtype=f32):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1)
                * gain * fan_in ** -0.5).to(dtype)

    def hold(kname, case, form, names, kfn, pfn, faults, tol, work, peak,
             library=None):
        """kfn() (a launch of `form` a call, twice: bit-equal) against
        pfn() on every output within `tol`; each (name, fault) of `faults`
        tenfold out on its largest output error; timed beside the twin,
        the bound of `work` at `peak` and `library`."""
        n = form.launches
        got = kfn()
        again = kfn()
        torch.cuda.synchronize()
        check(form.launches == n + 2, f"{kname} {case}: "
              f"{form.launches - n} launches of the form in two calls")
        bit = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        want = pfn()
        rels = {nm: rel_err(a, w) for nm, a, w in zip(names, got, want)}
        max_abs = max((a.float() - w.float()).abs().max().item()
                      for a, w in zip(got, want))
        for nm, r in rels.items():
            check(r <= tol, f"{kname} {case} {nm}: relative error {r} > "
                  f"{tol}")
        check(bit, f"{kname} {case}: two calls on the same inputs differ")
        moved = {}
        for fname, bad in faults:
            moved[fname] = max_rel_err(bad(), want)
            check(moved[fname] > 10 * tol, f"{kname} {case}: the twin "
                  f"{fname} moves the output by only {moved[fname]}")
        del got, want
        torch.cuda.empty_cache()
        row = {"case": case, "rel_errs": rels, "faults": moved,
               "bit_equal": bit, "max_abs_err": max_abs,
               "rel_err": max(rels.values()),
               "ms": median_ms(kfn, reps=5),
               "plain_ms": median_ms(pfn, reps=3), "library_ms": None,
               **bound(*work, peak=peak)}
        lib = ""
        if callable(library):
            row["library_ms"] = median_ms(library, reps=5)
            lib = f" SDPA {row['library_ms']:.3f} ms"
        elif library:
            lib = f" SDPA {library}"
        results.setdefault(kname, []).append(row)
        print(f"  {kname:30s} {case:24s} worst rel {row['rel_err']:.2e} "
              f"(bound {tol:.0e}), faults "
              + ", ".join(f"{k} {v / tol:.0f}x" for k, v in moved.items())
              + f"; bit-equal {bit}; {row['ms']:.3f} ms, twin "
              f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
              f"({row['bound_by']}; {row['bound_ms'] / row['ms']:.2f} of "
              f"it){lib}", flush=True)
        return row

    dropped = "with its QK^T's last chunk dropped"
    for label, (shape, heads, ws) in ATTN_STREAMED.items():
        B, T, h, w, C = shape
        TN, hd = T * ws * ws, C // heads
        R, shift, scale = B * T * h * w, ws // 2, hd ** -0.5
        mask = torch.from_numpy(shifted_window_attention_mask(
            h, w, ws, shift)).repeat(1, T, T).to(dev)
        nW = mask.shape[0]
        for dtype in (bf16, f32):
            bf = dtype == bf16
            name = "bf16" if bf else "fp32"
            sfx, tol = ("", TOL_REL) if bf else ("_f32", TOL_F32_REL)
            peak = PEAK_BF16 if bf else PEAK_3XTF32
            chunk = 64 if bf else 32
            if bf:
                fwd_streamed = (attn_ops._attn_plan_bytes(TN, hd)
                                != attn_ops._attn_smem_bytes(TN, hd))
                bwd_streamed = not att._attn_bwd_slot_takes(TN, hd)
            else:
                fwd_streamed = (attn_ops._attn_f32_smem_bytes(TN, hd)
                                != attn_ops._attn_f32_resident_bytes(TN, hd))
                bwd_streamed = not att._attn_f32_bwd_resident(TN, hd)
            print(f"  [2l {label} {name}] x {shape}, {heads} heads: forward "
                  f"{'streamed' if fwd_streamed else 'resident'}, backward "
                  f"{'streamed' if bwd_streamed else 'resident'} on {smi}",
                  flush=True)
            x, g = randn(*shape, dtype=dtype), randn(*shape, dtype=dtype)
            # a peaked softmax (as phase 2), the attention branch about as
            # large as x
            wq = uniform(3 * C, C, fan_in=C, gain=3.0, dtype=dtype)
            bq = uniform(3 * C, fan_in=C)
            wp = uniform(C, C, fan_in=C, gain=2.0, dtype=dtype)
            bp = uniform(C, fan_in=C)
            bias = randn(heads, TN, TN)
            reset_launches(wrappers)

            # ---- K1, W-MSA and SW-MSA; the dropped chunk: the rows of
            # wqkv and bqkv that form it zeroed ----
            k1 = getattr(att, "swin_block_attention" + sfx)
            wq_d = wq.clone()
            wq_d[:C] = drop_last_chunk(wq[:C].t(), heads, chunk).t()
            bq_d = bq.clone()
            bq_d[:C] = drop_last_chunk(bq[:C], heads, chunk)
            for sh in (0, shift):
                a1 = (x, wq, bq, wp, bp, bias, mask if sh else None, heads,
                      scale, ws, sh)
                faults = [(dropped, lambda a=a1: (
                    att.swin_block_attention_ref(a[0], wq_d, bq_d,
                                                 *a[3:]),))]
                faults.append(
                    ("without its relative bias", lambda a=a1: (
                        att.swin_block_attention_ref(
                            *a[:5], torch.zeros_like(bias), *a[6:]),))
                    if bf else
                    ("on TF32 operands",
                     lambda a=a1: (block_attention_tf32(*a),)))
                hold(k1.__name__, f"2l {label} shift={sh}", k1, ("out",),
                     lambda a=a1: (k1(*a),),
                     lambda a=a1: (att.swin_block_attention_ref(*a),),
                     faults, tol, block_attention_work(x, heads, TN, a1[6]),
                     peak)
            del wq_d, bq_d

            # ---- rows 10 and 11, masked; SDPA's forward beside row 11 ----
            qkv_img = randn(B, T, h, w, 3 * C, scale=2.0, dtype=dtype)
            q, k, v = partition_qkv(qkv_img, heads, ws).contiguous()
            qkv_d = qkv_img.clone()
            qkv_d[..., :C] = drop_last_chunk(qkv_img[..., :C], heads, chunk)
            q_d = drop_last_chunk(q.transpose(1, 2).reshape(-1, TN, C),
                                  heads, chunk)
            q_d = q_d.reshape(-1, TN, heads, hd).transpose(1, 2) \
                .contiguous()
            qs, ks, vs = (t.reshape(-1, nW * heads, TN, hd)
                          for t in (q, k, v))
            am = (mask[:, None] + bias[None]).reshape(
                1, nW * heads, TN, TN).to(dtype)

            def sdpa():
                return F.scaled_dot_product_attention(qs, ks, vs,
                                                      attn_mask=am,
                                                      scale=scale)
            awork = attention_work(R, C, TN, heads, mask, x.element_size())
            r10 = getattr(att, "windowed_attention_image" + sfx)
            a10 = (bias, mask, heads, scale, ws)
            hold(r10.__name__, f"2l {label} masked", r10, ("out",),
                 lambda: (r10(qkv_img, *a10),),
                 lambda: (att.windowed_attention_image_ref(qkv_img, *a10),),
                 [(dropped, lambda: (
                     att.windowed_attention_image_ref(qkv_d, *a10),)),
                  ("without the mask", lambda: (
                      att.windowed_attention_image_ref(
                          qkv_img, bias, None, heads, scale, ws),))
                  if bf else
                  ("on TF32 operands", lambda: (image_attention_fault(
                      qkv_img, *a10, operands=tf32),))],
                 tol, awork, peak)
            r11 = getattr(attn_ops, "fused_window_attention" + sfx)
            a11 = (bias, mask, scale)
            hold(r11.__name__, f"2l {label} masked", r11, ("out",),
                 lambda: (r11(q, k, v, *a11),),
                 lambda: (attn_ops.attend_tiled(q, k, v, *a11),),
                 [(dropped, lambda: (
                     attn_ops.attend_tiled(q_d, k, v, *a11),)),
                  ("without the mask", lambda: (
                      attn_ops.attend_tiled(q, k, v, bias, None, scale),))
                  if bf else
                  ("on TF32 operands", lambda: (attend_fault(
                      q, k, v, *a11, operands=tf32),))],
                 tol, awork, peak, sdpa)
            del qkv_img, qkv_d, q, k, v, q_d, qs, ks, vs, am
            torch.cuda.empty_cache()

            # ---- the attention backward alone, then K5 ----
            with torch.no_grad():
                fwd = att._forward_kernel if bf else att._forward_f32
                _, qkv, attn = fwd(x, wq, bq, wp, bp, bias, mask, heads,
                                   scale, ws, shift)
                rows = window_rows(R, (T, h, w, ws, 0), dev)
                dattn = (g.reshape(R, C)[rows].float()
                         @ wp.float()).to(dtype)
            args = (qkv, dattn, bias, mask, heads, scale, TN)
            qkv_dr = qkv.clone()
            qkv_dr[:, :C] = drop_last_chunk(qkv[:, :C], heads, chunk)
            lib = sdpa_bwd_yardstick(*args)

            def split(r):
                return (r[0][:, :C], r[0][:, C:2 * C], r[0][:, 2 * C:], r[1])
            bwd1 = att.attn_bwd if bf else att.attn_bwd_f32
            faults = [(dropped, lambda: split(
                att.attn_bwd_ref(qkv_dr, *args[1:])))]
            faults.append(
                ("without dbias", lambda: (lambda r: r[:3] + (
                    torch.zeros_like(r[3]),))(split(att.attn_bwd_ref(*args))))
                if bf else
                ("on TF32 operands", lambda: split(attn_bwd_tf32(*args))))
            hold(bwd1.__name__, f"2l {label} masked", bwd1,
                 ("dq", "dk", "dv", "dbias"),
                 (lambda: split(att.attn_bwd(qkv, dattn, attn, *args[2:])))
                 if bf else (lambda: split(att.attn_bwd_f32(*args))),
                 lambda: split(att.attn_bwd_ref(*args)), faults, tol,
                 (10 * R * TN * C, 7 * R * C * x.element_size()
                  + (2 * heads * TN * TN + mask.numel()) * 4), peak, lib)
            del lib, qkv_dr
            k5 = getattr(att, "swin_block_attention_bwd" + sfx)
            fa = (x, wq, bq, wp, bp, bias, mask)

            def k5_twin():
                return att.swin_block_attention_bwd_ref(*fa, g, heads,
                                                        scale, ws, shift)
            faults = [("without dbias", lambda: (
                lambda r: r[:5] + (torch.zeros_like(r[5]),))(k5_twin()))]
            if bf:
                faults.append(("without the row-sum term (dS = P dP)",
                               lambda: attention_bwd_without_rowsum(
                                   *fa, g, heads, scale, ws, shift)))
            hold(k5.__name__, f"2l {label} shift={shift}", k5,
                 ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias"),
                 lambda: k5(x, g, qkv, attn, wq, wp, bias, mask, heads,
                            scale, ws, shift), k5_twin, faults, tol,
                 k5_work(x, heads, TN, mask), peak)
            forms = read_launches(wrappers)[1]
            fwd_n = forms["attn_streamed" if bf else "attn_f32_streamed"]
            bwd_n = forms["attn_bwd_passes" if bf else
                          "attn_bwd_f32_streamed"]
            # K1 twice in each of two shifts and five timed runs after two
            # warm-ups: 2 x (2 + 7); rows 10 and 11: 9 each; the scratch
            # forward above once; the backward alone and inside K5: 9 each
            want_f = 37 if fwd_streamed else 0
            want_b = 18 if bwd_streamed else 0
            print(f"  [2l {label} {name}] streamed launches: forward "
                  f"{fwd_n} (expected {want_f}), backward {bwd_n} "
                  f"(expected {want_b})", flush=True)
            check(fwd_n == want_f and bwd_n == want_b,
                  f"2l {label} {name}: streamed launches {fwd_n} / {bwd_n}, "
                  f"expected {want_f} / {want_b}")
            del x, g, qkv, attn, dattn, args
            torch.cuda.empty_cache()

    # refused before any launch in both dtypes: TN 192 and a head dim off 8
    for dtype in (bf16, f32):
        k1 = getattr(att, "swin_block_attention"
                     + ("" if dtype == bf16 else "_f32"))
        for (T, C, heads), why in (((3, 592, 2), "TN 192"),
                                   ((2, 600, 4), "hd 150")):
            n0 = k1.launches
            refused = ""
            try:
                xr = torch.empty((1, T, 8, 8, C), device=dev, dtype=dtype)
                k1(xr, torch.empty((3 * C, C), device=dev, dtype=dtype),
                   torch.empty(3 * C, device=dev),
                   torch.empty((C, C), device=dev, dtype=dtype),
                   torch.empty(C, device=dev),
                   torch.empty((heads, T * 64, T * 64), device=dev), None,
                   heads, 0.1, 8)
            except ValueError as e:
                refused = str(e)
            print(f"  [2l refused {dtype}] {why}: {refused!r}", flush=True)
            check(bool(refused) and k1.launches == n0,
                  f"2l: {why} in {dtype} not refused before a launch "
                  f"({refused!r})")
    print(f"phase 2l (a) the attention kernels past the resident pair: "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)


# Phase 2m: row 16 at every shape K1 + K2 take, both forms (label: x's
# shape (B, T, H, W, C), heads, ws): `swin_dim` 96's stage 1 at its
# serving batch (C 96, hd 24) and stage 2 (C 192, hd 48), `swin_dim` 32's
# stage 1 (hd 8); windows of 48 tokens (T 3), two a tile, x by the row
# map; past 128 tokens TN 144 (ws 6, T 4) and TN 176 (T 11), one window
# over two product tiles, the warps on further slabs (at hd 320 the
# streamed pair); `swin_dim=1280`'s two stages (C 1280 / 2560, hd 320 /
# 640) and `num_heads=1`'s (hd 512 / 1024) at their serving batch
WHOLE_ENVELOPE = {
    "C96 hd24 TN128": ((4, 2, 64, 80, 96), 4, 8),
    "C192 hd48 TN32": ((4, 2, 32, 40, 192), 4, 4),
    "C32 hd8 TN128": ((4, 2, 64, 80, 32), 4, 8),
    "TN48 C512": ((2, 3, 64, 80, 512), 4, 4),
    "TN144 C256": ((1, 4, 48, 60, 256), 4, 6),
    "TN176 C640 hd320": ((1, 11, 32, 40, 640), 2, 4),
    "C1280 hd320 TN128": ((4, 2, 64, 80, 1280), 4, 8),
    "C2560 hd640 TN32": ((4, 2, 32, 40, 2560), 4, 4),
    "C512 hd512 TN128": ((4, 2, 64, 80, 512), 1, 8),
    "C1024 hd1024 TN32": ((4, 2, 32, 40, 1024), 1, 4),
}
# (b) the models past the first row-16 envelope, with `whole_block=True`,
# stepped once at batch 2 in both dtypes (phase 2l (b) serves them with
# `whole_block=True` beside 'pallas_full', on the same build; `swin_dim`
# 96's are served and trained in phase 2j)
WHOLE_ENVELOPE_MODELS = {
    f"{name} whole_block{' fp32' if dt == 'float32' else ''}": (
        dict(fields, whole_block=True), dt)
    for name, fields in (("swin_dim=1280", dict(swin_dim=1280)),
                         ("num_heads=1", dict(num_heads=1)))
    for dt in ("bfloat16", "float32")}


def whole_block_without_late_slabs(x, params, cfg):
    """Row 16's twin with a planted fault of its slabs: the attention
    output of every window token past the first 128 left at zero, as if
    each of the 8 warps took only its first 16-row slab."""
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
    # window token r = frame * ws^2 + i * ws + j of each window
    r = torch.arange(T * ws * ws, device=x.device).view(T, 1, ws, 1, ws, 1)
    attn = attn.view(B, T, H // ws, ws, W // ws, ws, C).masked_fill(
        r >= 128, 0).view(B, T, H, W, C)
    y = F.linear(attn.float(), wproj.float(), bproj.float()).to(x.dtype)
    return swin_block_epilogue_with_m_ref(x, y, *params[6:])[0]


def phase_whole_block_envelope(dev, smi, wrappers, launches, results,
                               median_ms) -> dict:
    """Phase 2m: (a) row 16 at every WHOLE_ENVELOPE shape in both forms,
    with weights that make the attention branch as large as x: bit-equal
    to the K1 + K2 pair with m rounded (`whole_swin_block_pair(m_out=True)`)
    and call to call, within TOL_REL (bf16) / TOL_F32_REL (fp32, TF32 off)
    of its twin, planted faults tenfold out (the twin without its relative
    bias, or on TF32 operands in fp32; with its QK^T's last chunk dropped
    where the pair streams; without the last window of each tile at TN 48;
    without the slabs past 128 rows at TN 144 and 176), exactly one launch
    of the form a call and row 16's streamed launches exactly where the
    plan streams, timed beside the twin, the bound (24 R C^2 + 4 R TN C
    flops; x, out and the weights once) and the K1 + K2 pair on the same
    inputs (`pair_ms`, its yardstick); the workspace it allocates printed
    beside the card's memory. (b) WHOLE_ENVELOPE_MODELS stepped once at
    batch 2 (`step_largest`: row 16 once a W-MSA block call, the streamed
    backward where the plan streams; phase 2l (b) served them). Returns
    the pair's ms by case."""
    import torch
    from stswincl_tpu_torch.ops import swin_block as wb_ops

    t_start = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(27)
    bf16, f32 = torch.bfloat16, torch.float32
    pair_ms = {}
    total_mem = torch.cuda.get_device_properties(dev).total_memory

    def randn(*shape, scale=1.0, dtype=f32):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def uniform(*shape, fan_in, gain=1.0, dtype=f32):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1)
                * gain * fan_in ** -0.5).to(dtype)

    for label, (shape, heads, ws) in WHOLE_ENVELOPE.items():
        B, T, h, w, C = shape
        TN, hd, hidden = T * ws * ws, C // heads, 4 * C
        R, cfgw = B * T * h * w, (heads, hd ** -0.5, ws)
        for dtype in (bf16, f32):
            bf = dtype == bf16
            sfx, tol = ("", TOL_REL) if bf else ("_f32", TOL_F32_REL)
            name = "whole_swin_block" + sfx
            form = getattr(wb_ops, name)
            plan = wb_ops.whole_block_plan(B, T, h, w, C, hidden, heads, ws,
                                           dtype)
            case = f"2m {label}"
            x = randn(*shape, dtype=dtype)
            # qkv and proj weights and the relative bias as phase 2d draws
            # them: the attention branch about as large as x, the softmax
            # peaked
            params = [uniform(3 * C, C, fan_in=C, gain=3.0, dtype=dtype),
                      uniform(3 * C, fan_in=C),
                      uniform(C, C, fan_in=C, gain=2.0, dtype=dtype),
                      uniform(C, fan_in=C), randn(heads, TN, TN), None,
                      1.0 + randn(C, scale=0.1), randn(C, scale=0.1),
                      uniform(hidden, C, fan_in=C, dtype=dtype),
                      uniform(hidden, fan_in=C),
                      uniform(C, hidden, fan_in=hidden, dtype=dtype),
                      uniform(C, fan_in=hidden),
                      1.0 + randn(C, scale=0.1), randn(C, scale=0.1)]

            def kfn():
                return wb_ops.whole_swin_block(x, *params, *cfgw)

            def twin(ps=params):
                return wb_ops.whole_swin_block_ref(x, *ps, *cfgw)

            def pair():
                return wb_ops.whole_swin_block_pair(x, *params, *cfgw,
                                                    m_out=True)
            reset_launches(wrappers)
            with torch.no_grad():
                got, again = kfn(), kfn()
                torch.cuda.synchronize()
                launched = form.launches
                streamed = read_launches(wrappers)[1][
                    "whole_streamed" if bf else "whole_f32_streamed"]
                want_pair = pair()
                pair_diff = (got.float() - want_pair.float()).abs().max() \
                    .item()
                bit = torch.equal(got, again)
                same_pair = torch.equal(got, want_pair)
                del again, want_pair
                want = twin()
                rel = rel_err(got, want)
                max_abs = (got.float() - want.float()).abs().max().item()
                faults = {}
                if bf:
                    no_bias = list(params)
                    no_bias[4] = torch.zeros_like(params[4])
                    faults["without its relative bias"] = twin(no_bias)
                else:
                    faults["on TF32 operands"] = whole_block_fault(
                        x, params, cfgw, rnd=tf32)
                if plan.streamed:
                    chunk = 64 if bf else 32
                    dropped = list(params)
                    dropped[0] = params[0].clone()
                    dropped[0][:C] = drop_last_chunk(params[0][:C].t(),
                                                     heads, chunk).t()
                    dropped[1] = params[1].clone()
                    dropped[1][:C] = drop_last_chunk(params[1][:C], heads,
                                                     chunk)
                    faults["with its QK^T's last chunk dropped"] = twin(
                        dropped)
                if plan.windows_per_tile > 1 and 128 % TN:
                    faults["without the last window of each tile"] = \
                        whole_block_without_last_window(
                            x, params, cfgw, plan.windows_per_tile)
                if TN > 128:
                    faults["without the slabs past 128 rows"] = \
                        whole_block_without_late_slabs(x, params, cfgw)
                moved = {k: rel_err(v, want) for k, v in faults.items()}
                del faults, want, got
            torch.cuda.empty_cache()
            check(launched == 2, f"{name} {case}: {launched} launches of "
                  "the form in two calls")
            want_s = 2 if plan.streamed else 0
            check(streamed == want_s, f"{name} {case}: {streamed} launches "
                  f"ran the streamed pair, expected {want_s}")
            check(bit and same_pair, f"{name} {case}: bit-equal call to "
                  f"call {bit}, to the pair with m rounded {same_pair} "
                  f"(largest difference {pair_diff})")
            check(rel <= tol, f"{name} {case}: relative error {rel} > {tol}")
            for k, v in moved.items():
                check(v > 10 * tol, f"{name} {case}: the twin {k} moves "
                      f"the output by only {v}")
            slot = sum(plan.slot_bytes.values())
            slots = min(plan.tiles, wb_ops._slots(
                T, C, heads, ws, dev.index, dtype, slot))
            work = (24 * R * C * C + 4 * R * TN * C,
                    2 * R * C * x.element_size()
                    + 12 * C * C * x.element_size()
                    + (9 * C + hidden) * 4 + heads * TN * TN * 4)
            row = {"case": case, "rel_err": rel, "max_abs_err": max_abs,
                   "bit_equal": bit, "pair_m_rounded_max_abs": pair_diff,
                   "faults": moved, "streamed": plan.streamed,
                   "x_by": plan.x_by, "m_tiles": plan.m_tiles,
                   "workspace_bytes": slots * slot,
                   "ms": median_ms(kfn, reps=5),
                   "plain_ms": median_ms(twin, reps=3), "library_ms": None,
                   **bound(*work, peak=PEAK_BF16 if bf else PEAK_3XTF32)}
            pair_ms[f"{case} {'bf16' if bf else 'fp32'}"] = row["pair_ms"] = \
                median_ms(pair, reps=3)
            results.setdefault(name, []).append(row)
            print(f"  {name:22s} {case:24s} x {shape}, {heads} heads: "
                  f"{'streamed' if plan.streamed else 'resident'} pairs, x "
                  f"by {plan.x_by}, {plan.m_tiles} product tile(s) a tile; "
                  f"== pair with m rounded {same_pair}, bit-equal {bit}; "
                  f"rel {rel:.2e} (bound {tol:.0e}); faults "
                  + ", ".join(f"{k} {v / tol:.0f}x" for k, v in moved.items())
                  + f"; {row['ms']:.3f} ms, twin {row['plain_ms']:.3f} ms, "
                  f"K1 + K2 pair {row['pair_ms']:.3f} ms, bound "
                  f"{row['bound_ms']:.3f} ms ({row['bound_ms'] / row['ms']:.2f}"
                  f" of it); workspace {slots} slots x {slot / 2 ** 20:.3f} "
                  f"MiB = {slots * slot / 2 ** 30:.3f} GiB of "
                  f"{total_mem / 2 ** 30:.1f} GiB, on {smi}", flush=True)
            del x, params
            torch.cuda.empty_cache()
    print(f"phase 2m (a) row 16 at every shape K1 + K2 take: "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    t = time.perf_counter()
    for label, (fields, dt) in WHOLE_ENVELOPE_MODELS.items():
        step_largest(dev, smi, wrappers, launches, label, fields, dt, (2,))
    print(f"  [2m (b)] stepped: {time.perf_counter() - t:.1f} s", flush=True)
    print(f"phase 2m row 16 past its first envelope: "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    return pair_ms


def step_largest(dev, smi, wrappers, launches, label, fields, dtype,
                 batches) -> None:
    """`ModelConfig(**fields, dtype=dtype)` stepped once through
    `SegTrainStep` at the largest of `batches` that fits: finite loss and
    gradients, K1, K2, K5 and K6 in the dtype's form once a block call,
    the streamed backward (bf16: K5's two passes; fp32: its streamed
    passes) once for each block call whose window its plan streams; its
    batch, step time and peak memory printed."""
    import torch
    from stswincl_tpu_torch.configs import ModelConfig, SegTrainConfig
    from stswincl_tpu_torch.models.swin import SpaceTimeSwinBlock
    from stswincl_tpu_torch.ops import block_attention as att

    f32 = dtype == "float32"
    sfx = "_f32" if f32 else ""
    fields, whole = route_fields(fields)
    cfg = SegTrainConfig(model=ModelConfig(**fields, dtype=dtype))
    tag = f"[step {label}]"
    imgs, lbls = seeded_batch(max(batches), seed=3)
    state = envelope_state(cfg)
    done = None
    for batch in batches:
        images = torch.from_numpy(imgs[:batch]).to(dev)
        labels = torch.from_numpy(lbls[:batch]).to(dev).long()
        m = envelope_model(dev, cfg, state=state, whole_block=whole)
        calls = {"block": 0, "streamed": 0, "whole": 0}

        def count(mod, inputs, out):
            if isinstance(mod, SpaceTimeSwinBlock):
                calls["block"] += 1
                calls["whole"] += whole and mod.shift_size == 0
                x = inputs[0]
                TN = x.shape[1] * mod.window_size ** 2
                hd = x.shape[-1] // mod.num_heads
                calls["streamed"] += (
                    not att._attn_f32_bwd_resident(TN, hd) if f32
                    else not att._attn_bwd_slot_takes(TN, hd))
        hook = torch.nn.modules.module.register_module_forward_hook(count)
        reset_launches(wrappers)
        torch.cuda.reset_peak_memory_stats()
        try:
            losses, grads, secs = envelope_steps(cfg, m, 1, images, labels)
            done = batch
        except torch.cuda.OutOfMemoryError as e:
            print(f"  {tag} batch {batch} does not fit: "
                  f"{str(e).splitlines()[0][:120]}", flush=True)
        finally:
            hook.remove()
        if done is None:
            del m, images, labels
            torch.cuda.empty_cache()
            continue
        counts, forms = read_launches(wrappers)
        launches[f"step {label}"] = counts
        fwd_n = forms["attn_f32_streamed" if f32 else "attn_streamed"]
        bwd_n = forms["attn_bwd_f32_streamed" if f32 else "attn_bwd_passes"]
        STREAMED_LAUNCHES[f"step {label} at batch {batch}: forward, "
                          "backward"] = (fwd_n, bwd_n)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        finite = all(bool(torch.isfinite(t).all()) for t in grads.values())
        print(f"  {tag} the largest batch that fits: {batch} (of "
              f"{batches}); loss {losses[0]:.6f}, {len(grads)} gradients "
              f"finite {finite}, {1e3 * secs[0]:.1f} ms the step, peak "
              f"{peak:.2f} GiB, {calls['block']} block calls, streamed "
              f"launches forward {fwd_n} backward {bwd_n} (expected "
              f"{calls['streamed']}), on {smi}", flush=True)
        check(math.isfinite(losses[0]) and finite, f"{tag}: loss "
              f"{losses[0]}, gradients finite {finite}")
        for k in ("swin_block_attention", "swin_block_epilogue",
                  "swin_block_attention_bwd", "swin_block_epilogue_bwd"):
            check(counts[k + sfx] == calls["block"], f"{tag}: {k + sfx} "
                  f"launched {counts[k + sfx]} times for {calls['block']} "
                  "block calls")
        check(fwd_n > 0 and bwd_n == calls["streamed"], f"{tag}: the "
              f"streamed forward ran {fwd_n} times, the streamed backward "
              f"{bwd_n} times for {calls['streamed']} block calls")
        check(counts["whole_swin_block" + sfx] == calls["whole"],
              f"{tag}: whole_swin_block{sfx} launched "
              f"{counts['whole_swin_block' + sfx]} times for "
              f"{calls['whole']} W-MSA block calls")
        del m, grads, images, labels
        torch.cuda.empty_cache()
        break
    check(done is not None, f"{tag}: no batch of {batches} fits")


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


# ---- phase 7: fp32 serving and evaluation on the card's kernels ------------

# (a) each fp32 form against its fp32 twin (TF32 off). An fp32-accurate form
# reads about 1e-6: the same fp32 arithmetic in another summation order. One
# product on TF32 operands (the low 13 mantissa bits cleared) moves an
# output by 5e-4 or more, K2's LN1 dilutes it to about 7e-4, so the bound
# sits more than tenfold below that and the planted TF32 fault must miss it
# tenfold; 1e-4 would let K2's and K3's miss by 7-8x only
TOL_F32_REL = 2e-5
# the least time of an fp32-accurate product on the card: the 3xTF32 split
# on the tensor cores (three TF32 products at 494.7 TFLOP/s, the table's
# dense rate; `tools/profile_mma_rate.py` measures the card's own wgmma
# rate, which this script does not); PEAK_F32, the
# CUDA cores' fp32 FMA, is the ceiling of the one fp32 product left there
# (K5's attention backward)
PEAK_3XTF32 = 494.7e12 / 3
# (b) predict_next steps driven on each route; (b, c) the fp32 kernel route
# against the fp32 plain route (`kernels=False`), share of equal pixels
F32_STEPS = 6
TOL_F32_SHARE = 0.999
# a predict_next at depths (3, 3) under final_pair_only: 7 W-MSA / SW-MSA
# block pairs, one patch merge, one resize + argmax
SERVE_STEP = {"attention": 14, "epilogue": 14, "patch_merge": 1,
              "upsample_argmax": 1}
# (f) a predict_next on each route off 'pallas_full': the launches of
# phases 3b / 3c, each kernel in its fp32 form (K4 in its exact form)
F32_ROUTE_SERVE_STEP = {
    route: {attn: n, "swin_block_epilogue_f32": n,
            "patch_merge_f32": 1, "upsample_argmax": 1, **extra}
    for route, attn, n, extra in (
        ("pallas", "windowed_attention_image_f32", 14, {}),
        ("pallas_windows", "fused_window_attention_f32", 14, {}),
        ("whole_block", "whole_swin_block_f32", 7,
         {"swin_block_attention_f32": 7}))}
# (a)'s block shapes: the serving batch's two groups of 2 frames at each
# stage, (4, 2, 64, 80, 512) and (4, 2, 32, 40, 1024); K3 at (8, 64, 80,
# 512)
F32_STAGES = {1: dict(C=512, h=64, w=80, ws=8), 2: dict(C=1024, h=32, w=40,
                                                        ws=4)}


def tf32(t):
    """t (fp32) with the low 13 of its 23 mantissa bits cleared: the
    operand a single-pass TF32 product reads."""
    import torch
    return (t.contiguous().view(torch.int32) & -8192).view(torch.float32)


def block_attention_tf32(x, wqkv, bqkv, wproj, bproj, bias, mask, heads,
                         scale, ws, shift=0):
    """K1's fp32 twin with a planted fault: every product operand rounded
    to TF32 (`tf32`), what a form that ran its products in one TF32 pass
    would give."""
    import torch
    import torch.nn.functional as F
    from stswincl_tpu_torch.ops.window import partition_qkv, reverse_windows
    B, T, H_, W_, _ = x.shape
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(2, 3))
    qkv = F.linear(tf32(x), tf32(wqkv), bqkv)
    q, k, v = partition_qkv(qkv, heads, ws)
    Bw, _, TN, _ = q.shape
    s = (tf32(q) @ tf32(k).transpose(-1, -2)) * scale + bias[None]
    if mask is not None and mask.shape[0] > 1:
        nW = mask.shape[0]
        s = (s.reshape(Bw // nW, nW, heads, TN, TN)
             + mask[None, :, None]).reshape(Bw, heads, TN, TN)
    attn = reverse_windows(tf32(torch.softmax(s, dim=-1)) @ tf32(v), B, T,
                           H_, W_, ws)
    return F.linear(tf32(attn), tf32(wproj), bproj)


def epilogue_tf32(x, y, s2, b2, w1, b1, w2, bw2, s1, b1n, gelu_exact=True,
                  shift=0, ws=None, eps=1e-5):
    """K2's fp32 twin with fc1 and fc2 on TF32 operands (`tf32`)."""
    import torch
    import torch.nn.functional as F
    from stswincl_tpu_torch.ops.add_ln_mlp import layer_norm_f32
    from stswincl_tpu_torch.ops.mlp import gelu
    if shift:
        y = torch.roll(y, (shift, shift), dims=(2, 3))
    s = x + y
    n2 = layer_norm_f32(s, s2, b2, eps)
    h = gelu(F.linear(tf32(n2), tf32(w1), b1), gelu_exact)
    return layer_norm_f32(s + F.linear(tf32(h), tf32(w2), bw2), s1, b1n,
                          eps)


def patch_merge_tf32(x, scale, bias, w, eps=1e-5):
    """K3's fp32 twin with its product on TF32 operands (`tf32`)."""
    import torch.nn.functional as F
    from stswincl_tpu_torch.ops.patch_merge import patch_merge_ln_ref
    return F.linear(tf32(patch_merge_ln_ref(x, scale, bias, eps)), tf32(w))


def f32_bound(flops: float, nbytes: float) -> dict:
    """`bound` at the 3xTF32 rate, with the fp32 FMA ceiling beside it."""
    return {**bound(flops, nbytes, PEAK_3XTF32),
            "fma_bound_ms": flops / PEAK_F32 * 1e3}


def top_cuda_kernel(fn) -> str:
    """The name of the CUDA kernel that takes the most device time in one
    call of fn (a warmed call), from torch.profiler's kernel events; "not
    measured" where the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    best, name = 0.0, "not measured"
    for e in prof.key_averages():
        if getattr(e, "device_type", DeviceType.CUDA) != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t > best:
            best, name = t, e.key
    return name


def rate_line(row: dict, flops: float) -> str:
    """The achieved TFLOP/s of a phase 7 (a) row and its share of its
    bound (`f32_bound`), the library call's beside them; sets the row's
    `tflops`, `bound_share` and, with a library time, `library_tflops`
    and `library_bound_share`."""
    row["tflops"] = flops / row["ms"] * 1e-9
    row["bound_share"] = row["bound_ms"] / row["ms"]
    out = (f"{row['tflops']:.1f} TFLOP/s, {row['bound_share']:.3f} of the "
           "bound")
    if row.get("library_ms") is not None:
        row["library_tflops"] = flops / row["library_ms"] * 1e-9
        row["library_bound_share"] = row["bound_ms"] / row["library_ms"]
        out += (f"; the library {row['library_tflops']:.1f} TFLOP/s, "
                f"{row['library_bound_share']:.3f}")
    return out


def phase_fp32_kernels(dev, results, median_ms) -> None:
    """Phase 7 (a): K1, K2 (plain, shifted and the final-pair T 1 slice)
    and K3 in fp32 against their fp32 twins at the serving shapes of both
    stages, with fp32 weights as the model holds them and phase 2's large
    attention branch (qkv gain 3, proj gain 2, an N(0, 1) relative bias);
    the MLP's weights at gain 2, so that its branch is as large as x. Each
    within TOL_F32_REL; planted faults (every product operand on TF32,
    phase 2's: no relative bias, the wrong shift, the 2x2 gather swapped)
    must miss it tenfold. Timed beside the twin and the bf16 kernel on the
    same values cast to bf16. Then the fp32 GEMM alone at each of their
    products (`ops.gemm.linear_f32`, K1's with its row maps) beside cuBLAS's
    fp32 F.linear on the same operands, its yardstick."""
    import torch
    import torch.nn.functional as F
    from stswincl_tpu_torch.ops import gemm as gemm_ops
    from stswincl_tpu_torch.ops.add_ln_mlp import (swin_block_epilogue,
                                                   swin_block_epilogue_f32,
                                                   swin_block_epilogue_ref)
    from stswincl_tpu_torch.ops.block_attention import (
        swin_block_attention, swin_block_attention_f32,
        swin_block_attention_ref)
    from stswincl_tpu_torch.ops.patch_merge import (patch_merge,
                                                    patch_merge_f32,
                                                    patch_merge_ref)
    from stswincl_tpu_torch.ops.window import shifted_window_attention_mask

    check(not torch.backends.cuda.matmul.allow_tf32,
          "phase 7: the fp32 twins must run with TF32 off")
    gen = torch.Generator(device=dev).manual_seed(11)
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def uniform(*shape, fan_in, gain=1.0):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1)
                * gain * fan_in ** -0.5)

    def compare(kname, case, form, kfn, pfn, bfn, faults, work, lib=None):
        got, want = kfn(), pfn()
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == f32 == want.dtype,
              f"{kname} {case}: {got.shape}/{got.dtype} vs "
              f"{want.shape}/{want.dtype}")
        n = form.launches
        again = kfn()
        check(form.launches == n + 1, f"{kname} {case}: {form.launches - n}"
              " launches of the fp32 form a call")
        check(torch.equal(got, again), f"{kname} {case}: two calls differ "
              f"by {(got - again).abs().max().item()}")
        del again
        d = got - want
        row = {"case": case, "max_abs_err": d.abs().max().item(),
               "rel_err": (d.norm() / want.norm()).item(),
               "ms": median_ms(kfn), "plain_ms": median_ms(pfn),
               "bf16_ms": None if bfn is None else median_ms(bfn),
               "library_ms": None if lib is None else median_ms(lib),
               **f32_bound(*work)}
        results.setdefault(kname, []).append(row)
        print(f"  {kname:24s} {case:36s} rel {row['rel_err']:.3e} max_abs "
              f"{row['max_abs_err']:.3e} fp32 kernel {row['ms']:.3f} ms twin "
              f"{row['plain_ms']:.3f} ms" + (
                  "" if bfn is None else f" bf16 kernel {row['bf16_ms']:.3f}"
                  " ms") + ("" if lib is None else
                            f" library {row['library_ms']:.3f} ms")
              + f" bound {row['bound_ms']:.4f} ms (FMA "
              f"{row['fma_bound_ms']:.4f})", flush=True)
        print(f"  {'':24s} {case:36s} {rate_line(row, work[0])}",
              flush=True)
        check(row["rel_err"] <= TOL_F32_REL, f"{kname} {case}: relative "
              f"error {row['rel_err']} > {TOL_F32_REL}")
        for fault, fn in faults:
            moved = rel_err(fn(), want)
            row.setdefault("faults", {})[fault] = moved
            print(f"  {'':24s} {case:36s} the twin {fault} moves by rel "
                  f"{moved:.3e} ({moved / TOL_F32_REL:.1f}x the bound)",
                  flush=True)
            check(moved > 10 * TOL_F32_REL, f"{kname} {case}: the twin "
                  f"{fault} moves the output by only {moved}")
        return want

    gemms = []  # (case, a, wt, bias, act, a_map, c_map, out)
    heads, T = 4, 2
    with torch.inference_mode():
        for s, cfg in F32_STAGES.items():
            C, h, w, ws = cfg["C"], cfg["h"], cfg["w"], cfg["ws"]
            TN, R = T * ws * ws, 2 * BS * T * h * w
            x = randn(2 * BS, T, h, w, C)
            wqkv, bqkv = (uniform(3 * C, C, fan_in=C, gain=3.0),
                          uniform(3 * C, fan_in=C))
            wproj, bproj = (uniform(C, C, fan_in=C, gain=2.0),
                            uniform(C, fan_in=C))
            bias = randn(heads, TN, TN)
            for shift in (0, ws // 2):
                mask = None
                if shift:
                    mask = torch.from_numpy(shifted_window_attention_mask(
                        h, w, ws, shift)).repeat(1, T, T).to(dev)
                args = (x, wqkv, bqkv, wproj, bproj, bias, mask, heads,
                        (C // heads) ** -0.5, ws, shift)
                bargs = (x.to(bf16), wqkv.to(bf16), bqkv, wproj.to(bf16),
                         *args[4:])
                tables = heads * TN * TN * 4 + (0 if mask is None
                                                else mask.numel() * 4)
                compare("swin_block_attention_f32",
                        f"stage{s} {tuple(x.shape)} shift={shift}",
                        swin_block_attention_f32,
                        lambda: swin_block_attention(*args),
                        lambda: swin_block_attention_ref(*args),
                        lambda: swin_block_attention(*bargs),
                        [("on TF32 operands",
                          lambda: block_attention_tf32(*args)),
                         ("without its relative bias",
                          lambda: swin_block_attention_ref(
                              *args[:5], torch.zeros_like(bias), *args[6:])),
                         (f"at shift {shift + 1}",
                          lambda: swin_block_attention_ref(*args[:10],
                                                           shift + 1))],
                        (4 * R * TN * C + 8 * R * C * C,
                         2 * R * C * 4 + 4 * C * C * 4 + 4 * C * 4 + tables))
            a_map = (T, h, w, ws, ws // 2)
            gemms += [(f"K1 qkv stage{s} ({R}, {C}) -> {3 * C}, gather",
                       x.reshape(R, C), wqkv, bqkv, "none", a_map, None,
                       None),
                      (f"K1 proj stage{s} ({R}, {C}) -> {C}, scatter",
                       randn(R, C), wproj, bproj, "none", None,
                       (T, h, w, ws, 0), None)]
            hidden = 4 * C
            epi_w = (1.0 + randn(C, scale=0.1), randn(C, scale=0.1),
                     uniform(hidden, C, fan_in=C, gain=2.0),
                     uniform(hidden, fan_in=C),
                     uniform(C, hidden, fan_in=hidden, gain=2.0),
                     uniform(C, fan_in=hidden),
                     1.0 + randn(C, scale=0.1), randn(C, scale=0.1))
            bepi = [t.to(bf16) if t.dim() == 2 else t for t in epi_w]
            y = randn(*x.shape)
            cases = [("plain", x, y, 0), (f"shift={ws // 2}", x, y, ws // 2)]
            if s == 1:  # the final_pair_only slice
                cases.append((f"T=1 shift={ws // 2}", x[:, 1:].contiguous(),
                              y[:, 1:].contiguous(), ws // 2))
            for name, xa, ya, shift in cases:
                kw = dict(gelu_exact=True, shift=shift, ws=ws)
                rows = xa.numel() // C
                xb, yb = xa.to(bf16), ya.to(bf16)
                compare("swin_block_epilogue_f32",
                        f"stage{s} {tuple(xa.shape)} {name}",
                        swin_block_epilogue_f32,
                        lambda: swin_block_epilogue(xa, ya, *epi_w, **kw),
                        lambda: swin_block_epilogue_ref(xa, ya, *epi_w, **kw),
                        lambda: swin_block_epilogue(xb, yb, *bepi, **kw),
                        [("on TF32 operands",
                          lambda: epilogue_tf32(xa, ya, *epi_w, **kw)),
                         (f"at shift {shift + 1}",
                          lambda: swin_block_epilogue_ref(
                              xa, ya, *epi_w, **dict(kw, shift=shift + 1)))],
                        (4 * rows * C * hidden,
                         3 * rows * C * 4 + 2 * C * hidden * 4
                         + (hidden + 5 * C) * 4))
            n2 = randn(R, C)
            gemms += [(f"K2 fc1 stage{s} ({R}, {C}) -> {hidden}, erf", n2,
                       epi_w[2], epi_w[3], "erf", None, None, None),
                      (f"K2 fc2 stage{s} ({R}, {hidden}) -> {C}, + s",
                       randn(R, hidden), epi_w[4], epi_w[5], "none", None,
                       None, randn(R, C))]
            del x, y
        C, h, w = (F32_STAGES[1][k] for k in ("C", "h", "w"))
        pm = (1.0 + randn(4 * C, scale=0.1), randn(4 * C, scale=0.1),
              uniform(2 * C, 4 * C, fan_in=4 * C))
        xm = randn(4 * BS, h, w, C)
        rm = xm.numel() // C // 4
        xmb, pmb = xm.to(bf16), (*pm[:2], pm[2].to(bf16))
        compare("patch_merge_f32", f"{tuple(xm.shape)}", patch_merge_f32,
                lambda: patch_merge(xm, *pm), lambda: patch_merge_ref(xm, *pm),
                lambda: patch_merge(xmb, *pmb),
                [("on TF32 operands", lambda: patch_merge_tf32(xm, *pm)),
                 ("with the 2x2 gather order swapped",
                  lambda: patch_merge_ref(xm.transpose(1, 2).contiguous(),
                                          *pm).transpose(1, 2))],
                (16 * rm * C * C, xm.numel() * 4 + rm * 2 * C * 4
                 + 8 * C * C * 4 + 8 * C * 4))
        gemms.append((f"K3 ({rm}, {4 * C}) -> {2 * C}",
                      randn(rm, 4 * C), pm[2], None, "none", None, None,
                      None))
        del xm, xmb
        phase_fp32_route_kernels(dev, compare, randn, uniform, median_ms,
                                 results)

        for case, a, wt, bias_, act, a_map, c_map, out in gemms:
            M, K = a.shape
            N = wt.shape[0]

            def kfn():
                return gemm_ops.linear_f32(
                    a, wt, bias_, act, a_map, c_map,
                    None if out is None else out.clone())

            def pfn():
                return gemm_ops.linear_sm90_ref(
                    a, wt, bias_, act, a_map, c_map, out,
                    "bf16" if out is None else "resid_f32")

            got, want = kfn(), pfn()
            d = got - want
            row = {"case": case, "max_abs_err": d.abs().max().item(),
                   "rel_err": (d.norm() / want.norm()).item(),
                   "ms": median_ms(kfn), "plain_ms": median_ms(pfn),
                   "library_ms": median_ms(lambda: F.linear(a, wt, bias_)),
                   "tf32_fault": rel_err(gemm_ops.linear_sm90_ref(
                       tf32(a), tf32(wt), bias_, act, a_map, c_map, out,
                       "bf16" if out is None else "resid_f32"), want),
                   **f32_bound(2 * M * N * K,
                               (M * K + N * K + M * N * (2 if out is not None
                                                         else 1)) * 4)}
            results.setdefault("linear_f32", []).append(row)
            rates = rate_line(row, 2 * M * N * K)
            print(f"  {'linear_f32':24s} {case:36s} rel {row['rel_err']:.3e}"
                  f" {row['ms']:.3f} ms ({rates}) cuBLAS fp32 "
                  f"{row['library_ms']:.3f} ms twin {row['plain_ms']:.3f} ms"
                  f" bound {row['bound_ms']:.4f} ms (FMA "
                  f"{row['fma_bound_ms']:.4f}); on TF32 operands the twin "
                  f"moves by {row['tf32_fault']:.3e}", flush=True)
            check(row["rel_err"] <= TOL_F32_REL, f"linear_f32 {case}: "
                  f"relative error {row['rel_err']} > {TOL_F32_REL}")
            check(row["tf32_fault"] > 10 * TOL_F32_REL, f"linear_f32 {case}"
                  f": the TF32 twin moves by only {row['tf32_fault']}")


def attend_fault(q, k, v, bias, mask, scale, operands=None, p_round=None):
    """`attend_tiled` in fp32 with a planted fault: q, k and v passed
    through `operands` (`tf32`: a form that ran Q K^T and P V in one TF32
    pass) and P through `p_round` (`tf32`, or a rounding to bf16: the
    bf16 kernels' contract)."""
    import torch
    if operands is not None:
        q, k, v = operands(q), operands(k), operands(v)
    Bw, heads, TN, _ = q.shape
    s = (q @ k.transpose(-1, -2)) * scale + bias[None]
    if mask is not None and mask.shape[0] > 1:
        nW = mask.shape[0]
        s = (s.reshape(Bw // nW, nW, heads, TN, TN)
             + mask[None, :, None]).reshape(Bw, heads, TN, TN)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e * (1.0 / e.sum(dim=-1, keepdim=True))
    if p_round is not None:
        p = p_round(p)
    return p @ v


def bf16_round(t):
    import torch
    return t.to(torch.bfloat16).float()


def image_attention_fault(qkv, bias, mask, heads, scale, ws, **fault):
    """Row 10's fp32 twin (`windowed_attention_image_ref`) with the
    planted fault of `attend_fault`."""
    from stswincl_tpu_torch.ops.window import partition_qkv, reverse_windows
    B, T, H_, W_, _ = qkv.shape
    q, k, v = partition_qkv(qkv, heads, ws)
    return reverse_windows(attend_fault(q, k, v, bias, mask, scale, **fault),
                           B, T, H_, W_, ws)


def whole_block_fault(x, params, cfg, rnd=None, p_round=None):
    """Row 16's fp32 twin with a planted fault: every product operand
    passed through `rnd` (`tf32`), P through `p_round`."""
    import torch.nn.functional as F
    from stswincl_tpu_torch.ops.add_ln_mlp import layer_norm_f32
    from stswincl_tpu_torch.ops.mlp import gelu
    r = rnd if rnd is not None else (lambda t: t)
    wqkv, bqkv, wproj, bproj, bias, _, s2, b2, w1, b1, w2, bw2, s1, b1n = \
        params
    heads, scale, ws = cfg
    qkv = F.linear(r(x), r(wqkv), bqkv)
    attn = image_attention_fault(qkv, bias, None, heads, scale, ws,
                                 operands=rnd, p_round=p_round)
    s = x + F.linear(r(attn), r(wproj), bproj)
    h = gelu(F.linear(r(layer_norm_f32(s, s2, b2, 1e-5)), r(w1), b1), True)
    return layer_norm_f32(s + F.linear(r(h), r(w2), bw2), s1, b1n, 1e-5)


def phase_fp32_route_kernels(dev, compare, randn, uniform, median_ms,
                             results) -> None:
    """Phase 7 (a), the routes off 'pallas_full': the fp32 forms of rows
    10 (image-layout qkv) and 11 (partitioned q, k, v) at both stages'
    serving window shapes, W-MSA and SW-MSA, and of row 16 (the whole
    W-MSA block) at both stages, through phase 7 (a)'s `compare`: each
    within TOL_F32_REL of its fp32 twin, bit-equal across two calls, timed
    beside the twin and the bf16 kernel on the same values (row 11 also
    beside SDPA in fp32, its library yardstick); planted faults in the
    twin must miss the bound tenfold: q, k, v (row 16: every product
    operand and P) on TF32, P rounded to bf16, and (SW-MSA) the mask
    dropped. qkv is drawn at std 2 and the relative bias N(0, 1), row
    16's weights as phase 7 (a) draws K1's and K2's, so that the softmax
    is peaked and the attention branch as large as x. Row 16 is also held
    within TOL_F32_REL of the fp32 K1 + K2 pair (`whole_swin_block_pair`,
    whose bits it should carry) and timed beside it."""
    import torch
    import torch.nn.functional as F
    from stswincl_tpu_torch.ops import swin_block as wb_ops
    from stswincl_tpu_torch.ops.attention import (attend_tiled,
                                                  fused_window_attention,
                                                  fused_window_attention_f32)
    from stswincl_tpu_torch.ops.block_attention import (
        windowed_attention_image, windowed_attention_image_f32,
        windowed_attention_image_ref)
    from stswincl_tpu_torch.ops.window import (partition_qkv,
                                               shifted_window_attention_mask)

    bf16 = torch.bfloat16
    heads, T = 4, 2
    for s, cfg in F32_STAGES.items():
        C, h, w, ws = cfg["C"], cfg["h"], cfg["w"], cfg["ws"]
        TN, hd, R = T * ws * ws, C // heads, 2 * BS * T * h * w
        scale = hd ** -0.5
        qkv = randn(2 * BS, T, h, w, 3 * C, scale=2.0)
        q, k, v = partition_qkv(qkv, heads, ws).contiguous()
        bias = randn(heads, TN, TN)
        qkvb, qb, kb, vb = (t.to(bf16) for t in (qkv, q, k, v))
        for shift in (0, ws // 2):
            mask = None
            if shift:
                mask = torch.from_numpy(shifted_window_attention_mask(
                    h, w, ws, shift)).repeat(1, T, T).to(dev)
            tables = heads * TN * TN * 4 + (0 if mask is None
                                            else mask.numel() * 4)
            work = (4 * R * TN * C, 4 * R * C * 4 + tables)
            a10 = (bias, mask, heads, scale, ws)
            faults = [("with q, k, v on TF32", lambda: image_attention_fault(
                          qkv, *a10, operands=tf32)),
                      ("with P rounded to bf16",
                       lambda: image_attention_fault(qkv, *a10,
                                                     p_round=bf16_round))]
            if mask is not None:
                faults.append(("without the mask",
                               lambda: windowed_attention_image_ref(
                                   qkv, bias, None, heads, scale, ws)))
            compare("windowed_attention_image_f32",
                    f"stage{s} {tuple(qkv.shape)} mask={bool(shift)}",
                    windowed_attention_image_f32,
                    lambda: windowed_attention_image(qkv, *a10),
                    lambda: windowed_attention_image_ref(qkv, *a10),
                    lambda: windowed_attention_image(qkvb, *a10), faults,
                    work)
            # the library yardstick: SDPA in fp32, bias (+ the window's
            # mask) its additive mask, windows regrouped so that the mask
            # broadcasts over the images; timed only, the port never calls
            # it
            if mask is None:
                qs, ks, vs, am = q, k, v, bias[None]
            else:
                nW = mask.shape[0]
                qs, ks, vs = (t.reshape(-1, nW * heads, TN, hd)
                              for t in (q, k, v))
                am = (mask[:, None] + bias[None]).reshape(1, nW * heads, TN,
                                                          TN)
            a11 = (bias, mask, scale)
            faults = [("with q, k, v on TF32", lambda: attend_fault(
                          q, k, v, *a11, operands=tf32)),
                      ("with P rounded to bf16", lambda: attend_fault(
                          q, k, v, *a11, p_round=bf16_round))]
            if mask is not None:
                faults.append(("without the mask", lambda: attend_tiled(
                    q, k, v, bias, None, scale)))
            compare("fused_window_attention_f32",
                    f"stage{s} {tuple(q.shape)} mask={bool(shift)}",
                    fused_window_attention_f32,
                    lambda: fused_window_attention(q, k, v, *a11),
                    lambda: attend_tiled(q, k, v, *a11),
                    lambda: fused_window_attention(qb, kb, vb, *a11),
                    faults, work,
                    lambda: F.scaled_dot_product_attention(
                        qs, ks, vs, attn_mask=am, scale=scale))
            # which of SDPA's backends ran in fp32: its kernel's name
            row = results["fused_window_attention_f32"][-1]
            row["library_kernel"] = top_cuda_kernel(
                lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=am, scale=scale))
            print(f"  {'':24s} {'':36s} SDPA's kernel in fp32: "
                  f"{row['library_kernel']}", flush=True)
            del qs, ks, vs, am
        del qkv, q, k, v, qkvb, qb, kb, vb

        # row 16, W-MSA, the weights phase 7 (a) gives K1 and K2
        hidden = 4 * C
        x = randn(2 * BS, T, h, w, C)
        params = [uniform(3 * C, C, fan_in=C, gain=3.0),
                  uniform(3 * C, fan_in=C),
                  uniform(C, C, fan_in=C, gain=2.0), uniform(C, fan_in=C),
                  randn(heads, TN, TN), None,
                  1.0 + randn(C, scale=0.1), randn(C, scale=0.1),
                  uniform(hidden, C, fan_in=C, gain=2.0),
                  uniform(hidden, fan_in=C),
                  uniform(C, hidden, fan_in=hidden, gain=2.0),
                  uniform(C, fan_in=hidden),
                  1.0 + randn(C, scale=0.1), randn(C, scale=0.1)]
        bparams = [p if p is None or p.dim() != 2 else p.to(bf16)
                   for p in params]
        cfgw = (heads, scale, ws)
        xb = x.to(bf16)
        case = f"stage{s} {tuple(x.shape)}"
        compare("whole_swin_block_f32", case, wb_ops.whole_swin_block_f32,
                lambda: wb_ops.whole_swin_block(x, *params, *cfgw),
                lambda: wb_ops.whole_swin_block_ref(x, *params, *cfgw),
                lambda: wb_ops.whole_swin_block(xb, *bparams, *cfgw),
                [("on TF32 operands", lambda: whole_block_fault(
                    x, params, cfgw, rnd=tf32, p_round=tf32)),
                 ("with P rounded to bf16", lambda: whole_block_fault(
                     x, params, cfgw, p_round=bf16_round))],
                (8 * R * C * C + 4 * R * TN * C + 4 * R * C * hidden,
                 2 * R * C * 4 + (4 * C * C + 2 * C * hidden) * 4
                 + (9 * C + hidden) * 4 + heads * TN * TN * 4))

        def pair():
            return wb_ops.whole_swin_block_pair(x, *params, *cfgw)
        got = wb_ops.whole_swin_block(x, *params, *cfgw)
        want = pair()
        torch.cuda.synchronize()
        d = got - want
        row = results["whole_swin_block_f32"][-1]
        row.update(pair_rel_err=(d.norm() / want.norm()).item(),
                   pair_max_abs=d.abs().max().item(),
                   pair_bit_equal=bool(torch.equal(got, want)),
                   pair_ms=median_ms(pair))
        print(f"  {'':24s} {case:36s} against the fp32 K1 + K2 pair: rel "
              f"{row['pair_rel_err']:.3e}, max_abs {row['pair_max_abs']:.3e},"
              f" bit-equal {row['pair_bit_equal']}; the pair "
              f"{row['pair_ms']:.3f} ms", flush=True)
        check(row["pair_rel_err"] <= TOL_F32_REL, f"whole_swin_block_f32 "
              f"{case}: {row['pair_rel_err']} from the fp32 pair")
        del x, xb, params, bparams, got, want, d
        torch.cuda.empty_cache()


# (a) the fp32 training forms: K5 (Pallas row 6) at both stages' training
# shapes, K6 recomputing m (row 7) at stage 1's, K2 saving m (row 8) and
# K6 taking it (row 9) at stage 2's: F32_TRAIN_B pairs of 2 frames of the
# batch-8 clips, (16, 2, 64, 80, 512) and (16, 2, 32, 40, 1024); then the
# shapes the stage-2 step gives the forms (CONTRAST_STAGE: seven windows
# across, the shift maps at other H and W)
F32_TRAIN_B = 16
F32_TRAIN_CASES = (
    [(f"stage{s}", F32_TRAIN_B, c["C"], c["h"], c["w"], c["ws"])
     for s, c in F32_STAGES.items()]
    + [(c["label"], c["n"], c["C"], c["h"], c["w"], c["ws"])
       for c in CONTRAST_STAGE.values()])
# K5 alone at head dim 32 (`swin_dim` 128 over 4 heads), its batch-8
# stage-1 block shape, on stage 1's window (TN 128) and stage 2's (TN 32)
F32_HD32_CASES = [("hd32 TN128", F32_TRAIN_B, 128, 64, 80, 8),
                  ("hd32 TN32", F32_TRAIN_B, 128, 32, 40, 4)]


@contextlib.contextmanager
def tf32_products():
    """Every fp32 product of a twin in one TF32 pass on the tensor cores
    (operands rounded to 10 mantissa bits): the planted fault of a form
    that ran its products on TF32."""
    import torch
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def phase_fp32_train_kernels(dev, results, median_ms) -> None:
    """Phase 7 (a), training: rows 6, 7, 8 and 9 in fp32 against their
    fp32 twins (autograd of the fp32 K1 / K2 twins; row 8 the m-output
    twin) on every output within TOL_F32_REL, at the training shapes of
    stages 1 and 2 and at the stage-2 step's (F32_TRAIN_CASES), and row 6
    at head dim 32 (F32_HD32_CASES); the same
    twin with every product on TF32 operands must miss the bound tenfold
    (but the outputs no product reaches: dbproj and db1n, the column sums
    of g, and dbw2); each form bit-equal across two calls on the same
    inputs. Timed beside the fp32 twin, the bf16 kernel on the same values
    cast to bf16 and cuBLAS fp32 on each of its products summed; then
    `wgrad_f32` alone at K5's and K6's weight gradients beside
    `a.t() @ b`."""
    import torch
    from stswincl_tpu_torch.ops import add_ln_mlp as epi
    from stswincl_tpu_torch.ops import block_attention as att
    from stswincl_tpu_torch.ops import gemm as gemm_ops
    from stswincl_tpu_torch.ops.window import shifted_window_attention_mask

    gen = torch.Generator(device=dev).manual_seed(13)
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def uniform(*shape, fan_in, gain=1.0):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1)
                * gain * fan_in ** -0.5)

    def cast(ts, dtype):
        return [t.to(dtype) if isinstance(t, torch.Tensor)
                and t.is_floating_point() else t for t in ts]

    def hold(kname, case, form, names, kfn, twin, bfn, products, work,
             exempt=()):
        """kfn() and twin(dtype) return the same outputs, `names`."""
        n = form.launches
        got = kfn()
        check(form.launches == n + 1, f"{kname} {case}: "
              f"{form.launches - n} launches of the form a call")
        again = kfn()
        torch.cuda.synchronize()
        bit = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        want = twin(f32)
        with tf32_products():
            bad = twin(f32)
        outs, worst = {}, 0.0
        for name, a, w, b in zip(names, got, want, bad):
            rel, moved = rel_err(a, w), rel_err(b, w)
            outs[name] = {"rel_err": rel, "tf32_fault": moved,
                          "max_abs_err": (a - w).abs().max().item()}
            worst = max(worst, rel / TOL_F32_REL)
            check(rel <= TOL_F32_REL, f"{kname} {case} {name}: relative "
                  f"error {rel} > {TOL_F32_REL}")
            if name not in exempt:
                check(moved > 10 * TOL_F32_REL, f"{kname} {case} {name}: "
                      f"the twin on TF32 products moves by only {moved}")
        check(bit, f"{kname} {case}: two calls on the same inputs differ")
        del got, want, bad
        torch.cuda.empty_cache()
        row = {"case": case, "outputs": outs, "bit_equal": bit,
               "max_abs_err": max(o["max_abs_err"] for o in outs.values()),
               "rel_err": max(o["rel_err"] for o in outs.values()),
               "ms": median_ms(kfn, reps=3),
               "plain_ms": median_ms(lambda: twin(f32), reps=3),
               "bf16_ms": median_ms(bfn, reps=3),
               "library_ms": median_ms(products, reps=3),
               **f32_bound(*work)}
        results.setdefault(kname, []).append(row)
        print(f"  {kname:28s} {case:40s} worst rel / bound "
              f"{worst:.3f}, bit-equal {bit}; fp32 form {row['ms']:.2f} ms"
              f" twin {row['plain_ms']:.2f} ms bf16 kernel "
              f"{row['bf16_ms']:.2f} ms cuBLAS fp32 products "
              f"{row['library_ms']:.2f} ms bound {row['bound_ms']:.2f} ms "
              f"(FMA {row['fma_bound_ms']:.2f})", flush=True)
        print(f"  {'':28s} {rate_line(row, work[0])}", flush=True)
        for name, o in outs.items():
            print(f"  {'':28s} {name:8s} rel {o['rel_err']:.3e} TF32 fault "
                  f"{o['tf32_fault']:.3e} "
                  f"({o['tf32_fault'] / TOL_F32_REL:.1f}x the bound)",
                  flush=True)

    heads, T = 4, 2
    wgrads = []  # (case, a, b, a_map, b_map)
    for label, n, C, h, w, ws in F32_TRAIN_CASES + F32_HD32_CASES:
        TN, R, hidden = T * ws * ws, n * T * h * w, 4 * C
        shift = ws // 2
        scale = (C // heads) ** -0.5
        x, g = randn(n, T, h, w, C), randn(n, T, h, w, C)
        wq, bq = uniform(3 * C, C, fan_in=C, gain=3.0), uniform(3 * C,
                                                               fan_in=C)
        wp, bp = uniform(C, C, fan_in=C, gain=2.0), uniform(C, fan_in=C)
        bias = randn(heads, TN, TN)
        mask = torch.from_numpy(shifted_window_attention_mask(
            h, w, ws, shift)).repeat(1, T, T).to(dev)
        with torch.no_grad():
            _, qkv, attn = att._forward_f32(x, wq, bq, wp, bp, bias, mask,
                                            heads, scale, ws, shift)
            bx, bwq, bwp = (t.to(bf16) for t in (x, wq, wp))
            _, bqkv_s, battn = att._forward_kernel(bx, bwq, bq, bwp, bp,
                                                   bias, mask, heads, scale,
                                                   ws, shift)
        bg = g.to(bf16)
        kargs = (x, g, qkv, attn, wq, wp, bias, mask, heads, scale, ws,
                 shift)

        def k5_twin(dtype, a=(x, wq, bq, wp, bp, bias, mask, g)):
            a = cast(a, dtype)
            return att.swin_block_attention_bwd_ref(*a[:7], a[7], heads,
                                                    scale, ws, shift)

        def k5_products(x=x, g=g, wq=wq, wp=wp, qkv=qkv, attn=attn):
            xr, gr = x.reshape(R, C), g.reshape(R, C)
            gr @ wp, qkv @ wq, qkv.t() @ xr, gr.t() @ attn

        hold("swin_block_attention_bwd_f32",
             f"{label} {tuple(x.shape)} shift={shift}",
             att.swin_block_attention_bwd_f32,
             ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias"),
             lambda a=kargs: att.swin_block_attention_bwd_f32(*a), k5_twin,
             lambda: att.swin_block_attention_bwd(
                 bx, bg, bqkv_s, battn, bwq, bwp, bias, mask, heads, scale,
                 ws, shift),
             k5_products,
             (16 * R * C * C + 10 * R * TN * C,
              (7 * R * C + 4 * C * C + 4 * C + 2 * heads * TN * TN
               + mask.numel()) * 4),
             exempt=("dbproj",))
        if (label, n, C, h, w, ws) in F32_HD32_CASES:
            del x, g, qkv, attn, bqkv_s, battn, bx, bg
            torch.cuda.empty_cache()
            continue
        # random operands: qkv itself correlates with x, and the
        # correlated part of its sum hides a TF32 product's error
        if n == F32_TRAIN_B:
            wgrads += [(f"K5 dwqkv {label} ({R}, {3 * C})^T ({R}, {C}), "
                        "shifted gather", randn(R, 3 * C), x.reshape(R, C),
                        None, (T, h, w, ws, shift)),
                       (f"K5 dwproj {label} ({R}, {C})^T ({R}, {C}), "
                        "gather", g.reshape(R, C), attn, (T, h, w, ws, 0),
                        None)]
        del qkv, attn, bqkv_s, battn, bx, bg
        torch.cuda.empty_cache()

        p = [1.0 + randn(C, scale=0.1), randn(C, scale=0.1),
             uniform(hidden, C, fan_in=C, gain=2.0), uniform(hidden, fan_in=C),
             uniform(C, hidden, fan_in=hidden, gain=2.0), uniform(C, fan_in=hidden),
             1.0 + randn(C, scale=0.1), randn(C, scale=0.1)]
        bp_ = [t.to(bf16) if t.dim() == 2 else t for t in p]
        y = randn(n, T, h, w, C)
        xb, yb, gb = (t.to(bf16) for t in (x, y, g))
        kw = dict(gelu_exact=True, shift=shift, ws=ws)
        saved = epi.mlp_output_saved(C, hidden, f32)
        check(saved == (C == 1024), f"{label}: mlp_output_saved {saved}")
        rc, rh = R * C, R * hidden
        if saved:  # row 8
            def row8_twin(dtype):
                a = cast((x, y, *p), dtype)
                return epi.swin_block_epilogue_with_m_ref(*a, **kw)

            def fc_products():
                n2 = x.reshape(R, C)
                hh = n2 @ p[2].t()
                hh @ p[4].t()

            hold("swin_block_epilogue_f32", f"row 8 {label} "
                 f"{tuple(x.shape)} shift={shift}", epi.swin_block_epilogue_f32,
                 ("out", "m"), lambda: epi.swin_block_epilogue_f32(
                     x, y, *p, **kw, m_out=True), row8_twin,
                 lambda: epi._forward_kernel(xb, yb, *bp_, **kw, eps=1e-5,
                                             with_m=True),
                 fc_products, (4 * rc * hidden,
                               (4 * rc + 2 * C * hidden + hidden + 5 * C) * 4))
            with torch.no_grad():
                m = epi.swin_block_epilogue_f32(x, y, *p, **kw, m_out=True)[1]
                mb = epi._forward_kernel(xb, yb, *bp_, **kw, eps=1e-5,
                                         with_m=True)[1]
        else:
            m = mb = None
        row = "row 9" if saved else "row 7"

        def k6_twin(dtype):
            a = cast((x, y, *p, g), dtype)
            return epi.swin_block_epilogue_bwd_ref(*a, **kw)

        def k6_products(n_products=5 if saved else 6):
            xr, gr = x.reshape(R, C), g.reshape(R, C)
            hh = xr @ p[2].t()          # fc1
            if n_products == 6:
                hh @ p[4].t()           # m
            d = gr @ p[4]               # dh
            d @ p[2]                    # dn2
            d.t() @ xr, gr.t() @ hh     # dw1, dw2

        hold("swin_block_epilogue_bwd_f32",
             f"{row} {label} {tuple(x.shape)} shift={shift}",
             epi.swin_block_epilogue_bwd_f32,
             ("dx", "dy", "ds2", "db2", "dw1", "db1", "dw2", "dbw2", "ds1",
              "db1n"),
             lambda: epi.swin_block_epilogue_bwd_f32(x, y, g, m, *p[:7], **kw),
             k6_twin,
             lambda: epi.swin_block_epilogue_bwd(xb, yb, gb, mb, *bp_[:7],
                                                 **kw),
             k6_products,
             ((10 if saved else 12) * rc * hidden,
              ((6 if saved else 5) * rc + 4 * C * hidden + 2 * hidden
               + 8 * C) * 4),
             # db1n is a column sum of g; dbw2, of do, which a product
             # reaches only through LN1's statistics (the TF32 twin moves
             # it 1.3-1.8e-5)
             exempt=("db1n", "dbw2"))
        if not saved and n == F32_TRAIN_B:
            hh = torch.randn((R, hidden), generator=gen, device=dev)
            wgrads += [(f"K6 dw1 {label} ({R}, {hidden})^T ({R}, {C})", hh,
                        x.reshape(R, C), None, None)]
        del x, y, g, xb, yb, gb, m, mb
        torch.cuda.empty_cache()

    for case, a, b, a_map, b_map in wgrads:
        R, M = a.shape
        N = b.shape[1]
        got = gemm_ops.wgrad_f32(a, b, a_map, b_map)
        bit = torch.equal(got, gemm_ops.wgrad_f32(a, b, a_map, b_map))
        want = gemm_ops.wgrad_sm90_ref(a, b, a_map, b_map)
        with tf32_products():
            bad = gemm_ops.wgrad_sm90_ref(a, b, a_map, b_map)
        row = {"case": case, "max_abs_err": (got - want).abs().max().item(),
               "rel_err": rel_err(got, want),
               "tf32_fault": rel_err(bad, want), "bit_equal": bit,
               "ms": median_ms(lambda: gemm_ops.wgrad_f32(a, b, a_map,
                                                          b_map)),
               "plain_ms": median_ms(lambda: gemm_ops.wgrad_sm90_ref(
                   a, b, a_map, b_map)),
               "library_ms": median_ms(lambda: a.t() @ b),
               **f32_bound(2 * R * M * N, (R * (M + N) + M * N) * 4)}
        results.setdefault("wgrad_f32", []).append(row)
        rates = rate_line(row, 2 * R * M * N)
        print(f"  {'wgrad_f32':28s} {case:52s} rel {row['rel_err']:.3e} "
              f"bit-equal {bit} {row['ms']:.3f} ms a.t() @ b "
              f"{row['library_ms']:.3f} ms twin {row['plain_ms']:.3f} ms "
              f"bound {row['bound_ms']:.3f} ms; TF32 fault "
              f"{row['tf32_fault']:.3e}", flush=True)
        print(f"  {'':28s} {rates}", flush=True)
        check(row["rel_err"] <= TOL_F32_REL, f"wgrad_f32 {case}: relative "
              f"error {row['rel_err']} > {TOL_F32_REL}")
        check(row["tf32_fault"] > 10 * TOL_F32_REL, f"wgrad_f32 {case}: the "
              f"TF32 twin moves by only {row['tf32_fault']}")
        check(bit, f"wgrad_f32 {case}: two calls differ")


def attn_bwd_tf32(qkv, dattn, bias, mask, heads, scale, TN):
    """The planted fault of K5 fp32's attention backward alone: the twin's
    formulas (S = q k^T, P, dP = dO v^T, D = sum dP P, dS = P (dP - D), dq
    = dS k, dk = dS^T q, dv = P^T dO, dbias the sum of dS over windows)
    with every product's operands read as TF32 (`tf32`), a form that ran
    its products in one TF32 pass. The operands are rounded here, not by
    allowing cuBLAS TF32: it runs the small batched products of TN 32 x
    hd 32 in fp32 even then. Returns (dqkv, dbias) as
    `attn_bwd_f32_ref`."""
    import torch
    rows, C3 = qkv.shape
    C = C3 // 3
    hd, Bw = C // heads, rows // TN
    q, k, v = (qkv.reshape(Bw, TN, 3, heads, hd).permute(2, 0, 3, 1, 4)
               .unbind(0))
    do = dattn.reshape(Bw, TN, heads, hd).permute(0, 2, 1, 3)

    def mm(a, b):
        return tf32(a) @ tf32(b)
    s = mm(q, k.transpose(-1, -2)) * scale + bias[None]
    if mask is not None and mask.shape[0] > 1:
        nW = mask.shape[0]
        s = (s.reshape(Bw // nW, nW, heads, TN, TN)
             + mask[None, :, None]).reshape(Bw, heads, TN, TN)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e * (1.0 / e.sum(dim=-1, keepdim=True))
    dp = mm(do, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    grads = (mm(ds, k) * scale, mm(ds.transpose(-1, -2), q) * scale,
             mm(p.transpose(-1, -2), do))
    dqkv = torch.stack(grads, 0).permute(1, 3, 0, 2, 4).reshape(rows, C3)
    return dqkv, ds.sum(dim=0)


def sdpa_bwd_yardstick(qkv, dattn, bias, mask, heads, scale, TN):
    """The library yardstick of K5 fp32's attention backward: the backward
    alone (a retained graph) of fp32 `F.scaled_dot_product_attention` on
    PyTorch's memory-efficient backend, q, k, v (windows, heads, TN, hd)
    and attn_mask = bias (+ the window's mask) broadcast to (windows,
    heads, TN, TN), all four requiring grad. Returns the call, or the
    reason the backend refuses it."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    rows, C3 = qkv.shape
    C = C3 // 3
    hd, Bw = C // heads, rows // TN
    q, k, v = (t.contiguous().requires_grad_() for t in
               qkv.detach().reshape(Bw, TN, 3, heads, hd)
               .permute(2, 0, 3, 1, 4).unbind(0))
    am = bias[None].expand(Bw, heads, TN, TN)
    if mask is not None and mask.shape[0] > 1:
        am = am + mask[torch.arange(Bw, device=mask.device)
                       % mask.shape[0]][:, None]
    am = am.to(qkv.dtype).contiguous().requires_grad_()
    do = dattn.reshape(Bw, TN, heads, hd).permute(0, 2, 1, 3).contiguous()
    try:
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=am,
                                                 scale=scale)
            torch.autograd.grad(out, (q, k, v, am), do, retain_graph=True)
    except RuntimeError as e:
        return f"refused: {str(e).splitlines()[0][:160]}"

    def call():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return torch.autograd.grad(out, (q, k, v, am), do,
                                       retain_graph=True)
    return call


def phase_fp32_attn_bwd(dev, results, median_ms) -> None:
    """Phase 7 (a): K5 fp32's attention backward alone
    (`ops.block_attention.attn_bwd_f32`, the passes between dattn and dx)
    at every case of F32_TRAIN_CASES and F32_HD32_CASES, on K1 fp32's
    window-order qkv and dattn = the window-gathered g @ wproj, as K5
    forms them: dq, dk, dv and dbias within TOL_F32_REL of the twin
    (`attn_bwd_f32_ref`, TF32 off), the twin on TF32 operands
    (`attn_bwd_tf32`) missing the bound tenfold, bit-equal call to call,
    one launch of the helper a call
    and none of K5. Timed beside K5's fp32 form on the same inputs, the
    twin and the library yardstick (`sdpa_bwd_yardstick`, its kernel
    named); the bound: 5 products of 2 TN^2 hd a (window, head) over the
    3xTF32 rate, or each input read and each output written once."""
    import torch
    from stswincl_tpu_torch.ops import block_attention as att
    from stswincl_tpu_torch.ops.gemm import window_rows
    from stswincl_tpu_torch.ops.window import shifted_window_attention_mask

    gen = torch.Generator(device=dev).manual_seed(21)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def uniform(*shape, fan_in, gain=1.0):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1)
                * gain * fan_in ** -0.5)

    heads, T = 4, 2
    for label, n, C, h, w, ws in F32_TRAIN_CASES + F32_HD32_CASES:
        TN, R, shift = T * ws * ws, n * T * h * w, ws // 2
        hd, scale = C // heads, (C // heads) ** -0.5
        x, g = randn(n, T, h, w, C), randn(n, T, h, w, C)
        wq, bq = uniform(3 * C, C, fan_in=C, gain=3.0), uniform(3 * C,
                                                               fan_in=C)
        wp, bp = uniform(C, C, fan_in=C, gain=2.0), uniform(C, fan_in=C)
        bias = randn(heads, TN, TN)
        mask = torch.from_numpy(shifted_window_attention_mask(
            h, w, ws, shift)).repeat(1, T, T).to(dev)
        with torch.no_grad():
            _, qkv, attn = att._forward_f32(x, wq, bq, wp, bp, bias, mask,
                                            heads, scale, ws, shift)
            dattn = g.reshape(R, C)[window_rows(R, (T, h, w, ws, 0),
                                                dev)] @ wp
        case = f"{label} TN {TN} hd {hd} ({R}, {C}) shift={shift}"
        args = (qkv, dattn, bias, mask, heads, scale, TN)
        n0, k5 = att.attn_bwd_f32.launches, att.swin_block_attention_bwd_f32
        k0 = k5.launches
        got = att.attn_bwd_f32(*args)
        again = att.attn_bwd_f32(*args)
        torch.cuda.synchronize()
        check(att.attn_bwd_f32.launches == n0 + 2 and k5.launches == k0,
              f"attn_bwd_f32 {case}: {att.attn_bwd_f32.launches - n0} "
              f"launches of the helper and {k5.launches - k0} of K5 in two "
              "calls")
        bit = all(torch.equal(a, b) for a, b in zip(got, again))
        check(bit, f"attn_bwd_f32 {case}: two calls on the same inputs "
              "differ")
        del again
        want = att.attn_bwd_f32_ref(*args)
        bad = attn_bwd_tf32(*args)

        def outputs(r):
            return {"dq": r[0][:, :C], "dk": r[0][:, C:2 * C],
                    "dv": r[0][:, 2 * C:], "dbias": r[1]}
        outs, worst = {}, 0.0
        for name, a in outputs(got).items():
            wt, bd = outputs(want)[name], outputs(bad)[name]
            rel, moved = rel_err(a, wt), rel_err(bd, wt)
            outs[name] = {"rel_err": rel, "tf32_fault": moved,
                          "max_abs_err": (a - wt).abs().max().item()}
            worst = max(worst, rel / TOL_F32_REL)
            check(rel <= TOL_F32_REL, f"attn_bwd_f32 {case} {name}: "
                  f"relative error {rel} > {TOL_F32_REL}")
            check(moved > 10 * TOL_F32_REL, f"attn_bwd_f32 {case} {name}: "
                  f"the twin on TF32 operands moves by only {moved}")
        del got, want, bad
        torch.cuda.empty_cache()
        lib = sdpa_bwd_yardstick(*args)
        k5_args = (x, g, qkv, attn, wq, wp, bias, mask, heads, scale, ws,
                   shift)
        row = {"case": case, "outputs": outs, "bit_equal": bit,
               "max_abs_err": max(o["max_abs_err"] for o in outs.values()),
               "rel_err": max(o["rel_err"] for o in outs.values()),
               "ms": median_ms(lambda: att.attn_bwd_f32(*args), reps=10),
               "k5_ms": median_ms(lambda: k5(*k5_args), reps=5),
               "plain_ms": median_ms(lambda: att.attn_bwd_f32_ref(*args),
                                     reps=3),
               "library_ms": None if isinstance(lib, str)
               else median_ms(lib, reps=5),
               "library_kernel": lib if isinstance(lib, str)
               else top_cuda_kernel(lib),
               **f32_bound(10 * R * TN * C,
                           (7 * R * C + 2 * heads * TN * TN + mask.numel())
                           * 4)}
        results.setdefault("attn_bwd_f32", []).append(row)
        print(f"  {'attn_bwd_f32':28s} {case:52s} worst rel / bound "
              f"{worst:.3f}, bit-equal {bit}; {row['ms']:.3f} ms (K5 fp32 "
              f"{row['k5_ms']:.2f} ms) twin {row['plain_ms']:.2f} ms "
              f"bound {row['bound_ms']:.3f} ms ({row['bound_by']}; "
              f"{row['bound_ms'] / row['ms']:.3f} of it) SDPA backward "
              + (f"{row['library_ms']:.3f} ms" if row["library_ms"]
                 is not None else "none")
              + f" [{row['library_kernel']}]", flush=True)
        print(f"  {'':28s} {rate_line(row, 10 * R * TN * C)}", flush=True)
        for name, o in outs.items():
            print(f"  {'':28s} {name:8s} rel {o['rel_err']:.3e} TF32 fault "
                  f"{o['tf32_fault']:.3e} "
                  f"({o['tf32_fault'] / TOL_F32_REL:.1f}x the bound)",
                  flush=True)
        del x, g, qkv, attn, dattn, lib, args, k5_args
        torch.cuda.empty_cache()


# (a) the fp32 forms of the rows on no model path, at phase 2e's shapes:
# row 12 (and row 13 on the same x) at the batch-8 block shapes, rows 14
# and 15 at the layer-norm profiler's and, for row 15, at C 100 (a block a
# row, scalar) and C 3072 (a block a row, 16-byte loads); row 17 at phase
# 2e's seven conv cases
F32_MLP_CASES = ((163840, 512, True), (163840, 512, False),
                 (40960, 1024, True))
F32_ADD_LN_CASES = ((163840, 512, True), (163840, 512, False),
                    (40960, 1024, True), (40960, 1024, False))
F32_LN_CASES = ((163840, 512), (40960, 1024), (40960, 2048), (40960, 100),
                (40960, 3072))
F32_CONV_CASES = (
    ("layer5 512->512 d4 N4 res", 4, 64, 80, 512, 512, 4, True),
    ("layer4 256->256 d2 N32", 32, 64, 80, 256, 256, 2, False),
    ("layer1 64->64 d1 N4 res", 4, 128, 160, 64, 64, 1, True),
    ("ASPP 1024->512 d12 N2 32x40", 2, 32, 40, 1024, 512, 12, False),
    ("ASPP 1024->512 d18 N2 32x40", 2, 32, 40, 1024, 512, 18, False),
    ("ASPP 1024->512 d12 N2 64x80", 2, 64, 80, 1024, 512, 12, False),
    ("ASPP 1024->512 d18 N2 64x80", 2, 64, 80, 1024, 512, 18, False))


def phase_fp32_offpath_kernels(dev, results, median_ms, wrappers) -> None:
    """Phase 7 (a), the rows on no model path: the fp32 forms of rows 12
    (the MLP), 13 (add + LN + MLP), 14 (add + LN), 15 (LN) and 17 (the
    dilated conv + BN + residual + ReLU) through their public wrappers on
    fp32 tensors, TF32 off, each against its fp32 twin on every output
    within TOL_F32_REL; bit-equal across two calls; one launch of the form
    a call, no bf16 kernel, and the library's GEMM forms exactly two fp32
    GEMM launches a row 12 or 13 call and one "conv_f32" a row 17 call;
    a planted fault that must miss the bound tenfold (rows 12, 13 and 17:
    the twin on TF32 products or operands; row 14: the twin with y dropped;
    row 15: the twin without its bias). Timed (CUDA-event medians) beside
    the twin, the bf16 kernel on the same values in bf16 and the library:
    one call for rows 15 (`F.layer_norm`) and 17 (cuDNN's channels_last
    fp32 conv with the BN folded in, `cudnn_conv_bn_act`); PyTorch's chain
    of calls for rows 12 (F.linear -> F.gelu -> F.linear), 13 (the add,
    F.layer_norm and that chain) and 14 (the add and F.layer_norm),
    recorded as yardsticks, not as one library call. Row 17's k tiles
    summed, as the kernel counts them on the card (`ops.conv.
    k_tiles_summed`), must be those not wholly in the padding (`ops.conv.
    live_k_tiles`). Each case's tensors are freed before the next."""
    import torch
    import torch.nn.functional as F
    from stswincl_tpu_torch.ops import add_layernorm as aln
    from stswincl_tpu_torch.ops import add_ln_mlp as epi
    from stswincl_tpu_torch.ops import conv as conv_ops
    from stswincl_tpu_torch.ops import gemm as gemm_ops
    from stswincl_tpu_torch.ops import layernorm as ln_ops
    from stswincl_tpu_torch.ops import mlp as mlp_ops
    from stswincl_tpu_torch.tools.profile_conv_kernel import (
        cudnn_conv_bn_act)

    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32,
          "phase 7 (a): the fp32 twins must run with TF32 off")
    gen = torch.Generator(device=dev).manual_seed(19)
    bf16 = torch.bfloat16
    bf16_rows = [k for k in wrappers if not k.endswith("_f32")]

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def uniform(*shape, fan_in, gain=1.0):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1)
                * gain * fan_in ** -0.5)

    def outs(v):
        return tuple(t for t in (v if isinstance(v, tuple) else (v,))
                     if t is not None)

    def hold(kname, case, kfn, twin, fault, bfn, work, lib=None,
             yardstick=None, forms=None):
        """kfn() the form through its wrapper, twin() and fault() its
        fp32 twin and the twin with the planted fault, bfn() the bf16
        kernel, lib() one library call, yardstick (name, fn) a chain of
        library calls."""
        form = wrappers[kname]
        before = {k: wrappers[k].launches for k in bf16_rows}
        n = form.launches
        gemm_ops.launch_counts(reset=True)
        got = outs(kfn())
        torch.cuda.synchronize()
        counted = gemm_ops.launch_counts()
        check(counted == dict.fromkeys(gemm_ops.FORMS, 0) | (forms or {}),
              f"{kname} {case}: GEMM launches {counted}, expected "
              f"{forms or {}}")
        again = outs(kfn())
        torch.cuda.synchronize()
        bit = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        check(form.launches == n + 2, f"{kname} {case}: "
              f"{form.launches - n} launches of the form in two calls")
        moved_bf16 = {k: wrappers[k].launches - v for k, v in before.items()
                      if wrappers[k].launches != v}
        check(not moved_bf16, f"{kname} {case}: bf16 kernels launched "
              f"{moved_bf16}")
        want = outs(twin())
        bad = outs(fault[1]())
        errs = [(rel_err(a, w), (a - w).abs().max().item())
                for a, w in zip(got, want)]
        moved = max(rel_err(b, w) for b, w in zip(bad, want))
        check(all(a.dtype == torch.float32 and a.shape == w.shape
                  for a, w in zip(got, want)) and len(got) == len(want),
              f"{kname} {case}: outputs {[tuple(a.shape) for a in got]}")
        del got, want, bad
        torch.cuda.empty_cache()
        row = {"case": case, "rel_err": max(e[0] for e in errs),
               "max_abs_err": max(e[1] for e in errs), "bit_equal": bit,
               "faults": {fault[0]: moved},
               "ms": median_ms(kfn), "plain_ms": median_ms(twin),
               "bf16_ms": median_ms(bfn),
               "library_ms": None if lib is None else median_ms(lib),
               **f32_bound(*work)}
        if yardstick is not None:
            row[yardstick[0]] = median_ms(yardstick[1])
        results.setdefault(kname, []).append(row)
        extra = ("" if lib is None else f" library {row['library_ms']:.3f}"
                 " ms") + ("" if yardstick is None else
                           f" {yardstick[0]} {row[yardstick[0]]:.3f}")
        print(f"  {kname:22s} {case:34s} rel {row['rel_err']:.3e} max_abs "
              f"{row['max_abs_err']:.3e} bit-equal {bit}; fp32 form "
              f"{row['ms']:.3f} ms twin {row['plain_ms']:.3f} bf16 kernel "
              f"{row['bf16_ms']:.3f}{extra} bound {row['bound_ms']:.4f} ms "
              f"(FMA {row['fma_bound_ms']:.4f}); the twin {fault[0]} moves "
              f"by {moved:.3e} ({moved / TOL_F32_REL:.1f}x the bound)",
              flush=True)
        print(f"  {'':22s} {case:34s} {rate_line(row, work[0])}",
              flush=True)
        check(row["rel_err"] <= TOL_F32_REL, f"{kname} {case}: relative "
              f"error {row['rel_err']} > {TOL_F32_REL}")
        check(bit, f"{kname} {case}: two calls on the same inputs differ")
        check(moved > 10 * TOL_F32_REL, f"{kname} {case}: the twin "
              f"{fault[0]} moves the outputs by only {moved}")

    with torch.inference_mode():
        # rows 12 and 13: the MLP's weights at gain 2 (its branch as large
        # as x), LN's scale and shift drawn away from 1 and 0
        for R, C, exact in F32_MLP_CASES:
            hidden = 4 * C
            x, y = randn(R, C), randn(R, C)
            p = (uniform(hidden, C, fan_in=C, gain=2.0),
                 uniform(hidden, fan_in=C),
                 uniform(C, hidden, fan_in=hidden, gain=2.0),
                 uniform(C, fan_in=hidden))
            ln = (1.0 + randn(C, scale=0.1), randn(C, scale=0.1))
            pb = (p[0].to(bf16), p[1], p[2].to(bf16), p[3])
            xb, yb = x.to(bf16), y.to(bf16)
            case = f"({R}, {C}) -> {hidden} {'erf' if exact else 'tanh'}"
            approx = "none" if exact else "tanh"
            mlp_work = (4 * R * C * hidden,
                        (2 * R * C + 2 * C * hidden + hidden + C) * 4)

            def chain(v):
                return F.linear(F.gelu(F.linear(v, p[0], p[1]),
                                       approximate=approx), p[2], p[3])

            def mlp_tf32():
                with tf32_products():
                    return mlp_ops.mlp_ref(x, *p, exact)
            hold("fused_mlp_f32", case,
                 lambda: mlp_ops.fused_mlp(x, *p, exact),
                 lambda: mlp_ops.mlp_ref(x, *p, exact),
                 ("on TF32 products", mlp_tf32),
                 lambda: mlp_ops.fused_mlp(xb, *pb, exact), mlp_work,
                 yardstick=("linear_gelu_linear_ms", lambda: chain(x)),
                 forms={"fp32": 2})

            def add_ln_tf32():
                with tf32_products():
                    return epi.add_ln_mlp_ref(x, y, *ln, *p, exact)
            hold("add_ln_mlp_f32", case,
                 lambda: epi.add_ln_mlp(x, y, *ln, *p, exact),
                 lambda: epi.add_ln_mlp_ref(x, y, *ln, *p, exact),
                 ("on TF32 products", add_ln_tf32),
                 lambda: epi.add_ln_mlp(xb, yb, *ln, *pb, exact),
                 (mlp_work[0], mlp_work[1] + (2 * R * C + 2 * C) * 4),
                 yardstick=("add_layer_norm_mlp_ms", lambda: chain(
                     F.layer_norm(x + y, (C,), *ln, 1e-5))),
                 forms={"fp32": 2})
            del x, y, xb, yb, p, pb
            torch.cuda.empty_cache()

        # row 14, with and without the sum; its fault: y dropped
        for R, C, with_sum in F32_ADD_LN_CASES:
            x, y = randn(R, C), randn(R, C)
            scale, shift = 1.0 + randn(C, scale=0.5), randn(C, scale=0.5)
            xb, yb = x.to(bf16), y.to(bf16)
            kw = dict(return_sum=with_sum)
            hold("add_layer_norm_f32",
                 f"({R}, {C}) {'with' if with_sum else 'without'} the sum",
                 lambda: aln.add_layer_norm(x, y, scale, shift, **kw),
                 lambda: aln.add_layer_norm_ref(x, y, scale, shift, **kw),
                 ("with y dropped", lambda: aln.add_layer_norm_ref(
                     x, torch.zeros_like(y), scale, shift, **kw)),
                 lambda: aln.add_layer_norm(xb, yb, scale, shift, **kw),
                 (10 * R * C, ((4 if with_sum else 3) * R * C + 2 * C) * 4),
                 yardstick=("add_then_layer_norm_ms", lambda: F.layer_norm(
                     x + y, (C,), scale, shift, 1e-5)))
            del x, y, xb, yb
            torch.cuda.empty_cache()

        # row 15; its fault: the bias dropped
        for R, C in F32_LN_CASES:
            x = randn(R, C)
            scale, shift = 1.0 + randn(C, scale=0.5), randn(C, scale=0.5)
            xb = x.to(bf16)
            hold("fused_layer_norm_f32", f"({R}, {C})",
                 lambda: ln_ops.fused_layer_norm(x, scale, shift),
                 lambda: ln_ops.layer_norm_ref(x, scale, shift),
                 ("without its bias", lambda: ln_ops.layer_norm_ref(
                     x, scale, torch.zeros_like(shift))),
                 lambda: ln_ops.fused_layer_norm(xb, scale, shift),
                 (8 * R * C, (2 * R * C + 2 * C) * 4),
                 lib=lambda: F.layer_norm(x, (C,), scale, shift, 1e-5))
            del x, xb
            torch.cuda.empty_cache()

        # row 17; its fault: x and w rounded to TF32 (what one TF32 pass
        # of the product reads)
        for name, N, Hc, Wc, cin, cout, d, with_res in F32_CONV_CASES:
            x = randn(N, Hc, Wc, cin)
            w = randn(cout, cin, 3, 3, scale=(9 * cin) ** -0.5)
            scale = 0.5 + torch.rand(cout, generator=gen, device=dev)
            shift = randn(cout, scale=0.5)
            res = randn(N, Hc, Wc, cout) if with_res else None
            kw = dict(dilation=d, relu=True, residual=res)
            xb, wb = x.to(bf16), w.to(bf16)
            kwb = dict(kw, residual=None if res is None else res.to(bf16))
            hold("conv3x3_bn_act_f32", name,
                 lambda: conv_ops.conv3x3_bn_act(x, w, scale, shift, **kw),
                 lambda: conv_ops.conv3x3_bn_act_ref(x, w, scale, shift,
                                                     **kw),
                 ("on TF32 operands", lambda: conv_ops.conv3x3_bn_act_ref(
                     tf32(x), tf32(w), scale, shift, **kw)),
                 lambda: conv_ops.conv3x3_bn_act(xb, wb, scale, shift,
                                                 **kwb),
                 (2 * N * Hc * Wc * 9 * cin * cout,
                  (N * Hc * Wc * (cin + cout * (2 if with_res else 1))
                   + 9 * cin * cout + 2 * cout) * 4),
                 lib=lambda: cudnn_conv_bn_act(x, w, scale, shift, d,
                                               residual=res),
                 forms={"conv_f32": 1})
            # the k tiles the kernel summed in one more call, read back
            # from the card, against those not wholly in the padding
            conv_ops.k_tiles_summed(dev, reset=True)
            conv_ops.conv3x3_bn_act(x, w, scale, shift, **kw)
            summed = conv_ops.k_tiles_summed(dev, reset=True)
            col_tiles = -(-cout // 128)
            live = conv_ops.live_k_tiles(N, Hc, Wc, cin, d)
            row = results["conv3x3_bn_act_f32"][-1]
            row["k_tiles"] = live.numel() * col_tiles
            row["k_tiles_skipped"] = row["k_tiles"] - summed
            padding = int((~live).sum()) * col_tiles
            print(f"  {'':22s} {name:34s} k tiles skipped "
                  f"{row['k_tiles_skipped']} of {row['k_tiles']} "
                  f"({row['k_tiles_skipped'] / row['k_tiles']:.3f}), counted"
                  f" by the kernel; wholly in the padding {padding}",
                  flush=True)
            check(row["k_tiles_skipped"] == padding, f"conv3x3_bn_act_f32 "
                  f"{name}: the kernel skipped {row['k_tiles_skipped']} k "
                  f"tiles, {padding} lie wholly in the padding")
            del x, w, res, xb, wb, kwb
            torch.cuda.empty_cache()


def phase_fp32_entry_points(dev, wrappers, launches) -> None:
    """Phase 7 (h): the entry points of rows 12-15 and 17 on fp32 CUDA
    tensors, with every launch count set to 0 first: the `Mlp(dtype=
    float32)` and `FusedLayerNorm` modules (`kernels=None`) at the stage-1
    serving clip's width, and the public wrappers `add_ln_mlp`,
    `add_layer_norm` and `conv3x3_bn_act` (the ASPP's d 12 branch); each
    call launches its fp32 form exactly once, no bf16 kernel, the fp32
    GEMM twice a row 12 or 13 call and "conv_f32" once a row 17 call, and
    each output is within TOL_F32_REL of its plain route (`kernels=False`,
    or the twin)."""
    import torch
    from stswincl_tpu_torch.models.init import init_weights
    from stswincl_tpu_torch.models.swin import Mlp
    from stswincl_tpu_torch.ops import add_layernorm as aln
    from stswincl_tpu_torch.ops import add_ln_mlp as epi
    from stswincl_tpu_torch.ops import conv as conv_ops
    from stswincl_tpu_torch.ops.layernorm import FusedLayerNorm

    gen = torch.Generator(device=dev).manual_seed(23)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    C = 512
    mlp = init_weights(Mlp(C, 4 * C, C), torch.Generator().manual_seed(0))
    mlp_plain = Mlp(C, 4 * C, C, kernels=False)
    mlp_plain.load_state_dict(mlp.state_dict())
    ln = FusedLayerNorm(C)
    with torch.no_grad():
        ln.weight.add_(0.5 * torch.randn(C, generator=torch.Generator()
                                         .manual_seed(1)))
        ln.bias.add_(0.5 * torch.randn(C, generator=torch.Generator()
                                       .manual_seed(2)))
    ln_plain = FusedLayerNorm(C, kernels=False)
    ln_plain.load_state_dict(ln.state_dict())
    for m in (mlp, mlp_plain, ln, ln_plain):
        m.to(dev)
    x = randn(2 * BS, 2, 64, 80, C)  # the stage-1 serving clip's blocks
    y = randn(*x.shape)
    v = (1.0 + randn(C, scale=0.1), randn(C, scale=0.1))
    w12 = [t.detach() for t in (mlp.fc1.weight, mlp.fc1.bias,
                                mlp.fc2.weight, mlp.fc2.bias)]
    xc = randn(2, 32, 40, 1024)
    wc = randn(512, 1024, 3, 3, scale=(9 * 1024) ** -0.5)
    sc, sh = 0.5 + randn(512).abs(), randn(512, scale=0.5)
    calls = (
        ("fused_mlp_f32", lambda: mlp(x), lambda: mlp_plain(x)),
        ("fused_layer_norm_f32", lambda: ln(x), lambda: ln_plain(x)),
        ("add_ln_mlp_f32", lambda: epi.add_ln_mlp(x, y, *v, *w12),
         lambda: epi.add_ln_mlp_ref(x, y, *v, *w12)),
        ("add_layer_norm_f32", lambda: aln.add_layer_norm(x, y, *v),
         lambda: aln.add_layer_norm_ref(x, y, *v)),
        ("conv3x3_bn_act_f32", lambda: conv_ops.conv3x3_bn_act(
            xc, wc, sc, sh, dilation=12),
         lambda: conv_ops.conv3x3_bn_act_ref(xc, wc, sc, sh, dilation=12)))
    reset_launches(wrappers)
    errs = {}
    with torch.no_grad():
        for kname, call, plain in calls:
            got = call()
            got = got if isinstance(got, tuple) else (got,)
            want = plain()
            want = want if isinstance(want, tuple) else (want,)
            errs[kname] = max(rel_err(a, b) for a, b in zip(got, want))
            del got, want
    torch.cuda.synchronize()
    counts, forms = read_launches(wrappers)
    launches["fp32_entry_points"] = counts
    print(f"  [fp32 entry points] launches "
          f"{ {k: n for k, n in counts.items() if n} }; rel err against the "
          f"plain routes {errs}", flush=True)
    check_gemm_launches("fp32 entry points", counts, forms, m_saved=0)
    for k, n in counts.items():
        if k in GEMM_ROWS:
            continue
        want = 1 if k in errs else 0
        check(n == want, f"fp32 entry points: {k} launched {n} times, "
              f"expected {want}")
    for k, e in errs.items():
        check(e <= TOL_F32_REL, f"fp32 entry points: {k} relative error "
              f"{e} > {TOL_F32_REL}")
    del x, y, xc, wc
    torch.cuda.empty_cache()


# (i) the fp32 stage-1 step of `swin_dim` 128 (hd 32 at stage 1, hd 64 at
# stage 2, K5's fp32 form on both), depths (1, 1): one W-MSA / SW-MSA pair
# a stage
F32_HD32_KW = dict(swin_dim=128, swin_depths=(1, 1))


def phase_fp32_hd32_train(dev, wrappers, launches) -> None:
    """Phase 7 (i): one fp32 stage-1 step of `ModelConfig(swin_dim=128,
    swin_depths=(1, 1))` at batch 2 from seeded weights on phase 7 (d)'s
    batch, through `fp32_step_gate` (its planted K5 fault among those it
    holds): K5's fp32 form trains the hd-32 blocks of stage 1. Launches
    exact: K1, K2, K5 and K6 in fp32 once a block call (hooks count the
    block calls and those at hd 32), K3 once, no bf16 kernel."""
    import torch
    from stswincl_tpu_torch.models import TswinPlus
    from stswincl_tpu_torch.models.init import init_weights
    from stswincl_tpu_torch.models.swin import SpaceTimeSwinBlock

    kw = dict(num_classes=12, input_hw=(H, W), **F32_HD32_KW)
    weights = init_weights(TswinPlus(**kw, dtype=torch.float32),
                           torch.Generator().manual_seed(3)).state_dict()
    imgs, lbls = seeded_batch(BS, seed=6)
    images = torch.from_numpy(imgs).to(dev)
    labels = torch.from_numpy(lbls).to(dev).long()
    tag = f"[fp32 train swin_dim 128] batch {BS}"
    step_of = fp32_seg_step_of(dev, weights, kw)
    hd_of_call = []
    hook = torch.nn.modules.module.register_module_forward_hook(
        lambda mod, i, o: hd_of_call.append(
            mod.norm1.weight.shape[0] // mod.num_heads)
        if isinstance(mod, SpaceTimeSwinBlock) else None)
    reset_launches(wrappers)
    try:
        loss_k, grads_k, sec_k = step_of(images, labels)
    finally:
        hook.remove()
    counts, forms = read_launches(wrappers)
    launches["train_fp32_swin128"] = counts
    blocks, at32 = len(hd_of_call), hd_of_call.count(32)
    print(f"  {tag}: kernel step {sec_k:.2f} s, {blocks} block calls "
          f"({at32} at hd 32), launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    check(at32 > 0 and blocks > at32, f"{tag}: {at32} of {blocks} block "
          "calls at hd 32")
    step = {"swin_block_attention_f32": blocks,
            "swin_block_epilogue_f32": blocks,
            "patch_merge_f32": FT_MERGES,
            "swin_block_attention_bwd_f32": blocks,
            "swin_block_epilogue_bwd_f32": blocks}
    fp32_step_launches(tag, counts, forms, step=step, recomputed=blocks)
    fp32_step_gate(tag, step_of, images, labels, loss_k, grads_k)
    del grads_k
    torch.cuda.empty_cache()


# (d) the batch-2 gate and (e) the stage-2 gate (`fp32_step_gate`): each
# gradient of the fp32 kernel step against the fp32 twin step
# (`kernels=False`) within F32_STEP_FACTOR times the larger deviation of
# two controls (the twin step on the clips perturbed by relative noise of
# 2^-22 and 2^-24, a few fp32 roundings: the step's own rounding
# sensitivity), plus F32_STEP_FLOOR; planted K5 and K6 faults and the twin
# step under bf16 autocast must each miss its bound tenfold on the loss or
# some gradient (`fp32_step_faults`). Then (d) F32_TRAIN_STEPS timed steps
# at batch F32_TRAIN_BATCH after a warm-up.
F32_STEP_FACTOR = 4.0
F32_STEP_FLOOR = 1e-6
F32_CONTROL_NOISE = (2.0 ** -22, 2.0 ** -24)
F32_TRAIN_BATCH, F32_TRAIN_STEPS = 8, 3
# a stage-1 step: the fp32 forms of K1, K2, K5 and K6 once a block call,
# K3 once; K2 saves m (row 8) and K6 takes it (row 9) at the FT_M_SAVED
# stage-2 blocks, K6 recomputes it (row 7) at the rest
F32_STEP = {"swin_block_attention_f32": FT_BLOCKS,
            "swin_block_epilogue_f32": FT_BLOCKS,
            "patch_merge_f32": FT_MERGES,
            "swin_block_attention_bwd_f32": FT_BLOCKS,
            "swin_block_epilogue_bwd_f32": FT_BLOCKS}


def fp32_step_launches(tag, counts, forms, steps=1, recomputed=None,
                       step=F32_STEP):
    """A path of `steps` fp32 stage-1 (or stage-2: pass `recomputed` 0)
    steps: exactly `step`'s launches a step (F32_STEP on 'pallas_full'),
    no other kernel (no twin runs a kernel, no bf16 form), and the fp32
    GEMMs the forms imply."""
    for k, n in counts.items():
        want = steps * step.get(k, 0)
        if k in ("linear_f32", "wgrad_f32"):
            continue
        check(n == want, f"{tag}: {k} launched {n} times, expected {want}")
    rec = steps * (FT_BLOCKS - FT_M_SAVED) if recomputed is None \
        else recomputed
    check_gemm_launches(tag, counts, forms, f32_recomputed=rec)


def fp32_step_faults(route: str = "pallas_full") -> list:
    """The planted faults of the fp32 step gates on `route`: (what, a
    context that plants it, the step's `kernels`, whether it is held).
    Held: K5 with its dbias zeroed (where K5 runs: not on 'pallas') and K6
    without its LN2 path (each form patched by
    `unittest.mock.patch.object`), and a precision fault, the twin step
    under bf16 autocast; on 'pallas' and `whole_block` also the route's
    own forward form with a fault of its own: row 10 without the SW-MSA
    mask, row 16 with its proj weight transposed (a layout slip; at init
    scales the relative bias, std 0.02, moves a step too little to plant
    its loss).
    Reported only: the twin step with every matmul on TF32, and K6 alone
    as its fp32 twin on TF32 products. The step moves its gradients by
    about 2e-3 under input noise of 2^-22 (the bounds' median is near
    7e-3), so TF32 rounding stays within a few bounds; (a) holds each
    form's precision against TF32."""
    import torch
    from stswincl_tpu_torch.ops import add_ln_mlp as epi
    from stswincl_tpu_torch.ops import block_attention as att
    from stswincl_tpu_torch.ops import swin_block as wb
    att_bwd = att.swin_block_attention_bwd_f32
    image_kernel, whole_kernel = att._image_kernel, wb._forward_kernel

    def row10_without_mask(qkv, bias, mask, *a):
        return image_kernel(qkv, bias, None, *a)

    def row16_proj_transposed(x, wqkv, bqkv, wproj, *a):
        return whole_kernel(x, wqkv, bqkv, wproj.t().contiguous(), *a)

    def k5_without_dbias(*a, **k):
        dx, dwq, dbq, dwp, dbp, dbias = att_bwd(*a, **k)
        return dx, dwq, dbq, dwp, dbp, torch.zeros_like(dbias)

    def k6_without_ln2_path(x, y, g, m, s2, b2, w1, b1, w2, bw2, s1, *a,
                            **k):
        return epilogue_bwd_without_ln2_path(
            x, y, s2, b2, w1, b1, w2, bw2, s1, torch.zeros_like(s1), g, *a,
            **k)

    def k6_twin_on_tf32(x, y, g, m, s2, b2, w1, b1, w2, bw2, s1, *a, **k):
        with tf32_products():
            return epi.swin_block_epilogue_bwd_ref(
                x, y, s2, b2, w1, b1, w2, bw2, s1, torch.zeros_like(s1), g,
                *a, **k)

    def patched(mod, name, fault):
        fault.launches = 0  # the form it wraps counts under its own name
        return lambda: unittest.mock.patch.object(mod, name, fault)

    own = {"pallas": [("row 10 without the mask", patched(
                    att, "_image_kernel", row10_without_mask), None, True)],
           "whole_block": [("row 16 with wproj transposed", patched(
                    wb, "_forward_kernel", row16_proj_transposed), None,
                    True)]}.get(route, [])
    k5 = [] if route == "pallas" else [("K5 without dbias", patched(
        att, "swin_block_attention_bwd_f32", k5_without_dbias), None, True)]
    return own + k5 + [
            ("K6 without its LN2 path", patched(
                epi, "swin_block_epilogue_bwd_f32", k6_without_ln2_path),
             None, True),
            ("the twin step with every matmul on TF32", tf32_products,
             False, False),
            ("the twin step under bf16 autocast", lambda: torch.autocast(
                "cuda", dtype=torch.bfloat16), False, True),
            ("K6 alone on TF32 products", patched(
                epi, "swin_block_epilogue_bwd_f32", k6_twin_on_tf32),
             None, False)]


def fp32_step_gate(tag, step_of, inputs, labels, loss_k, grads_k,
                   route="pallas_full") -> None:
    """The gate of an fp32 kernel step, its loss `loss_k` and gradients
    `grads_k` on `inputs`: `step_of(inputs, labels, kernels)` runs one step
    from fixed weights and returns (loss, gradients by name, seconds). The
    twin step (`kernels=False`) and two controls, the twin step on the
    inputs perturbed by relative noise of F32_CONTROL_NOISE (a few fp32
    roundings: the step's own rounding sensitivity); the loss and every
    gradient within F32_STEP_FACTOR times the controls' larger deviation
    plus F32_STEP_FLOOR; each held fault of `fp32_step_faults(route)` must
    miss the bound of the loss or of some gradient tenfold."""
    import torch

    def devs(a, b):
        return {n: rel_err(a[n], b[n]) for n in b}

    loss_t, grads_t, sec_t = step_of(inputs, labels, kernels=False)
    controls, control_losses = [], []
    gen = torch.Generator(device=inputs.device).manual_seed(17)
    for e in F32_CONTROL_NOISE:
        noisy = inputs * (1 + e * torch.randn(inputs.shape, generator=gen,
                                              device=inputs.device))
        loss_c, grads_c, _ = step_of(noisy, labels, kernels=False)
        controls.append(devs(grads_c, grads_t))
        control_losses.append(abs(loss_c - loss_t) / abs(loss_t))
        del grads_c, noisy
    got = devs(grads_k, grads_t)
    bound = {n: F32_STEP_FACTOR * max(c[n] for c in controls)
             + F32_STEP_FLOOR for n in grads_t}
    over = {n: (got[n], bound[n]) for n in got if got[n] > bound[n]}
    worst = max(got, key=lambda n: got[n] / bound[n])
    rel_loss = abs(loss_k - loss_t) / abs(loss_t)
    loss_bound = F32_STEP_FACTOR * max(control_losses) + F32_STEP_FLOOR
    bs = sorted(bound.values())
    print(f"  {tag} gate: loss kernels {loss_k:.7f} twin {loss_t:.7f} (rel "
          f"{rel_loss:.2e}, bound {loss_bound:.2e}); {len(got)} gradients, "
          f"worst rel / bound {got[worst] / bound[worst]:.3f} ({worst}), "
          f"largest rel {max(got.values()):.3e}, control rel (2^-22 / "
          f"2^-24) up to {max(controls[0].values()):.3e} / "
          f"{max(controls[1].values()):.3e}, gradient bounds' quartiles "
          f"{bs[len(bs) // 4]:.2e} / {bs[len(bs) // 2]:.2e} / "
          f"{bs[3 * len(bs) // 4]:.2e}; twin step {sec_t:.2f} s", flush=True)
    check(math.isfinite(loss_k), f"{tag}: loss {loss_k}")
    check(rel_loss <= loss_bound, f"{tag}: loss kernels {loss_k} vs twin "
          f"{loss_t}: rel {rel_loss} > {loss_bound}")
    check(not over, f"{tag}: gradients past their control bounds "
          f"{dict(list(over.items())[:5])}")
    for what, plant, kernels, held in fp32_step_faults(route):
        with plant():
            loss_f, grads_f, _ = step_of(inputs, labels, kernels=kernels)
        moved = {n: d / bound[n] for n, d in devs(grads_f, grads_t).items()}
        moved["loss"] = abs(loss_f - loss_t) / abs(loss_t) / loss_bound
        del grads_f
        top = max(moved, key=moved.get)
        print(f"  {tag} planted fault, {what}: misses its bound by "
              f"{moved[top]:.1f}x at most ({top}; the loss "
              f"{moved['loss']:.1f}x){'' if held else ', not held'}",
              flush=True)
        check(not held or moved[top] >= 10, f"{tag}: the planted fault "
              f"({what}) misses the gate by only {moved[top]}x")
    del grads_t, controls
    torch.cuda.empty_cache()


def fp32_seg_step_of(dev, weights, kw, **route):
    """step_of(images, labels, kernels=None): one stage-1 step of the fp32
    TswinPlus(**kw, **route) from `weights` (`route`: `attn_impl`,
    `whole_block`), `kernels` its kernel argument (False: the twin step);
    returns (loss, gradients by name, seconds)."""
    import torch
    from stswincl_tpu_torch.configs import (DataConfig, ModelConfig,
                                            SegTrainConfig)
    from stswincl_tpu_torch.models import TswinPlus
    from stswincl_tpu_torch.pipelines.seg import make_tx
    from stswincl_tpu_torch.train.train_seg import make_seg_train_step

    cfg = SegTrainConfig(model=ModelConfig(dtype="float32"),
                         data=DataConfig(batch_size=BS, crop_hw=(H, W)))

    def step_of(images, labels, kernels=None):
        m = TswinPlus(**kw, dtype=torch.float32, kernels=kernels, **route)
        m.load_state_dict(weights)
        m.to(dev).train()
        opt, schedule = make_tx(cfg, 1, m)
        step = make_seg_train_step(m, opt, schedule, cfg.loss,
                                   ohem_thresh=cfg.ohem_thresh)
        grads = {}
        opt.register_step_pre_hook(lambda *_: grads.update(
            {n: p.grad.detach().clone() for n, p in m.named_parameters()}))
        ts = time.perf_counter()
        loss = float(step(images, labels)["loss"])
        torch.cuda.synchronize()
        return loss, grads, time.perf_counter() - ts
    return step_of


# (g) a stage-1 step on each route: F32_STEP with the route's attention
# form; with `whole_block` row 16 takes the W-MSA block calls (counted by
# hooks) and their backward re-runs the fp32 K1 + K2 pair, so K1 and K2,
# like K5 and K6, run once a block call
F32_ROUTE_STEP = {
    "pallas": {"windowed_attention_image_f32": FT_BLOCKS,
               **{k: n for k, n in F32_STEP.items()
                  if k not in ("swin_block_attention_f32",
                               "swin_block_attention_bwd_f32")}},
    "whole_block": F32_STEP,
}


def phase_fp32_route_train(dev, wrappers, launches, weights, kw) -> None:
    """Phase 7 (g): one fp32 stage-1 step at batch 2 on 'pallas' and with
    `whole_block`, from phase 7 (b)'s weights on phase 7 (d)'s batch: the
    kernel step's launches exact (F32_ROUTE_STEP; row 16 once a W-MSA
    block call; no twin, no bf16 form), then `fp32_step_gate` against the
    route's twin step with the route's planted faults."""
    import torch
    from stswincl_tpu_torch.models.swin import SpaceTimeSwinBlock

    imgs, lbls = seeded_batch(BS, seed=6)
    images = torch.from_numpy(imgs).to(dev)
    labels = torch.from_numpy(lbls).to(dev).long()
    for route, rkw in (("pallas", dict(attn_impl="pallas")),
                       ("whole_block", dict(whole_block=True))):
        tag = f"[fp32 train {route}] batch {BS}"
        step_of = fp32_seg_step_of(dev, weights, kw, **rkw)
        w_calls = []

        def count_w(mod, inputs, _):
            w_calls.append(mod.shift_size == 0)
        hook = torch.nn.modules.module.register_module_forward_hook(
            lambda mod, i, o: count_w(mod, i, o)
            if isinstance(mod, SpaceTimeSwinBlock) else None)
        reset_launches(wrappers)
        try:
            loss_k, grads_k, sec_k = step_of(images, labels)
        finally:
            hook.remove()
        counts, forms = read_launches(wrappers)
        launches[f"train_fp32_{route}"] = counts
        want = dict(F32_ROUTE_STEP[route])
        if route == "whole_block":
            want["whole_swin_block_f32"] = sum(w_calls)
            check(0 < sum(w_calls) < len(w_calls), f"{tag}: "
                  f"{sum(w_calls)} W-MSA block calls of {len(w_calls)}")
        check(len(w_calls) == FT_BLOCKS, f"{tag}: {len(w_calls)} swin "
              f"block calls, expected {FT_BLOCKS}")
        print(f"  {tag}: kernel step {sec_k:.2f} s, launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
        fp32_step_launches(tag, counts, forms, step=want)
        fp32_step_gate(tag, step_of, images, labels, loss_k, grads_k,
                       route)
        del grads_k
        torch.cuda.empty_cache()


def phase_fp32_train(dev, smi, wrappers, launches, weights, kw) -> dict:
    """Phase 7 (d): stage-1 training of the fp32 model on the fp32 forms.
    The batch-2 gate (`fp32_step_gate`): the loss and every gradient of one
    kernel step against the twin step from the same weights and batch, the
    kernel step's launches (F32_STEP, no twin), and whether a second kernel
    step gives the same bits (reported, not held: cuDNN's convolution
    backward need not). Then the step at batch 8, ms/step and peak
    memory. Returns the launches a batch-8 step."""
    import torch
    from stswincl_tpu_torch.configs import (DataConfig, ModelConfig,
                                            SegTrainConfig)
    from stswincl_tpu_torch.models import TswinPlus
    from stswincl_tpu_torch.pipelines.seg import make_tx
    from stswincl_tpu_torch.train.train_seg import make_seg_train_step

    cfg = SegTrainConfig(model=ModelConfig(dtype="float32"),
                         data=DataConfig(batch_size=BS, crop_hw=(H, W)))
    step_of = fp32_seg_step_of(dev, weights, kw)
    imgs, lbls = seeded_batch(BS, seed=6)
    images = torch.from_numpy(imgs).to(dev)
    labels = torch.from_numpy(lbls).to(dev).long()
    reset_launches(wrappers)
    loss_k, grads_k, sec_k = step_of(images, labels)
    counts, forms = read_launches(wrappers)
    launches["train_fp32_gate"] = counts
    fp32_step_launches("fp32 train (batch 2)", counts, forms)

    def same(a, b):
        return a[0] == b[0] and all(torch.equal(a[1][n], b[1][n])
                                    for n in a[1])

    bit = same((loss_k, grads_k), step_of(images, labels))
    # whether the spread is PyTorch's and cuDNN's: the same with their
    # deterministic algorithms
    det = torch.are_deterministic_algorithms_enabled()
    cudnn_det = torch.backends.cudnn.deterministic
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            bit_det = same(step_of(images, labels), step_of(images, labels))
    finally:
        torch.use_deterministic_algorithms(det)
        torch.backends.cudnn.deterministic = cudnn_det
    print(f"  [fp32 train] batch {BS}: kernel step {sec_k:.2f} s (the first "
          f"kernel step in the process); a second kernel step bit-equal: "
          f"{bit}, two with PyTorch's deterministic algorithms and cuDNN "
          f"deterministic: {bit_det}", flush=True)
    check(math.isfinite(loss_k), f"fp32 train loss {loss_k}")
    fp32_step_gate(f"[fp32 train] batch {BS}", step_of, images, labels,
                   loss_k, grads_k)
    del grads_k
    torch.cuda.empty_cache()

    # batch 8 on the kernels
    imgs, lbls = seeded_batch(F32_TRAIN_BATCH, seed=7)
    images = torch.from_numpy(imgs).to(dev)
    labels = torch.from_numpy(lbls).to(dev).long()
    m = TswinPlus(**kw, dtype=torch.float32)
    m.load_state_dict(weights)
    m.to(dev).train()
    opt, schedule = make_tx(cfg, 1, m)
    step = make_seg_train_step(m, opt, schedule, cfg.loss,
                               ohem_thresh=cfg.ohem_thresh)
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step(images, labels)["loss"])]  # warm-up
    reset_launches(wrappers)
    secs = []
    for _ in range(F32_TRAIN_STEPS):
        ts = time.perf_counter()
        losses.append(float(step(images, labels)["loss"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - ts)
    counts, forms = read_launches(wrappers)
    launches["train_fp32"] = counts
    fp32_step_launches(f"fp32 train (batch {F32_TRAIN_BATCH})", counts,
                       forms, steps=F32_TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = 1e3 * statistics.median(secs)
    STEP_MS["fp32 stage 1"] = ms
    print(f"  [fp32 train] stage-1 step at batch {F32_TRAIN_BATCH} on the "
          f"fp32 forms: {ms:.1f} ms/step (median of {F32_TRAIN_STEPS} after"
          f" a warm-up), {F32_TRAIN_BATCH / ms * 1e3:.2f} clips/s, peak "
          f"{peak:.2f} GiB, losses {[round(v, 5) for v in losses]}, "
          f"launches a step { {k: v // F32_TRAIN_STEPS for k, v in counts.items() if v} } "
          f"on {smi}", flush=True)
    check(all(math.isfinite(v) for v in losses), f"fp32 train losses "
          f"{losses}")
    del m, opt, step
    torch.cuda.empty_cache()
    return {k: v // F32_TRAIN_STEPS for k, v in counts.items()}


def phase_fp32_contrast(dev, smi, wrappers, launches) -> dict:
    """Phase 7 (e): the stage-2 fp32 step at `ContrastTrainConfig`'s
    defaults (batch 4, six views of 4 frames at 256x448, swin_dim 512,
    depths (3, 3)) on the fp32 forms. The gate (`fp32_step_gate`): the
    loss and every query gradient of one kernel step against the twin
    step (each swin block recomputed in its backward, as phase 8's plain
    route) from the same weights and batch, with its controls and planted
    faults. Then one step after a warm-up step: its launches (the key
    pass's forwards and the query's forward and backward: no twin, no bf16
    form), ms/step and peak memory. Returns the launches of the step."""
    import torch
    import torch.utils.checkpoint
    from stswincl_tpu_torch.configs import (ContrastTrainConfig,
                                            DataConfig, ModelConfig)
    from stswincl_tpu_torch.models import ContrastEncoder
    from stswincl_tpu_torch.models.swin import SpaceTimeSwinBlock
    from stswincl_tpu_torch.pipelines.contrast import build_contrast_encoder
    from stswincl_tpu_torch.tools import profile_contrast
    from stswincl_tpu_torch.train import train_contrast as tc
    from stswincl_tpu_torch.train.optim import (make_lars, scale_lr_linear,
                                                warmup_cosine_schedule)

    cfg = ContrastTrainConfig(model=ModelConfig(dtype="float32"),
                              data=DataConfig(dataset="synthetic",
                                              crop_hw=CONTRAST_HW,
                                              batch_size=CONTRAST_BATCH))
    classes = cfg.data.num_classes
    model = build_contrast_encoder(cfg, classes, dev)
    blocks = [m for m in model.modules() if hasattr(m, "kernels")]
    check(blocks and all(m.kernels is None for m in blocks),
          "fp32 contrast encoder: not on the kernels (kernels=None)")
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    m_cfg = cfg.model
    kw = dict(swin_dim=m_cfg.swin_dim, num_heads=m_cfg.num_heads,
              with_instance=cfg.pixpro_ins_loss_weight > 0,
              swin_depths=tuple(m_cfg.swin_depths), dtype=torch.float32,
              input_hw=CONTRAST_HW, attn_impl=m_cfg.attn_impl)
    total = cfg.num_epochs * CONTRAST_STEPS
    schedule = warmup_cosine_schedule(
        scale_lr_linear(cfg.base_lr, CONTRAST_BATCH),
        cfg.warmup_epochs * CONTRAST_STEPS, total,
        warmup_multiplier=cfg.warmup_multiplier)

    def make_state(m):
        return tc.ContrastTrainState.create(m, lambda p: make_lars(
            p, schedule, weight_decay=cfg.weight_decay,
            trust_coefficient=cfg.lars_trust_coef))

    def step_of(clips, labels, kernels=None):
        """One step from `weights`: (loss, query gradients by name,
        seconds)."""
        m = ContrastEncoder(classes, **kw, kernels=kernels)
        m.load_state_dict(weights)
        state = make_state(m.to(dev))
        if kernels is False:
            for mod in itertools.chain(state.query.modules(),
                                       state.key.modules()):
                if isinstance(mod, SpaceTimeSwinBlock):
                    mod.forward = functools.partial(
                        torch.utils.checkpoint.checkpoint, mod.forward,
                        use_reentrant=False)
        step = tc.make_contrast_train_step(state, classes, total,
                                           cfg.momentum)
        grads = {}
        state.opt.register_step_pre_hook(lambda *_: grads.update(
            {n: p.grad.detach().clone()
             for n, p in state.query.named_parameters()
             if p.grad is not None}))
        ts = time.perf_counter()
        loss = float(step(clips, labels)["loss"])
        torch.cuda.synchronize()
        sec = time.perf_counter() - ts
        del state, step, m
        torch.cuda.empty_cache()
        return loss, grads, sec

    clips, labels = profile_contrast.seeded_batch(CONTRAST_BATCH,
                                                  CONTRAST_HW, CONTRAST_SEED)
    clips = torch.from_numpy(clips).to(dev)
    labels = torch.from_numpy(labels).to(dev).long()
    torch.cuda.reset_peak_memory_stats()
    loss_k, grads_k, _ = step_of(clips, labels)
    fp32_step_gate(f"[fp32 contrast] batch {CONTRAST_BATCH}", step_of,
                   clips, labels, loss_k, grads_k)
    gate_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del grads_k

    state = make_state(model)
    step = tc.make_contrast_train_step(state, classes, total, cfg.momentum)
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step(clips, labels)["loss"])]  # warm-up
    reset_launches(wrappers)
    ts = time.perf_counter()
    losses.append(float(step(clips, labels)["loss"]))
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - ts)
    counts, forms = read_launches(wrappers)
    launches["contrast_fp32"] = counts
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    STEP_MS["fp32 stage 2"] = ms
    print(f"  [fp32 contrast] stage-2 step at batch {CONTRAST_BATCH} on the "
          f"fp32 forms: {ms:.1f} ms, peak {peak:.2f} GiB (the gate's "
          f"{gate_peak:.2f} GiB), losses {losses}, "
          f"launches { {k: v for k, v in counts.items() if v} } on {smi}",
          flush=True)
    check(all(math.isfinite(v) for v in losses), f"fp32 contrast losses "
          f"{losses}")
    fwd = counts["swin_block_attention_f32"]
    check(fwd > 0 and counts["swin_block_attention_bwd_f32"] > 0
          and counts["swin_block_epilogue_bwd_f32"] > 0
          and counts["patch_merge_f32"] > 0,
          f"fp32 contrast: a form never launched {counts}")
    for k, n in counts.items():
        check(n == 0 or k in F32_STEP or k in ("linear_f32", "wgrad_f32"),
              f"fp32 contrast: {k} launched {n} times")
    check_gemm_launches("fp32 contrast", counts, forms,
                        f32_recomputed=(counts["swin_block_epilogue_bwd_f32"]
                                        * (FT_BLOCKS - FT_M_SAVED)
                                        // FT_BLOCKS))
    del model, state, step
    torch.cuda.empty_cache()
    return counts


def phase_fp32(dev, smi, wrappers, launches, results, median_ms) -> dict:
    """Phase 7: (a) `phase_fp32_kernels`; (b) fp32 serving: the model that
    `build_model(ModelConfig(dtype="float32"))` builds (`kernels=None`)
    through `StreamingSegmenter` at full width, bs 2, BatchNorm calibrated
    on the first clip: each `predict_next` launches the fp32 forms of K1,
    K2 and K3 and K4's exact form as often as the bf16 route launches its
    own (SERVE_STEP) and no bf16 kernel, the fp32 GEMM twice a K1 or K2 and
    once a K3; its predictions equal the fp32 plain route's (`kernels=
    False`) on >= TOL_F32_SHARE of pixels each step; ms per predict_next
    and frames/s of both fp32 routes and of the bf16 model on the same
    weights; (c) fp32 evaluation at B = 1 through `evaluate.run_test` on
    phase 9's synthetic split, streamed and full clip, from a checkpoint
    of (b)'s weights: K4 once a frame, the fp32 forms launched and no bf16
    kernel, the full-clip predictions against the plain route's,
    frames/s and `sec_per_frame`; (d) stage-1 training of that model on
    the fp32 forms (`phase_fp32_train`: the batch-2 gate against the twin
    step, then batch 8 timed); (e) one stage-2 step on them
    (`phase_fp32_contrast`); (a) also the fp32 forms of rows 12-15 and 17
    (`phase_fp32_offpath_kernels`), (h) their entry points
    (`phase_fp32_entry_points`) and (i) a `swin_dim` 128 step, K5 at hd
    32 (`phase_fp32_hd32_train`). Returns the launches a batch-8 stage-1
    step and a stage-2 step."""
    import tempfile

    import torch
    from stswincl_tpu_torch.ckpt import save_checkpoint
    from stswincl_tpu_torch.configs import (DataConfig, ModelConfig,
                                            SegTrainConfig)
    from stswincl_tpu_torch.data.loader import SyntheticSegDataset
    from stswincl_tpu_torch.models import TswinPlus
    from stswincl_tpu_torch.models.init import init_weights
    from stswincl_tpu_torch.pipelines import evaluate as evaluate_mod
    from stswincl_tpu_torch.pipelines.common import build_model
    from stswincl_tpu_torch.pipelines.streaming import StreamingSegmenter

    t0 = time.perf_counter()
    phase_fp32_kernels(dev, results, median_ms)
    print(f"phase 7 (a) the fp32 forms against their twins: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_fp32_train_kernels(dev, results, median_ms)
    phase_fp32_attn_bwd(dev, results, median_ms)
    print(f"phase 7 (a) the fp32 training forms against their twins: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_fp32_offpath_kernels(dev, results, median_ms, wrappers)
    print(f"phase 7 (a) the fp32 forms of rows 12-15 and 17 against their "
          f"twins: {time.perf_counter() - t0:.1f} s", flush=True)

    # (b) serving
    t0 = time.perf_counter()
    cfg = SegTrainConfig(model=ModelConfig(dtype="float32"),
                         data=DataConfig(batch_size=BS, crop_hw=(H, W)))
    model, classes = build_model(cfg.model, cfg.data, device=dev)
    check(model.kernels is None, f"fp32 build_model: kernels "
          f"{model.kernels}, expected None (the fp32 forms)")
    init_weights(model, torch.Generator().manual_seed(0))
    model.to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(5)
    frames = torch.rand((BS, 4 + F32_STEPS, H, W, 3), generator=gen,
                        device=dev) * 2 - 1
    calibrate_batchnorm(model, frames[:, 0:4])
    weights = model.state_dict()
    kw = dict(num_classes=classes, swin_dim=512, swin_depths=(3, 3),
              input_hw=(H, W))
    f32_rows = {"attention": "swin_block_attention_f32",
                "epilogue": "swin_block_epilogue_f32",
                "patch_merge": "patch_merge_f32",
                "upsample_argmax": "upsample_argmax"}
    bf16_rows = {"attention": "swin_block_attention",
                 "epilogue": "swin_block_epilogue",
                 "patch_merge": "patch_merge",
                 "upsample_argmax": "upsample_argmax"}

    def drive(m, path):
        """init_and_predict, then F32_STEPS predict_next frames: (the
        predictions, launches a predict_next, the GEMM forms since the
        reset, ms a predict_next (median of the steps after the first),
        frames/s over them)."""
        seg = StreamingSegmenter(m, out_hw=OUT_HW)
        reset_launches(wrappers)
        cache, pred = seg.init_and_predict(frames[:, 0:4])
        preds, step_s = [pred], []
        before = read_launches(wrappers)[0]
        for i in range(4, 4 + F32_STEPS):
            ts = time.perf_counter()
            cache, pred = seg.predict_next(cache, frames[:, i])
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - ts)
            preds.append(pred)
        launches[path], forms = read_launches(wrappers)
        per_step = {k: (n - before[k]) / F32_STEPS
                    for k, n in launches[path].items()}
        steady = step_s[1:]
        return (preds, per_step, forms, 1e3 * statistics.median(steady),
                BS * len(steady) / sum(steady))

    rates = {}
    preds, per_step, forms, *rates["fp32 kernels"] = drive(model,
                                                           "serve_fp32")
    check(StreamingSegmenter(model).exact, "fp32 serving: K4 not exact")
    print(f"  [fp32] serving-path launches a predict_next: "
          f"{ {k: v for k, v in per_step.items() if v} }", flush=True)
    check_gemm_launches("fp32 serve", launches["serve_fp32"], forms,
                        m_saved=0)
    for key, want in SERVE_STEP.items():
        check(per_step[f32_rows[key]] == want, f"fp32 serve: "
              f"{f32_rows[key]} launched {per_step[f32_rows[key]]} times a "
              f"predict_next, expected {want}")
    for k, n in launches["serve_fp32"].items():
        check(n == 0 or k in f32_rows.values() or k == "linear_f32",
              f"fp32 serve: {k} launched {n} times")
    for p in preds:
        check(p.shape == (BS, *OUT_HW) and p.dtype == torch.int32
              and 0 <= int(p.min()) and int(p.max()) < classes,
              f"fp32 prediction {p.shape} {p.dtype}")
    plain = TswinPlus(**kw, dtype=torch.float32, kernels=False)
    plain.load_state_dict(weights)
    plain_preds, plain_step, _, *rates["fp32 plain"] = drive(
        plain.to(dev).eval(), "serve_fp32_plain")
    check(sum(plain_step.values()) == 0,
          f"fp32 plain route launched {plain_step}")
    shares = [(a == b).float().mean().item()
              for a, b in zip(preds, plain_preds)]
    bfm = TswinPlus(**kw, dtype=torch.bfloat16)
    bfm.load_state_dict(weights)
    _, bf_step, _, *rates["bf16 kernels"] = drive(bfm.to(dev).eval(),
                                                  "serve_fp32_weights_bf16")
    for key, want in SERVE_STEP.items():
        check(bf_step[bf16_rows[key]] == per_step[f32_rows[key]],
              f"fp32 serve: {f32_rows[key]} {per_step[f32_rows[key]]} a "
              f"step, the bf16 route's {bf16_rows[key]} "
              f"{bf_step[bf16_rows[key]]}")
    classes_hist = torch.bincount(preds[-1].flatten(), minlength=classes)
    print(f"  [fp32] kernel route == fp32 plain route: min {min(shares):.6f}"
          f" of pixels over {len(shares)} frames; last-frame classes "
          f"{classes_hist.tolist()}", flush=True)
    check(min(shares) >= TOL_F32_SHARE, f"fp32 serve: kernel vs plain route "
          f"{min(shares)} < {TOL_F32_SHARE}")
    for route, (ms, fps) in rates.items():
        print(f"  [fp32 serve] {route}: {ms:.2f} ms a predict_next (median "
              f"of {F32_STEPS - 1}), {fps:.2f} frames/s at bs {BS} on {smi}",
              flush=True)
    del plain, bfm, preds, plain_preds
    torch.cuda.empty_cache()
    print(f"phase 7 (b) fp32 serving: {time.perf_counter() - t0:.1f} s",
          flush=True)

    # (f) fp32 serving on the routes off 'pallas_full'
    t0 = time.perf_counter()
    for route, want in F32_ROUTE_SERVE_STEP.items():
        rkw = (dict(whole_block=True) if route == "whole_block"
               else dict(attn_impl=route))
        if route == "whole_block":  # as phase 3c builds the bf16 one
            m = TswinPlus(**kw, dtype=torch.float32, **rkw)
        else:
            m, _ = build_model(ModelConfig(dtype="float32", **rkw),
                               cfg.data, device=dev)
        check(m.kernels is None, f"fp32 {route}: kernels {m.kernels}")
        m.load_state_dict(weights)
        path = f"serve_fp32_{route}"
        rpreds, rstep, rforms, *rates[f"fp32 {route}"] = drive(
            m.to(dev).eval(), path)
        print(f"  [fp32 {route}] serving-path launches a predict_next: "
              f"{ {k: v for k, v in rstep.items() if v} }", flush=True)
        check_gemm_launches(f"fp32 serve {route}", launches[path], rforms,
                            m_saved=0)
        for k, n in rstep.items():
            check(n == want.get(k, 0) or k == "linear_f32", f"fp32 serve "
                  f"{route}: {k} launched {n} times a predict_next, "
                  f"expected {want.get(k, 0)}")
        plain = TswinPlus(**kw, dtype=torch.float32, kernels=False, **rkw)
        plain.load_state_dict(weights)
        plain_preds, plain_step, _, *rates[f"fp32 {route} plain"] = drive(
            plain.to(dev).eval(), f"{path}_plain")
        check(sum(plain_step.values()) == 0,
              f"fp32 {route} plain route launched {plain_step}")
        shares = [(a == b).float().mean().item()
                  for a, b in zip(rpreds, plain_preds)]
        print(f"  [fp32 {route}] kernel route == fp32 plain route: min "
              f"{min(shares):.6f} of pixels over {len(shares)} frames",
              flush=True)
        check(min(shares) >= TOL_F32_SHARE, f"fp32 serve {route}: kernel "
              f"vs plain route {min(shares)} < {TOL_F32_SHARE}")
        for r in (f"fp32 {route}", f"fp32 {route} plain"):
            ms, fps = rates[r]
            print(f"  [fp32 serve] {r}: {ms:.2f} ms a predict_next (median "
                  f"of {F32_STEPS - 1}), {fps:.2f} frames/s at bs {BS} on "
                  f"{smi}; fp32 'pallas_full' {rates['fp32 kernels'][0]:.2f}"
                  " ms", flush=True)
        m.cpu()
        del m, plain, rpreds, plain_preds
        torch.cuda.empty_cache()
    print(f"phase 7 (f) fp32 serving on the other routes: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # (c) evaluation at B = 1 through run_test
    t0 = time.perf_counter()
    spy = EvalSpy(evaluate_mod.evaluate_split, wrappers)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        save_checkpoint(os.path.join(tmp, "fp32"), 0, {"model": weights})
        viz = {}
        for streaming in (True, False):
            viz[streaming] = os.path.join(tmp, f"viz_{streaming}")
            test_cfg = SegTrainConfig(
                model=ModelConfig(dtype="float32"),
                data=DataConfig(dataset="synthetic", crop_hw=(H, W)),
                test_checkpoint=os.path.join(tmp, "fp32"),
                streaming_eval=streaming, viz_dir=viz[streaming],
                log_dir=os.path.join(tmp, "log"))
            reset_launches(wrappers)
            with unittest.mock.patch.object(evaluate_mod, "evaluate_split",
                                            spy):
                evaluate_mod.run_test(test_cfg, device=dev)
            launches[f"eval_fp32_streaming_{str(streaming).lower()}"] = \
                spy.calls[-1]["launches"]
        plain_dir = os.path.join(tmp, "viz_plain")
        plain = TswinPlus(**kw, dtype=torch.float32, kernels=False)
        plain.load_state_dict(weights)
        evaluate_mod.evaluate_split(
            plain.to(dev).eval(),
            SyntheticSegDataset(length=8, t=4, hw=(H, W), num_classes=12),
            SegTrainConfig(data=DataConfig(dataset="synthetic"),
                           viz_dir=plain_dir), streaming=False)
        ref, full = pngs(plain_dir), pngs(viz[False])
    import numpy as np
    share = float(np.mean([(full[k] == ref[k]).all(-1).mean() for k in ref]))
    for c, mode in zip(spy.calls, ("streamed", "full clip")):
        frames_n = c["summary"]["frames"]
        per_frame = {k: v / frames_n for k, v in c["launches"].items() if v}
        print(f"  [fp32 eval {mode}] launches a frame: {per_frame}",
              flush=True)
        eval_rate(f"fp32 eval {mode}", c, smi)
        check(c["launches"]["upsample_argmax"] == frames_n,
              f"fp32 eval {mode}: K4 launched "
              f"{c['launches']['upsample_argmax']} times for {frames_n} "
              "frames")
        check_gemm_launches(f"fp32 eval {mode}", c["launches"], c["forms"],
                            m_saved=0)
        for k, n in c["launches"].items():
            check(n == 0 or k in f32_rows.values() or k == "linear_f32",
                  f"fp32 eval {mode}: {k} launched {n} times")
        for k in f32_rows.values():
            check(c["launches"][k] > 0, f"fp32 eval {mode}: {k} never "
                  "launched")
    print(f"  [fp32 eval] kernel route == plain route (full clip): "
          f"{share:.6f} of pixels over {len(ref)} frames", flush=True)
    check(share >= TOL_F32_SHARE, f"fp32 eval: kernel vs plain route "
          f"{share} < {TOL_F32_SHARE}")
    del plain
    torch.cuda.empty_cache()
    print(f"phase 7 (c) fp32 evaluation: {time.perf_counter() - t0:.1f} s",
          flush=True)

    # (d) stage-1 training on the fp32 forms
    t0 = time.perf_counter()
    model.cpu()
    del model
    torch.cuda.empty_cache()
    per_step = {"per_fp32_train_step": phase_fp32_train(
        dev, smi, wrappers, launches, weights, kw)}
    print(f"phase 7 (d) fp32 training: {time.perf_counter() - t0:.1f} s",
          flush=True)

    # (g) a stage-1 step on 'pallas' and with `whole_block`
    t0 = time.perf_counter()
    phase_fp32_route_train(dev, wrappers, launches, weights, kw)
    print(f"phase 7 (g) fp32 steps on 'pallas' and whole_block: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # (h) the entry points of rows 12-15 and 17 in fp32
    t0 = time.perf_counter()
    phase_fp32_entry_points(dev, wrappers, launches)
    print(f"phase 7 (h) the fp32 entry points of rows 12-15 and 17: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # (i) a stage-1 step of swin_dim 128 (K5 at hd 32)
    t0 = time.perf_counter()
    phase_fp32_hd32_train(dev, wrappers, launches)
    print(f"phase 7 (i) fp32 step of swin_dim 128: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # (e) a stage-2 step on the fp32 forms
    t0 = time.perf_counter()
    per_step["per_fp32_contrast_step"] = phase_fp32_contrast(
        dev, smi, wrappers, launches)
    print(f"phase 7 (e) fp32 stage-2 step: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return per_step


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
    """Each gradient's cosine to its counterpart, in fp64 (fp32 resolves
    1 - cos only to about 6e-8); 0 where either is zero (a gradient that
    never arrived)."""
    out = {}
    for n, gp in grads_p.items():
        a, b = grads_k[n].double().flatten(), gp.double().flatten()
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
        STEP_MS[path] = med
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


def seg_cli(argv, wrappers, step_probe=None, runner=None) -> dict:
    """`cli.main(argv)` (or `runner(argv)`) in process with every count
    set to 0 first, its
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
        (runner or cli.main)(argv)
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

    def loss_spy(q, q_labels, keys, class_num, *group):
        valid = (q_labels >= 0) & (q_labels < class_num)
        fills.append(((q_labels == 255).sum().item(),
                      ((q_labels == 255) & valid).sum().item(),
                      sum((kl == 255).sum().item() for _, kl in keys)))
        return real_loss(q, q_labels, keys, class_num, *group)

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


# ---- phase 11: data parallelism ---------------------------------------------

P11_CLI_TIMEOUT = 300  # seconds: (a)'s torchrun, its build loaded, not made
P11_RANKS = 2
P11_SEG_SEED = 3       # (b): phase 4's batch, rank 0's half more ignored
P11_TIMED_STEPS = 3    # (b): timed steps, with and without the all-reduce
# (b, c): the ranks' step against the one-process step on the whole batch.
# That step's run-to-run spread (printed: its statistics bit-equal, most
# gradients off by the atomic sums of the backward) is hundreds of times
# below what splitting the batch moves: the bf16 rounding (cuDNN's
# algorithms at batch 4, the BatchNorm sums in another order). Any
# rounding-level change does as much: the one-process step with its input
# scaled by 1 + e n (n standard normal) reads the same deviations at
# e = 2^-9 (bf16's unit roundoff) and 2^-12, so they are the gradients'
# bf16 noise, and these two controls set the bounds, not the spread. Each
# gate of phase 10 (d)'s form: its deviation from the one-process step
# within TOL_REMAT_FACTOR x the larger control's plus a floor: the loss
# TOL_P11_LOSS relative, each BatchNorm statistic TOL_P11_STATS relative,
# each gradient's 1 - cosine TOL_NOISE_FLOOR, its |norm ratio - 1| (on the
# scale of the controls' |norm ratio - 1| and 1 - cosine, the second-order
# norm change of noise at that angle) TOL_P11_NORM_FLOOR. A gradient
# whose controls read 1 - cosine above TOL_P11_WELL is noise-dominated
# (the ResNet branch at stage 1, most leaves at stage 2): its bound is
# nearly as large as what it compares, so it catches only gross faults
# and no planted fault is counted on it. A planted fault misses a gate
# of the well-conditioned gradients, the loss or the statistics tenfold.
P11_PERTURBS = (2.0 ** -9, 2.0 ** -12)
TOL_P11_LOSS, TOL_P11_STATS = 1e-3, 1e-4
# the norm ratio's floor: the relative error that the cosine floor
# TOL_NOISE_FLOOR allows (1 - cos = e^2 / 2), 0.45 %
TOL_P11_NORM_FLOOR = math.sqrt(2 * TOL_NOISE_FLOOR)
TOL_P11_WELL = 0.02
P11_SEG_VARIANTS = ("sound", "bn_local", "pool_local", "ohem_local",
                    "norm_local", "unreduced")
P11_CONTRAST_VARIANTS = ("sound", "key_local", "pool_local")
# (e) the stage-1 step of (b) in fp32 on the fp32 forms: every gradient
# gated (no noise-dominated exemption), its controls the one-process step
# on the input perturbed at fp32's own scale (relative noise of 2^-20 and
# 2^-23) and on the batch in reverse order (splitting the batch reorders
# its sums, which no input perturbation does: a near-cancelling bias
# gradient moves by 4e-5 under the split and by 7e-7 under the
# perturbations alone), the floors below fp32 rounding's reach: the cosine's
# is the norm's as 1 - cos = e^2 / 2, 5e-11, which the fp64 cosines of
# `cosines_of` resolve
P11_F32_VARIANTS = ("sound", "bn_local", "unreduced")
P11_F32_PERTURBS = (2.0 ** -20, 2.0 ** -23)
P11_F32_NORM_FLOOR = 1e-5
P11_F32_FLOORS = {"loss": 1e-6, "stat": 1e-6,
                  "cos": P11_F32_NORM_FLOOR ** 2 / 2,
                  "norm": P11_F32_NORM_FLOOR}
P11_FAULTS = {
    "bn_local": "every BatchNorm on its rank's statistics",
    "pool_local": "the ASPP image-pool BatchNorms alone on their rank's "
                  "statistics",
    "ohem_local": "OHEM selected and normalised per rank",
    "norm_local": "OHEM's global sums over each rank's own counts",
    "unreduced": "rank 1's gradient not reduced",
    "key_local": "the key pass's BatchNorms on their rank's statistics"}


def p11_seg_batch(seed: int = P11_SEG_SEED):
    """Phase 4's seeded batch 8 (`seeded_batch`; another batch with
    another `seed`, as `route_gate_seeds.py --fp32-parallel` draws them),
    each clip tinted by a
    colour of its own, with 85 % of the 64x64 blocks of the first four
    clips (rank 0's half) ignored: the halves then differ in valid and
    hard pixel counts about sixfold. The tint keeps the step
    well-conditioned: untinted, every clip's blocks average to nearly the
    same colour, and the ASPP image-pool BatchNorm (one value a clip and
    channel) divides bf16 rounding by a near-zero variance."""
    import numpy as np
    images, labels = seeded_batch(8, seed=seed)
    rng = np.random.default_rng(seed + 100)
    drop = rng.random((4, H // 64, W // 64)) < 0.85
    labels[:4][np.repeat(np.repeat(drop, 64, axis=1), 64, axis=2)] = -1
    tint = rng.uniform(-1.0, 1.0, (8, 1, 1, 1, 3))
    return (images + tint).astype(np.float32), labels


def p11_contrast_batch():
    """`profile_contrast.seeded_batch` at phase 8's shape, each sample
    tinted by a colour of its own (as `p11_seg_batch`), a quarter of the
    32x32 label blocks of the first two samples (rank 0's half) set to
    the geometric fill 255, which the loss leaves out."""
    import numpy as np
    from stswincl_tpu_torch.tools import profile_contrast
    clips, labels = profile_contrast.seeded_batch(CONTRAST_BATCH, CONTRAST_HW,
                                                  CONTRAST_SEED)
    rng = np.random.default_rng(CONTRAST_SEED + 100)
    h, w = CONTRAST_HW
    drop = rng.random((2, 6, h // 32, w // 32)) < 0.25
    labels[:2][np.repeat(np.repeat(drop, 32, axis=2), 32, axis=3)] = 255
    tint = rng.uniform(-1.0, 1.0, (CONTRAST_BATCH, 1, 1, 1, 1, 3))
    return (clips + tint).astype(np.float32), labels


_P11_INIT = {}  # the seeded initial states, made once a process


def p11_seg_model(dev, bf16, kernels=None):
    """Phase 4's TswinPlus (SegTrainConfig's model at 512x640, bf16, seed
    0) on `dev`, and its config."""
    import torch
    from stswincl_tpu_torch.configs import SegTrainConfig
    from stswincl_tpu_torch.models import TswinPlus
    from stswincl_tpu_torch.models.init import init_weights
    cfg = SegTrainConfig()
    kw = dict(num_classes=cfg.model.num_classes, swin_dim=cfg.model.swin_dim,
              num_heads=cfg.model.num_heads,
              swin_depths=tuple(cfg.model.swin_depths),
              gelu_exact=cfg.model.gelu_exact, dtype=bf16, input_hw=(H, W))
    if "seg" not in _P11_INIT:
        _P11_INIT["seg"] = init_weights(
            TswinPlus(**kw), torch.Generator().manual_seed(0)).state_dict()
    m = TswinPlus(**kw, kernels=kernels)
    m.load_state_dict(_P11_INIT["seg"])
    return m.to(dev), cfg


def p11_contrast_state(dev, bf16):
    """Phase 8 (a)'s ContrastEncoder warm start (a seeded TswinPlus's
    encoder in a seeded encoder) as `ContrastTrainState` on `dev`, with
    `ContrastTrainConfig`'s LARS, and the step's arguments."""
    import torch
    from stswincl_tpu_torch.ckpt import translate_seg_to_pretrain
    from stswincl_tpu_torch.configs import ContrastTrainConfig, DataConfig
    from stswincl_tpu_torch.models import ContrastEncoder, TswinPlus
    from stswincl_tpu_torch.models.init import init_weights
    from stswincl_tpu_torch.train import train_contrast as tc
    from stswincl_tpu_torch.train.optim import (make_lars, scale_lr_linear,
                                                warmup_cosine_schedule)
    cfg = ContrastTrainConfig(data=DataConfig(
        dataset="synthetic", crop_hw=CONTRAST_HW, batch_size=CONTRAST_BATCH))
    kw = dict(num_classes=cfg.data.num_classes, swin_dim=cfg.model.swin_dim,
              num_heads=cfg.model.num_heads,
              swin_depths=tuple(cfg.model.swin_depths), dtype=bf16,
              input_hw=CONTRAST_HW)
    if "contrast" not in _P11_INIT:
        seg = init_weights(TswinPlus(**kw), torch.Generator().manual_seed(0))
        enc = init_weights(ContrastEncoder(**kw),
                           torch.Generator().manual_seed(1))
        _P11_INIT["contrast"] = translate_seg_to_pretrain(
            seg.state_dict(), enc.state_dict())[0]
    enc = ContrastEncoder(**kw)
    enc.load_state_dict(_P11_INIT["contrast"])
    total = cfg.num_epochs * CONTRAST_STEPS
    schedule = warmup_cosine_schedule(
        scale_lr_linear(cfg.base_lr, CONTRAST_BATCH),
        cfg.warmup_epochs * CONTRAST_STEPS, total,
        warmup_multiplier=cfg.warmup_multiplier)
    state = tc.ContrastTrainState.create(enc.to(dev), lambda p: make_lars(
        p, schedule, weight_decay=cfg.weight_decay,
        trust_coefficient=cfg.lars_trust_coef))
    return state, dict(class_num=cfg.data.num_classes, total_steps=total,
                       base_momentum=cfg.momentum)


def p11_unreduced_on_rank_1(state, bucket):
    """Planted fault, a DDP comm hook: every rank joins the all-reduce,
    rank 1 keeps its own gradient."""
    import torch.distributed as dist
    buf = bucket.buffer()
    local = buf.clone()
    world = dist.get_world_size()
    fut = dist.all_reduce(buf, async_op=True).get_future()
    return fut.then(lambda f: local if dist.get_rank() == 1
                    else f.value()[0].div_(world))


def p11_ohem_counts_local(loss, n_min, thresh, group=None):
    """Planted fault in place of `ops.ohem._ohem_select`: the global v* and
    sums, over each rank's own hard and top-k counts."""
    import torch
    from stswincl_tpu_torch.ops import ohem
    from stswincl_tpu_torch.parallel.collectives import sum_over
    loss = torch.maximum(loss, torch.zeros_like(loss))
    hard = loss > math.log(1.0 / thresh)
    zero = torch.zeros_like(loss)
    vk = ohem._kth_largest(loss, n_min, group)
    gt = loss > vk
    n_hard, n_gt = hard.sum(), gt.sum()
    sum_hard, sum_gt = sum_over(torch.stack([
        torch.where(hard, loss, zero).sum(),
        torch.where(gt, loss, zero).sum()]), group)
    return torch.where(n_hard > n_min, sum_hard / n_hard.clamp(min=1),
                       (sum_gt + (n_min - n_gt) * vk) / n_min)


def p11_unsync_image_pool(*models) -> None:
    """Planted fault: the ASPP image-pool BatchNorms of `models` back on
    their rank's statistics, every other BatchNorm synced."""
    for model in models:
        for n, mod in model.named_modules():
            if n.endswith("aspp.branch_img.bn"):
                mod.process_group = None


def p11_stats(*named_modules) -> dict:
    return {f"{tag}{n}": b.detach().float().cpu().clone()
            for tag, mod in named_modules for n, b in mod.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def p11_rank(rank, world, port, tmp, stage, seed=P11_SEG_SEED,
             only=None):
    """A rank of (b) (`stage` "seg") or (c) ("contrast") on cuda:0 over
    gloo: its shard of the global batch (stage 1: of `seed`'s), one step
    of each variant (or of the variants in `only`) from the seeded
    weights; writes its results (and, where the gate needs them, its
    gradients) under `tmp`. Any exception fails the rank, and the phase
    with it."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    import torch.distributed as dist
    from stswincl_tpu_torch import kernels
    from stswincl_tpu_torch.ops import ohem
    from stswincl_tpu_torch.parallel import (data_parallel,
                                             initialize_distributed,
                                             max_param_difference, replicate,
                                             shard_batch, shutdown,
                                             sync_batchnorm)
    from stswincl_tpu_torch.pipelines.seg import make_tx
    from stswincl_tpu_torch.train import train_contrast as tc
    from stswincl_tpu_torch.train.train_seg import make_seg_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = initialize_distributed("cuda:0", backend="gloo")
    t0 = time.perf_counter()
    kernels.load()  # the parent's build: loaded, not made again
    out = {"backend": dist.get_backend(), "device": str(dev),
           "load_s": time.perf_counter() - t0,
           "built_here": kernels.build_seconds is not None}
    wrappers = kernel_wrappers()
    bf16 = torch.bfloat16
    if stage.startswith("seg"):
        images, labels = p11_seg_batch(seed)
        batch = shard_batch({"x": images, "y": labels})
        x = torch.from_numpy(batch["x"]).to(dev)
        y = torch.from_numpy(batch["y"]).to(dev).long()
        variants = P11_SEG_VARIANTS
        if stage == "seg_fp32":
            bf16, variants = torch.float32, P11_F32_VARIANTS
    else:
        clips, labels = p11_contrast_batch()
        batch = shard_batch({"x": clips, "y": labels})
        x = torch.from_numpy(batch["x"]).to(dev)
        y = torch.from_numpy(batch["y"]).to(dev).long()
        variants = P11_CONTRAST_VARIANTS
    if only is not None:
        variants = [v for v in variants if v in only]
    try:
        for variant in variants:
            if stage.startswith("seg"):
                model, cfg = p11_seg_model(dev, bf16)
                if variant != "bn_local":
                    sync_batchnorm(model)
                if variant == "pool_local":
                    p11_unsync_image_pool(model)
                ddp = data_parallel(model, dev)
                if variant == "unreduced":
                    ddp.register_comm_hook(None, p11_unreduced_on_rank_1)
                opt, schedule = make_tx(cfg, 1, model)
                step = make_seg_train_step(ddp, opt, schedule, cfg.loss,
                                           ohem_thresh=cfg.ohem_thresh)
                if variant == "ohem_local":
                    step.group = None
                named, mods = model.named_parameters, (("", model),)
            else:
                state, kw = p11_contrast_state(dev, bf16)
                sync_batchnorm(state.query)
                if variant != "key_local":
                    sync_batchnorm(state.key)
                if variant == "pool_local":
                    p11_unsync_image_pool(state.query, state.key)
                replicate(state.key)
                ddp = data_parallel(state.query, dev)
                step = tc.make_contrast_train_step(state, query=ddp, **kw)
                opt, model = state.opt, state.query
                named = state.query.named_parameters
                mods = (("query.", state.query), ("key.", state.key))
            grads = {}
            opt.register_step_pre_hook(lambda *_: grads.update(
                {n: p.grad.detach().float().cpu().clone()
                 for n, p in named()}))
            patch = (unittest.mock.patch.object(
                ohem, "_ohem_select", p11_ohem_counts_local)
                if variant == "norm_local" else contextlib.nullcontext())
            reset_launches(wrappers)
            with patch:
                metrics = step(x, y)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            counts, forms = read_launches(wrappers)
            res = {"loss": loss, "stats": p11_stats(*mods),
                   "parted": max(max_param_difference(m) for _, m in mods),
                   "launches": counts, "forms": forms}
            if rank == (1 if variant == "unreduced" else 0):
                torch.save(grads, os.path.join(tmp, f"{stage}_{variant}.pt"))
            if variant == "sound" and stage == "seg":
                res["ms"], res["ms_no_sync"] = [], []
                for no_sync in (False, True):
                    for _ in range(P11_TIMED_STEPS):
                        ctx = ddp.no_sync() if no_sync \
                            else contextlib.nullcontext()
                        dist.barrier()
                        torch.cuda.synchronize()
                        ts = time.perf_counter()
                        with ctx:
                            step(x, y)
                        torch.cuda.synchronize()
                        res["ms_no_sync" if no_sync else "ms"].append(
                            1e3 * (time.perf_counter() - ts))
                res["peak"] = torch.cuda.max_memory_allocated()
            if variant == "sound":
                res.setdefault("peak", torch.cuda.max_memory_allocated())
            out[variant] = res
            del model, ddp, step, opt, grads
            torch.cuda.empty_cache()
    finally:
        shutdown()
    torch.save(out, os.path.join(tmp, f"{stage}_rank{rank}.pt"))


def p11_spawn(stage, tmp, seed=P11_SEG_SEED, only=None) -> list:
    """Run `p11_rank` in P11_RANKS processes on cuda:0 and return each
    rank's results; a rank that fails raises here."""
    import socket

    import torch
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.start_processes(p11_rank, args=(P11_RANKS, port, tmp, stage, seed,
                                       only),
                       nprocs=P11_RANKS, start_method="spawn")
    return [torch.load(os.path.join(tmp, f"{stage}_rank{r}.pt"),
                       weights_only=False) for r in range(P11_RANKS)]


def p11_one_process(stage, dev, bf16, seed=P11_SEG_SEED):
    """The one-process step of `stage` on the whole global batch (stage
    1: `seed`'s): the
    reference, the same again, and a control on the input scaled by
    1 + e n for each e of P11_PERTURBS (fp32: P11_F32_PERTURBS, and the
    batch in reverse order, the same sums in another order); (loss,
    gradients, statistics) of each, and the zero-gradient biases."""
    import numpy as np
    import torch
    from stswincl_tpu_torch.models.aspp import ConvBNRelu
    from stswincl_tpu_torch.pipelines.seg import make_tx
    from stswincl_tpu_torch.train import train_contrast as tc
    from stswincl_tpu_torch.train.train_seg import make_seg_train_step
    if stage.startswith("seg"):
        images, labels = p11_seg_batch(seed)
    else:
        images, labels = p11_contrast_batch()
    perturbs = P11_PERTURBS
    if stage == "seg_fp32":
        bf16, perturbs = torch.float32, P11_F32_PERTURBS
    noise = np.random.default_rng(11).standard_normal(images.shape)
    batches = [(images, labels)] * 2 + [
        ((images * (1 + e * noise)).astype(np.float32), labels)
        for e in perturbs]
    if stage == "seg_fp32":
        batches.append((images[::-1].copy(), labels[::-1].copy()))
    del noise
    runs = []
    for batch, lbl in batches:
        x = torch.from_numpy(batch).to(dev)
        y = torch.from_numpy(lbl).to(dev).long()
        if stage.startswith("seg"):
            model, cfg = p11_seg_model(dev, bf16)
            opt, schedule = make_tx(cfg, 1, model)
            step = make_seg_train_step(model, opt, schedule, cfg.loss,
                                       ohem_thresh=cfg.ohem_thresh)
            mods = (("", model),)
        else:
            state, kw = p11_contrast_state(dev, bf16)
            step = tc.make_contrast_train_step(state, **kw)
            opt, model = state.opt, state.query
            mods = (("query.", state.query), ("key.", state.key))
        grads = {}
        opt.register_step_pre_hook(lambda *_: grads.update(
            {n: p.grad.detach().float().clone()
             for n, p in model.named_parameters()}))
        loss = float(step(x, y)["loss"])
        runs.append((loss, grads, p11_stats(*mods)))
        zero_grad = {f"{n}.conv.bias" for n, mod in model.named_modules()
                     if isinstance(mod, ConvBNRelu)}
        if not stage.startswith("seg"):
            zero_grad |= {"segmentor.aspp.out_conv.bias",
                          "projector.linear1.bias"}
        del model, step, opt, x
        torch.cuda.empty_cache()
    (l0, g0, s0), (l1, g1, s1) = runs[:2]
    same = sum(torch.equal(g0[n], g1[n]) for n in g0)
    print(f"  {p11_tag(stage)} the one-process step run "
          f"twice: loss {l0!r} / {l1!r}, {same} of {len(g0)} gradients and "
          f"{sum(torch.equal(s0[n], s1[n]) for n in s0)} of {len(s0)} "
          f"statistics bit-equal", flush=True)
    return runs, zero_grad


def p11_deviations(res, grads, ref) -> dict:
    """Each gated quantity's deviation of a step (`res`, `grads`) from
    `ref` = (loss, gradients, statistics): the loss and each statistic
    relative, each gradient's 1 - cosine, |norm ratio - 1| and relative
    distance."""
    loss, rgrads, rstats = ref
    dev = {"loss": abs(res["loss"] - loss) / abs(loss)}
    for n, b in rstats.items():
        dev[f"stat {n}"] = ((res["stats"][n] - b).norm()
                            / b.norm().clamp(min=1e-30)).item()
    cos = cosines_of({n: g.to(rgrads[n].device) for n, g in grads.items()},
                     rgrads)
    for n, g in rgrads.items():
        gn = grads[n].to(g.device)
        dev[f"cos {n}"] = 1 - cos[n]
        dev[f"norm {n}"] = abs(gn.norm().item()
                               / max(g.norm().item(), 1e-30) - 1)
        dev[f"dist {n}"] = ((gn - g).norm()
                            / g.norm().clamp(min=1e-30)).item()
    return dev


def p11_gates(tag, res, grads, ref, controls, zero_grad, again=None,
              floors=None, every_gradient=False):
    """Each gate of a ranks' step against the one-process step `ref`, as
    the ratio of its deviation to its bound (at most 1.0 passes):
    TOL_REMAT_FACTOR times the larger deviation of the `controls` (the
    (loss, gradients, statistics) of the one-process step on perturbed
    inputs) plus the gate's floor. Zero-gradient biases (zero in exact
    arithmetic) are held to 1e-3 of the largest gradient norm instead.
    Prints the worst gate of each kind with its deviation, the controls'
    and the bound; with `again` (the one-process step run again) also
    what the worst gate would read on its run-to-run spread instead.
    Returns the ratios and the keys of the noise-dominated gradients'
    gates (controls' 1 - cosine above TOL_P11_WELL), none with
    `every_gradient`; `floors` replaces the gates' floors."""
    floors = floors or {"loss": TOL_P11_LOSS, "stat": TOL_P11_STATS,
                        "cos": TOL_NOISE_FLOOR, "norm": TOL_P11_NORM_FLOOR}

    def deviations(run):
        return p11_deviations({"loss": run[0], "stats": run[2]}, run[1], ref)
    dev = p11_deviations(res, grads, ref)
    ctls = [deviations(c) for c in controls]
    spread = deviations(again) if again is not None else None
    ratios, noisy, read, on_spread = {}, set(), {}, {}
    for k, d in dev.items():
        kind, name = k.split(" ", 1) if " " in k else (k, k)
        if name in zero_grad or kind == "dist":
            continue
        cs = [c[k] for c in ctls]
        scale = max(max(cs), 0.0)
        if kind in ("cos", "norm"):
            cos_scale = max(c[f"cos {name}"] for c in ctls)
            if cos_scale > TOL_P11_WELL and not every_gradient:
                noisy.add(k)
            scale = max(scale, cos_scale)
        bound = TOL_REMAT_FACTOR * scale + floors[kind]
        ratios[k] = d / bound
        read[k] = f"{d:.3e} against {bound:.3e}; controls " + ", ".join(
            f"{c:.3e}" for c in cs)
        if spread is not None:
            on_spread[k] = d / (TOL_REMAT_FACTOR * max(spread[k], 0.0)
                                + floors[kind])
    top = max(g.norm().item() for g in ref[1].values())
    for n in zero_grad:
        k = f"zero {n}"
        ratios[k] = grads[n].norm().item() / (1e-3 * top)
        read[k] = f"{grads[n].norm().item():.3e} against {1e-3 * top:.3e}"

    def worst(keys):
        k = max(keys, key=ratios.get)
        return f"{k} {ratios[k]:.4f} ({read[k]})"
    kinds = {kind: [k for k in ratios if k.split(" ", 1)[0] == kind
                    and k not in noisy] for kind in
             ("loss", "stat", "cos", "norm", "zero")}
    well_ctl = max((max(c[f"cos {k[4:]}"] for c in ctls)
                    for k in kinds["cos"]), default=0.0)
    noisy_cos = [k for k in noisy if k.startswith("cos ")]
    noisy_ctl = max((max(c[k] for c in ctls) for k in noisy_cos),
                    default=0.0)
    print(f"  {tag} over bound, the worst of each gate: "
          f"{'; '.join(worst(ks) for ks in kinds.values() if ks)}; "
          f"{len(kinds['cos'])} well-conditioned gradients (controls' "
          f"1 - cos at most {well_ctl:.3e}); {len(noisy_cos)} "
          f"noise-dominated (controls' 1 - cos up to "
          f"{noisy_ctl:.3e}): "
          f"{worst(noisy) if noisy else '-'}; loss {res['loss']!r} against "
          f"{ref[0]!r} (controls {[c[0] for c in controls]})", flush=True)
    if on_spread:
        k = max(on_spread, key=on_spread.get)
        cos = {k: d for k, d in dev.items() if k.startswith("cos ")
               and k[4:] not in zero_grad}
        low = max(cos, key=cos.get)
        low_ctl = max(cos, key=lambda k: max(c[k] for c in ctls))
        pool = max((max(c[k] for c in ctls) for k in cos
                    if ".aspp.branch_img." in f".{k[4:]}"), default=0.0)
        print(f"  {tag} held to the one-process step's run-to-run spread "
              f"instead (TOL_REMAT_FACTOR x + the same floors), the worst "
              f"gate would read {on_spread[k]:.1f} ({k}): the split moves "
              f"the rounding as the controls do, the spread does not; "
              f"the lowest gradient cosine {1 - cos[low]:.5f} ({low[4:]}), "
              f"the controls' {1 - max(c[low_ctl] for c in ctls):.5f} "
              f"({low_ctl[4:]}); the ASPP image-pool gradients' controls "
              f"at 1 - cos <= {pool:.3e}", flush=True)
    return ratios, noisy


def p11_hold(stage, outs, tmp, runs, zero_grad, variants,
             label="") -> dict:
    """The gates of (b) or (c) on each variant: the sound step within
    every bound and its ranks equal to the bit; each planted fault at
    least ten times over a gate of the loss, a statistic or a
    well-conditioned gradient (the unreduced one: its ranks part).
    `label` is added to each printed tag. Returns, by variant, the worst
    gate and the worst norm gate (each (key, ratio)) and how far the
    ranks' parameters part."""
    import torch
    read = {}
    for variant in variants:
        grads = torch.load(os.path.join(tmp, f"{stage}_{variant}.pt"),
                           weights_only=True)
        rank = 1 if variant == "unreduced" else 0
        res = outs[rank][variant]
        tag = f"{p11_tag(stage)}{label} [{variant}]"
        fp32 = stage == "seg_fp32"
        ratios, noisy = p11_gates(
            tag, res, grads, runs[0], runs[2:], zero_grad,
            again=runs[1] if variant == "sound" else None,
            floors=P11_F32_FLOORS if fp32 else None, every_gradient=fp32)
        worst = max(((k, v) for k, v in ratios.items() if k not in noisy),
                    key=lambda kv: kv[1])
        parted = [o[variant]["parted"] for o in outs]
        norm = max(((k, v) for k, v in ratios.items()
                    if k.startswith("norm ") and k not in noisy),
                   key=lambda kv: kv[1], default=("-", 0.0))
        read[variant] = {"worst": worst, "worst_norm": norm,
                         "parted": parted}
        if variant == "sound":
            for k, v in ratios.items():
                check(v <= 1.0, f"{tag}: {k} at {v:.3f} of its bound")
            check(parted == [0.0] * len(outs), f"{tag}: the ranks' "
                  f"parameters part after the step by {parted}")
            check(len({o[variant]["loss"] for o in outs}) == 1,
                  f"{tag}: the ranks' losses differ")
        else:
            print(f"  {tag} planted fault, {P11_FAULTS[variant]}: the "
                  f"worst gate at {worst[1]:.1f} of its bound ({worst[0]}),"
                  f" the worst norm gate at {norm[1]:.1f} ({norm[0]}); "
                  f"ranks part by {parted}", flush=True)
            check(worst[1] >= 10.0, f"{tag}: the planted fault "
                  f"({P11_FAULTS[variant]}) reaches only {worst[1]:.3f} of "
                  f"a bound ({worst[0]})")
            # fp32 holds every gradient: the fault shows on the norms too,
            # not only on cosines near their floor
            check(not fp32 or norm[1] >= 10.0, f"{tag}: the planted fault "
                  f"({P11_FAULTS[variant]}) reaches only {norm[1]:.3f} of "
                  f"a norm gate ({norm[0]})")
            if variant == "unreduced":
                check(min(parted) > 0.0, f"{tag}: the ranks did not part")
        del grads
    return read


def p11_tag(stage) -> str:
    return {"seg": "(11b)", "contrast": "(11c)", "seg_fp32": "(11e)"}[stage]


def p11_launches(tag, res, want) -> None:
    """A step's launches, held to what its block calls imply."""
    got = res["launches"]
    for k, n in want.items():
        check(got[k] == n, f"{tag}: {k} launched {got[k]} times, the step "
              f"implies {n}")


def p11_cli_rank(out_path, argv) -> None:
    """(a)'s rank: `python -m stswincl_tpu_torch.cli <argv>` run by
    `runpy` under torchrun, with `seg_cli`'s spies on its steps; writes
    the steps' times and launches and the group's backend as JSON."""
    import runpy

    import torch
    import torch.distributed as dist
    from stswincl_tpu_torch.parallel import distributed as pdist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seen = {}
    real_shutdown = pdist.shutdown

    def spy_shutdown():
        if dist.is_initialized():
            seen.update(backend=dist.get_backend(),
                        world=dist.get_world_size(),
                        device=str(torch.cuda.current_device()))
        real_shutdown()

    def run_module(args):
        sys.argv = ["stswincl_tpu_torch.cli", *args]
        runpy.run_module("stswincl_tpu_torch.cli", run_name="__main__")

    with unittest.mock.patch.object(pdist, "shutdown", spy_shutdown):
        run = seg_cli(argv, kernel_wrappers(), runner=run_module)
    steps = [{"ms": a.elapsed_time(b), "launches": s["launches"],
              "forms": s["forms"], "calls": s["calls"],
              "loss": float(s["loss"])}
             for s in run["steps"] for a, b in (s["events"],)]
    evals = [{"launches": c["launches"], "frames": c["summary"]["frames"]}
             for c in run["evals"]]
    with open(out_path, "w") as f:
        json.dump({"seen": seen, "steps": steps, "peak": run["peak"],
                   "evals": evals}, f)


def p11_cli(tmp) -> dict:
    """(a): `torchrun --standalone --nproc_per_node=1` on
    `stswincl_tpu_torch.cli train-seg --device cuda`, one epoch of the
    synthetic set at full width and batch 8 (8 steps, one evaluation),
    through this script's rank mode (`p11_cli_rank`)."""
    out_path = os.path.join(tmp, "cli_rank.json")
    argv = ["train-seg", "--device", "cuda", "data.dataset=synthetic",
            "num_epochs=1", f"ckpt_dir={os.path.join(tmp, 'cli_ckpt')}",
            f"log_dir={os.path.join(tmp, 'cli_log')}"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=1", os.path.abspath(__file__), "--cli-rank",
           out_path, *argv]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=P11_CLI_TIMEOUT,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-8000:], flush=True)
        raise RuntimeError(f"phase 11 (a): torchrun exited "
                           f"{proc.returncode}")
    with open(out_path) as f:
        run = json.load(f)
    print(f"  (11a) torchrun, 1 rank, {wall:.1f} s in all: group "
          f"{run['seen']}; {len(run['steps'])} steps, rank 0's "
          f"evaluation(s) {run['evals']}", flush=True)
    return run


def phase_parallel(dev, bf16, smi, wrappers, launches) -> dict:
    """Phase 11: the data-parallel layer (`stswincl_tpu_torch/parallel/`).
    (a) NCCL, a world of one, through torchrun and the CLI: backend,
    ms/step beside phase 4's (DDP's hooks and the BatchNorm all-reduces),
    each step's launches exactly a step's block calls, K4 once a frame of
    rank 0's evaluation. (b) Two ranks on
    cuda:0 over gloo, stage 1: phase 4's weights and seeded batch 8 (each
    clip tinted, rank 0's half more ignored), 4 a rank, one Adam step,
    held against the one-process step on the whole batch (`p11_gates`:
    the loss, every BatchNorm statistic, each gradient's 1 - cosine and
    norm ratio, each within TOL_REMAT_FACTOR x the larger deviation of
    two controls, the one-process step on perturbed inputs, plus a
    floor) with the ranks' parameters equal to the bit; the planted
    faults (`P11_FAULTS`) must miss a bound of the loss, a statistic or a
    well-conditioned gradient tenfold; the launches a rank; ms/step with
    and without the gradient all-reduce (gloo through host memory on one
    card: not a multi-GPU rate). (c) The same for stage 2 at phase 8's
    shape, global batch 4, with its planted faults. (e) (b)'s stage-1 step
    in fp32 on the fp32 forms, every gradient gated against fp32-level
    controls (`P11_F32_*`). (d) K1-K6 on cuda:1 where the machine has two
    cards. Returns the per-rank launches of (b), (c) and (e)."""
    import tempfile

    import torch
    out = {}
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        # (a)
        run = p11_cli(tmp)
        check(run["seen"].get("backend") == "nccl"
              and run["seen"].get("world") == 1,
              f"(11a): process group {run['seen']}")
        steps, evals = run["steps"], run["evals"]
        check(len(steps) == FT_STEPS_PER_EPOCH and len(evals) == 1,
              f"(11a): {len(steps)} steps, {len(evals)} evaluations")
        for c in evals:  # K4 once an evaluated frame, at rank 0
            k4 = c["launches"]["upsample_argmax"]
            check(k4 == c["frames"] > 0, f"(11a): K4 launched {k4} times "
                  f"in an evaluation of {c['frames']} frames")
        for i, s in enumerate(steps):
            p11_launches(f"(11a) step {i}", s, {
                "swin_block_attention": FT_BLOCKS,
                "swin_block_epilogue": FT_BLOCKS, "patch_merge": FT_MERGES,
                "swin_block_attention_bwd": FT_BLOCKS,
                "swin_block_epilogue_bwd": FT_BLOCKS, "upsample_argmax": 0})
            check_gemm_launches(f"(11a) step {i}", s["launches"], s["forms"],
                                m_saved=s["calls"]["m_saved"])
        check(all(math.isfinite(s["loss"]) for s in steps),
              f"(11a) losses {[s['loss'] for s in steps]}")
        ms = [s["ms"] for s in steps]
        med = statistics.median(ms[1:])
        print(f"  (11a) NCCL world of 1 through the CLI: {med:.2f} ms/step "
              f"median of steps 2-{len(ms)} (CUDA events; all "
              f"{[round(v, 1) for v in ms]}), phase 4 without a group "
              f"{STEP_MS.get('train', float('nan')):.2f} ms/step; launches "
              f"a step {steps[-1]['launches']}; peak "
              f"{run['peak'] / 2**30:.2f} GiB on {smi}", flush=True)
        out["per_ddp_step"] = steps[-1]["launches"]
        launches["parallel_cli"] = {
            k: sum(s["launches"][k] for s in steps + evals)
            for k in wrappers}
        torch.cuda.empty_cache()

        # (b) and (c)
        for stage, variants in (("seg", P11_SEG_VARIANTS),
                                ("contrast", P11_CONTRAST_VARIANTS),
                                ("seg_fp32", P11_F32_VARIANTS)):
            t0 = time.perf_counter()
            runs, zero_grad = p11_one_process(stage, dev, bf16)
            torch.cuda.empty_cache()
            outs = p11_spawn(stage, tmp)
            print(f"  {p11_tag(stage)} {P11_RANKS} ranks "
                  f"on {outs[0]['device']} over {outs[0]['backend']}: the "
                  f"library loaded in {[round(o['load_s'], 2) for o in outs]}"
                  f" s, built by a rank: "
                  f"{[o['built_here'] for o in outs]}", flush=True)
            p11_hold(stage, outs, tmp, runs, zero_grad, variants)
            sound = [o["sound"] for o in outs]
            f32_rec = 0
            if stage == "seg_fp32":
                want, m_saved = F32_STEP, 0
                f32_rec = FT_BLOCKS - FT_M_SAVED
            elif stage == "seg":
                want = {"swin_block_attention": FT_BLOCKS,
                        "swin_block_epilogue": FT_BLOCKS,
                        "patch_merge": FT_MERGES,
                        "swin_block_attention_bwd": FT_BLOCKS,
                        "swin_block_epilogue_bwd": FT_BLOCKS}
                m_saved = FT_M_SAVED
            else:
                # 6 key and 2 query forwards of 14 block calls, 2 x 14
                # with grad; a patch merge a forward
                want = {"swin_block_attention": 8 * FT_BLOCKS,
                        "swin_block_epilogue": 8 * FT_BLOCKS,
                        "patch_merge": 8 * FT_MERGES,
                        "swin_block_attention_bwd": 2 * FT_BLOCKS,
                        "swin_block_epilogue_bwd": 2 * FT_BLOCKS}
                m_saved = 2 * FT_M_SAVED
            for r, s in enumerate(sound):
                p11_launches(f"{p11_tag(stage)} rank {r}", s, want)
                for k, n in s["launches"].items():
                    check(n == 0 or k in want or k in GEMM_ROWS,
                          f"{p11_tag(stage)} rank {r}: {k} launched {n} "
                          "times")
                check_gemm_launches(f"(11 {stage}) rank {r}", s["launches"],
                                    s["forms"], m_saved=m_saved,
                                    f32_recomputed=f32_rec)
            key = f"parallel_{stage}"
            launches[key] = {k: sum(s["launches"][k] for s in sound)
                             for k in wrappers}
            out[f"per_rank_{stage}_step"] = sound[0]["launches"]
            print(f"  {p11_tag(stage)} launches a rank "
                  f"{sound[0]['launches']}", flush=True)
            if stage == "seg":
                for r, s in enumerate(sound):
                    full = statistics.median(s["ms"])
                    bare = statistics.median(s["ms_no_sync"])
                    print(f"  (11b) rank {r}: {full:.1f} ms/step (host clock,"
                          f" synchronised; {[round(v, 1) for v in s['ms']]}),"
                          f" {bare:.1f} without the gradient all-reduce "
                          f"(DDP no_sync): the all-reduce "
                          f"{(full - bare) / full:.1%} of the step; peak "
                          f"{s['peak'] / 2**30:.2f} GiB; gloo through host "
                          f"memory, two ranks on one card: not a multi-GPU "
                          f"rate; on {smi}", flush=True)
            del runs
            torch.cuda.empty_cache()
            if stage == "seg_fp32":
                print(f"  (11e) fp32, {P11_RANKS} ranks at batch 4 each on "
                      f"one card: peaks {[round(s['peak'] / 2**30, 2) for s in sound]}"
                      f" GiB on {smi}", flush=True)
            print(f"  {p11_tag(stage)} "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    # (d)
    p11_second_device(dev, bf16)
    return out


def p11_second_device(dev, bf16) -> None:
    """(d): where the machine has a second card, one train step of a
    full-width TswinPlus at batch 2 on cuda:1 on the kernel route (K1-K3
    forward from this thread, K5 and K6 from autograd's device thread of
    cuda:1) against the plain route there: the loss within TOL_TRAIN_LOSS
    and each gradient cosine at or above TOL_GRAD_COS_FLOOR."""
    import torch
    from stswincl_tpu_torch.train.train_seg import make_seg_train_step
    from stswincl_tpu_torch.pipelines.seg import make_tx
    if torch.cuda.device_count() < 2:
        print("  (11d) cuda:1 check not run: 1 device", flush=True)
        return
    dev1 = torch.device("cuda", 1)
    images, labels = seeded_batch(2, seed=P11_SEG_SEED)
    x = torch.from_numpy(images).to(dev1)
    y = torch.from_numpy(labels).to(dev1).long()
    results = []
    with torch.cuda.device(dev1):
        for kern in (None, False):
            model, cfg = p11_seg_model(dev1, bf16, kernels=kern)
            opt, schedule = make_tx(cfg, 1, model)
            step = make_seg_train_step(model, opt, schedule, cfg.loss)
            grads = {}
            opt.register_step_pre_hook(lambda *_: grads.update(
                {n: p.grad.detach().float().clone()
                 for n, p in model.named_parameters()}))
            results.append((float(step(x, y)["loss"]), grads))
            del model, step, opt
    (lk, gk), (lp, gp) = results
    cos = cosines_of(gk, gp)
    worst = min(cos.items(), key=lambda kv: kv[1])
    print(f"  (11d) cuda:1: loss kernel route {lk:.6f} plain {lp:.6f}, the "
          f"lowest gradient cosine {worst}", flush=True)
    check(abs(lk - lp) <= TOL_TRAIN_LOSS * abs(lp), f"(11d) cuda:1 loss "
          f"{lk} against {lp}")
    check(worst[1] >= TOL_GRAD_COS_FLOOR, f"(11d) cuda:1 gradient {worst}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cli-rank"]:  # phase 11 (a)'s rank, by torchrun
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        p11_cli_rank(sys.argv[2], sys.argv[3:])
    else:
        main()
