"""Evaluation: the split protocols and the `test` command.

Counterpart of `stswincl_tpu/pipelines/evaluate.py`, after `seg18/test.py:
136-209` (EndoVis: per-frame Dice / IoU at 1024x1280 with per-sequence and
per-class breakdowns) and `segcata/cata_test.py:48-175` (CaDIS: the
split's confusion matrix, PA / PAC / mIoU at 540x960). The device side
(forward, the composed upsample and the argmax, K4) is one eval step
(`make_seg_eval_step`) or the feature-cached `StreamingSegmenter`; the
metrics accumulate on the host over the int predictions.
"""

from __future__ import annotations

import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch
from PIL import Image

from stswincl_tpu_torch.ckpt.checkpoint import load_checkpoint
from stswincl_tpu_torch.ckpt.torch_import import import_reference
from stswincl_tpu_torch.configs import SegTrainConfig
from stswincl_tpu_torch.data.cadis import CADIS_CLASS_NUM
from stswincl_tpu_torch.data.loader import _seeded_rng
from stswincl_tpu_torch.eval import (ConfusionMatrix, EndovisEvaluator,
                                     mean_iou, pixel_accuracy,
                                     pixel_accuracy_per_class)
from stswincl_tpu_torch.eval.visualization import (ENDOVIS_COLORMAP,
                                                   save_prediction)
from stswincl_tpu_torch.pipelines.common import (build_model,
                                                 build_seg_dataset,
                                                 resolve_device)
from stswincl_tpu_torch.pipelines.streaming import StreamingSegmenter
from stswincl_tpu_torch.train.train_seg import make_seg_eval_step
from stswincl_tpu_torch.utils.logging import setup_logger

_log = logging.getLogger("stswincl")


def eval_resolution(cfg: SegTrainConfig):
    """(scoring resolution, align_corners of the eval resize): CaDIS
    scores at (540, 960) with half-pixel centres (`cata_test.py:129`)
    where the config keeps EndoVis's default (1024, 1280)."""
    is_cadis = cfg.data.dataset == "cadis"
    eval_hw = tuple(cfg.eval_hw)
    if is_cadis and eval_hw == (1024, 1280):
        eval_hw = (540, 960)
    return eval_hw, not is_cadis


def evaluate_split(model, dataset, cfg: SegTrainConfig, eval_step=None,
                   max_frames: Optional[int] = None,
                   viz_dir: Optional[str] = None,
                   streaming: Optional[bool] = None) -> Dict:
    """Run the eval protocol of `cfg` over `dataset` with `model` (on its
    own device); returns the summary dict.

    `viz_dir` (or `cfg.viz_dir`) dumps each prediction as an RGB PNG (the
    reference's `seg18/test.py:162-169` / `cata_test.py:137-154`).

    `streaming` (default `cfg.streaming_eval`) serves each frame whose clip
    is the previous clip advanced by one slot (`dataset.sliding_from`)
    through `StreamingSegmenter.predict_next`; any other frame (a sequence
    start, the below-`t` fallback clips) takes `init_and_predict`, one
    full-clip forward that also re-seeds the cache. The summary then
    reports `streamed_frames`."""
    viz_dir = viz_dir or cfg.viz_dir
    if viz_dir:
        os.makedirs(viz_dir, exist_ok=True)
    is_cadis = cfg.data.dataset == "cadis"
    if streaming is None:
        streaming = cfg.streaming_eval
    if streaming and not (hasattr(model, "swin_dim")
                          and hasattr(dataset, "sliding_from")):
        _log.warning("streaming_eval: unsupported for %s on %s; full-clip "
                     "eval", type(model).__name__, type(dataset).__name__)
        streaming = False
    # the streaming segmenter and a caller's eval_step must agree on the
    # prediction's resolution
    eval_hw, align_out = eval_resolution(cfg)
    segmenter = (StreamingSegmenter(model, out_hw=eval_hw,
                                    align_out=align_out)
                 if streaming else None)
    if eval_step is None:
        eval_step = make_seg_eval_step(model, out_hw=eval_hw,
                                       align_corners=align_out)
    if is_cadis:
        cm = ConfusionMatrix(CADIS_CLASS_NUM[cfg.data.tag] - 1)  # no ignore
    else:
        evaluator = EndovisEvaluator(num_classes=cfg.data.num_classes)
    model.eval()
    device = next(model.parameters()).device

    n = len(dataset)
    if max_frames is not None:
        n = min(n, max_frames)
    timings = []
    cache, prev_path, streamed = None, None, 0

    # decode sample i + 1 on the host (PIL dominates the host's cost)
    # while the card runs frame i
    pool = ThreadPoolExecutor(max_workers=1)
    try:
        nxt = pool.submit(dataset.get, 0, _seeded_rng(0, 0, 0)) if n else None
        for i in range(n):
            try:
                sample = nxt.result()
            except Exception as e:
                # otherwise a prefetch error would surface one frame late
                raise RuntimeError(
                    f"prefetch of eval sample {i} failed") from e
            if i + 1 < n:
                nxt = pool.submit(dataset.get, i + 1,
                                  _seeded_rng(0, 0, i + 1))
            label = sample["label"]
            tic = time.perf_counter()
            clip = torch.from_numpy(sample["image"][None]).to(device)
            path = sample.get("path")
            if (segmenter is not None and cache is not None
                    and prev_path is not None and path is not None
                    and dataset.sliding_from(prev_path, path)):
                cache, pred = segmenter.predict_next(cache, clip[:, -1])
                streamed += 1
            elif segmenter is not None:
                cache, pred = segmenter.init_and_predict(clip)
            else:
                pred = eval_step(clip)
            prev_path = path
            pred = pred[0].cpu().numpy()
            timings.append(time.perf_counter() - tic)
            if pred.shape != label.shape:
                # score at the label's resolution (synthetic and val paths
                # whose eval_hw differs from the label's size)
                if i == 0:
                    _log.warning(
                        "evaluate_split: prediction %s resized (nearest) to "
                        "label %s; protocol deviation from eval_hw=%s",
                        pred.shape, label.shape, cfg.eval_hw)
                pred = np.asarray(
                    Image.fromarray(pred.astype(np.int32), mode="I").resize(
                        (label.shape[1], label.shape[0]), Image.NEAREST))
            if viz_dir:
                name = (f"seq{path[0]}_frame{path[1]}" if path is not None
                        else f"frame{i:05d}")
                save_prediction(
                    os.path.join(viz_dir, name + ".png"), pred,
                    colormap=None if is_cadis else ENDOVIS_COLORMAP,
                    cadis_tag=cfg.data.tag if is_cadis else None)
            if is_cadis:
                cm.update(label, pred)
            else:
                evaluator.update(label, pred, int(sample["path"][0]))
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
    if is_cadis:
        miou = mean_iou(cm.matrix)[0]
        summary = {"pa": pixel_accuracy(cm.matrix),
                   "pac": pixel_accuracy_per_class(cm.matrix)[0],
                   "miou": miou, "iou": miou, "frames": n}
    else:
        summary = evaluator.summary()
    summary["sec_per_frame"] = float(np.median(timings)) if timings else 0.0
    if segmenter is not None:
        summary["streamed_frames"] = streamed
    return summary


def run_test(cfg: SegTrainConfig, device="cuda") -> Dict:
    """The `test` command: load a checkpoint and run the test protocol.
    Runs on the card unless the caller passes `device="cpu"`.

    The weights: a reference `.pth` (`cfg.torch_checkpoint`, through
    `ckpt/torch_import.py`), which must cover every entry of the model;
    else the port checkpoint directory `cfg.test_checkpoint`, or
    `cfg.init_checkpoint` (with a warning: that field means a warm start
    in training), or `cfg.ckpt_dir`, whose latest step holds the model's
    `state_dict` under "model", loaded strictly. A missing entry raises:
    no fresh weight is ever evaluated."""
    device = resolve_device(device, "run_test")
    logger = setup_logger(cfg.log_dir)
    model, _ = build_model(cfg.model, cfg.data, device)
    names = list(model.state_dict())
    if cfg.torch_checkpoint:
        imported, unmatched = import_reference(cfg.torch_checkpoint)
        missing = [k for k in names if k not in imported]
        if missing:
            raise KeyError(f"test: {cfg.torch_checkpoint} does not cover "
                           f"{len(missing)} entries of the model, e.g. "
                           f"{missing[:5]}")
        logger.info("test: %s imported, %d keys unmatched",
                    cfg.torch_checkpoint, len(unmatched))
        model.load_state_dict({k: imported[k] for k in names})
    else:
        ckpt_dir = cfg.test_checkpoint or cfg.init_checkpoint or cfg.ckpt_dir
        if cfg.test_checkpoint is None and cfg.init_checkpoint:
            logger.warning("test: loading from init_checkpoint=%s; prefer "
                           "test_checkpoint= for evaluation", ckpt_dir)
        state = load_checkpoint(ckpt_dir)
        if "model" not in state:
            raise KeyError(f"test: the checkpoint in {ckpt_dir} holds no "
                           f"'model' state_dict (keys {sorted(state)})")
        model.load_state_dict(state["model"])

    dataset = build_seg_dataset(cfg.data, "test")
    if cfg.data.dataset == "cadis":
        cfg.eval_hw = (540, 960)
    summary = evaluate_split(model, dataset, cfg)
    logger.info("test summary: %s", summary)
    print({k: (round(v, 4) if isinstance(v, float) else v)
           for k, v in summary.items()})
    return summary
