"""Stage-1 / stage-3 segmentation training.

Counterpart of `stswincl_tpu/pipelines/seg.py`, after `seg18/train_swin.py:
67-272` / `train_CL_ft_mswin_sgd_minput.py:80-309`: `make_tx` (the JAX
`_make_tx`) builds the optimizer and its per-step schedule; `_warm_start`
applies a configured warm start (a torchvision ImageNet ResNet18, a
reference `.pth`, a stage-2 checkpoint, or a previous segmentation run);
`run_seg_training` runs the epoch loop with an evaluation every
`eval_every` epochs, the latest and best-IoU checkpoints, early stopping
and `resume`; `train_steps` takes N steps from any iterable of batches.
The configs are the port's copies (`stswincl_tpu_torch/configs.py`).

Under torchrun (`parallel.initialize_distributed`) each rank takes its
shard of every global batch, the BatchNorms are synced and the model is
DDP-wrapped, so the ranks take the JAX package's global-batch step.
Rank 0 evaluates and writes the checkpoints; its IoU is broadcast, so
every rank takes the same early-stop decision. The other ranks wait in
that broadcast for the whole evaluation, so the group's collective
timeout (`parallel.distributed.collective_timeout`, an hour unless
`STSWIN_DIST_TIMEOUT` says otherwise) must exceed it: the evaluation is
not sharded over the ranks, because the streamed evaluation carries its
state frame to frame through each sequence.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Iterable, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from stswincl_tpu_torch.ckpt.checkpoint import (_merge, latest_step,
                                                load_checkpoint,
                                                save_checkpoint,
                                                translate_pretrain_to_seg)
from stswincl_tpu_torch.ckpt.torch_import import (import_reference,
                                                  import_torchvision_resnet18,
                                                  load_torch_file)
from stswincl_tpu_torch.configs import SegTrainConfig, to_json
from stswincl_tpu_torch.pipelines.common import (build_loader, build_model,
                                                 build_seg_dataset,
                                                 init_model_variables,
                                                 resolve_device)
from stswincl_tpu_torch.pipelines.evaluate import (eval_resolution,
                                                   evaluate_split)
from stswincl_tpu_torch.parallel import (broadcast, data_parallel,
                                         initialize_distributed, rank,
                                         sync_batchnorm)
from stswincl_tpu_torch.train.optim import (Schedule, constant_schedule,
                                            make_adam, make_sgd,
                                            poly_schedule, step_schedule,
                                            warmup_cosine_schedule)
from stswincl_tpu_torch.train.train_seg import (SegTrainStep,
                                                make_seg_eval_step,
                                                make_seg_train_step)
from stswincl_tpu_torch.utils.logging import MetricLogger, setup_logger


def _dump_config(cfg) -> None:
    """`config.json` in `cfg.log_dir` at the start of a run, on rank 0
    (`main_pretrain_swinv5.py:251-255`)."""
    if rank() == 0:
        os.makedirs(cfg.log_dir, exist_ok=True)
        with open(os.path.join(cfg.log_dir, "config.json"), "w") as f:
            f.write(to_json(cfg))


def make_tx(cfg: SegTrainConfig, steps_per_epoch: int, model: nn.Module
            ) -> Tuple[torch.optim.Optimizer, Schedule]:
    """The optimizer over `model`'s parameters and its per-step schedule,
    as the configuration names them."""
    total = cfg.num_epochs * steps_per_epoch
    warm = cfg.warmup_epochs * steps_per_epoch
    if cfg.lr_scheduler == "constant":
        schedule = constant_schedule(cfg.lr)
    elif cfg.lr_scheduler == "poly":
        schedule = poly_schedule(cfg.lr, total, warmup_steps=warm)
    elif cfg.lr_scheduler == "cos":
        schedule = warmup_cosine_schedule(cfg.lr, warm, total,
                                          warmup_multiplier=1.0 + 1e-9,
                                          eta_min=0.0)
    elif cfg.lr_scheduler == "step":
        schedule = step_schedule(cfg.lr, steps_per_epoch, lr_step=30)
    else:
        raise ValueError(cfg.lr_scheduler)
    if cfg.optimizer == "adam":
        return make_adam(model.parameters(), cfg.lr), schedule
    return make_sgd(model, cfg.lr, momentum=cfg.momentum,
                    weight_decay=cfg.weight_decay,
                    head_lr_mult=cfg.head_lr_mult), schedule


def train_steps(step: SegTrainStep, batches: Iterable[Mapping],
                n_steps: int, device: torch.device
                ) -> List[Dict[str, float]]:
    """Take `n_steps` steps from `batches` (mappings with "image"
    (B, T, H, W, 3) and "label" (B, H, W), numpy or torch); returns each
    step's metrics as floats. Stops early if the batches run out."""
    metrics = []
    for i, batch in enumerate(batches):
        if i == n_steps:
            break
        images = torch.as_tensor(batch["image"], device=device)
        labels = torch.as_tensor(batch["label"], device=device).long()
        metrics.append(step(images.float(), labels))
    return [{k: float(v) for k, v in m.items()} for m in metrics]


def _warm_start(cfg: SegTrainConfig, model: nn.Module,
                logger: logging.Logger) -> nn.Module:
    """Apply the configured warm start to `model`'s fresh weights in
    place; returns the model.

    `imagenet_checkpoint`: a torchvision resnet18 into the stem, layer1
    and layer2 (`resnet.py:98-102`). Then one of: `torch_checkpoint`, a
    reference `.pth` (segmentation or pretraining) whose encoder subtrees
    load; `pretrain_checkpoint`, a port stage-2 checkpoint whose query
    encoder's subtrees load (`load_model_mswin_CL` semantics); or
    `init_checkpoint`, a port segmentation run merged leaf by leaf where
    the name and shape match (`seg18/utils/LoadModel.py:51-90`). Whatever
    is not loaded keeps its init (the classifier among it, but for
    `init_checkpoint`)."""
    sd = model.state_dict()
    if cfg.imagenet_checkpoint:
        rn, um = import_torchvision_resnet18(
            load_torch_file(cfg.imagenet_checkpoint))
        skipped: List[str] = []
        sd = _merge(sd, {f"resnet.{k}": v for k, v in rn.items()}, skipped)
        logger.info("ImageNet resnet init: %d unmatched, %d skipped",
                    len(um), len(skipped))

    if cfg.torch_checkpoint:
        imported, um = import_reference(cfg.torch_checkpoint)
        sd, skipped = translate_pretrain_to_seg(
            {f"segmentor.{k}": v for k, v in imported.items()}, sd)
        logger.info("torch warm start: %d unmatched keys, %d skipped "
                    "entries", len(um), len(skipped))
    elif cfg.pretrain_checkpoint:
        enc = load_checkpoint(cfg.pretrain_checkpoint)
        if "query" not in enc:
            raise KeyError(f"{cfg.pretrain_checkpoint} holds no stage-2 "
                           f"'query' encoder (keys {sorted(enc)})")
        sd, skipped = translate_pretrain_to_seg(enc["query"], sd)
        logger.info("pretrain warm start: %d entries kept init",
                    len(skipped))
    elif cfg.init_checkpoint:
        prev = load_checkpoint(cfg.init_checkpoint)
        skipped = []
        sd = _merge(sd, prev.get("model", {}), skipped)
        logger.info("seg warm start from %s: %d entries kept init/dropped",
                    cfg.init_checkpoint, len(skipped))
    model.load_state_dict(sd)
    return model


def run_seg_training(cfg: SegTrainConfig, device="cuda") -> float:
    """Train stage 1 or 3 as `cfg` says; returns the best validation IoU.
    Runs on the card unless the caller passes `device="cpu"`; without a
    card it raises. Checkpoints hold {"model", "opt", "step"}: the latest
    one in `cfg.ckpt_dir` after each evaluation, the best IoU's in
    `ckpt_dir/best`; `resume` restarts from the latest at epoch
    step // steps_per_epoch, with the optimizer's state (SGD's momentum
    buffers) and the schedule's step. Under torchrun it joins the process
    group and trains data-parallel (the module docstring); `device`
    'cuda' is then `cuda:LOCAL_RANK`."""
    device = initialize_distributed(resolve_device(device,
                                                   "run_seg_training"))
    logger = setup_logger(cfg.log_dir)
    metrics_log = MetricLogger(cfg.log_dir)
    _dump_config(cfg)
    logger.info("device: %s", device)

    model, num_classes = build_model(cfg.model, cfg.data, device)
    is_cadis = cfg.data.dataset == "cadis"
    train_ds = build_seg_dataset(cfg.data, "train")
    val_ds = build_seg_dataset(cfg.data, "val" if is_cadis else "test")
    train_loader = build_loader(train_ds, cfg.data, shuffle=True)
    steps_per_epoch = train_loader.steps_per_epoch()

    init_model_variables(model, cfg.data)
    _warm_start(cfg, model, logger)
    # the param groups on the module itself: no `module.` prefix
    opt, schedule = make_tx(cfg, steps_per_epoch, model)
    start_step = 0
    if cfg.resume and latest_step(cfg.ckpt_dir) is not None:
        state = load_checkpoint(cfg.ckpt_dir, map_location=device)
        model.load_state_dict(state["model"])
        opt.load_state_dict(state["opt"])
        start_step = int(state["step"])
    # CaDIS trains its ignore label as the last class, which OHEM skips
    train_step = make_seg_train_step(
        data_parallel(sync_batchnorm(model), device), opt, schedule,
        loss_type=cfg.loss, ohem_thresh=cfg.ohem_thresh,
        ignore_index=num_classes - 1 if is_cadis else -1)
    train_step.step = start_step
    start_epoch = start_step // max(steps_per_epoch, 1)
    if start_step:
        logger.info("resumed at epoch %d", start_epoch)

    eval_hw, align = eval_resolution(cfg)
    eval_step = make_seg_eval_step(model, out_hw=eval_hw,
                                   align_corners=align)

    def snapshot() -> Dict:
        return {"model": model.state_dict(), "opt": opt.state_dict(),
                "step": train_step.step}

    best_iou, best_epoch = 0.0, 0
    for epoch in range(start_epoch, cfg.num_epochs):
        t0 = time.time()
        metrics = train_steps(train_step, train_loader.epoch(epoch),
                              steps_per_epoch, device)
        # each step's loss is the global batch's: so is their mean
        loss = float(np.mean([m["loss"] for m in metrics])) if metrics \
            else 0.0
        logger.info("epoch %d: loss %.4f (%.1fs)", epoch, loss,
                    time.time() - t0)
        metrics_log.log(train_step.step, {"train/loss": loss})

        if (epoch + 1) % cfg.eval_every == 0:
            iou = 0.0
            if rank() == 0:
                summary = evaluate_split(model, val_ds, cfg,
                                         eval_step=eval_step)
                iou = summary.get("iou", summary.get("miou", 0.0))
                scalars = {k: v for k, v in summary.items()
                           if isinstance(v, (int, float))}
                metrics_log.log(train_step.step,
                                {f"val/{k}": v for k, v in scalars.items()})
                logger.info("epoch %d: val %s", epoch,
                            {k: round(v, 4) for k, v in scalars.items()})
            iou = float(broadcast(torch.tensor(
                [iou], dtype=torch.float64, device=device))[0])
            save_checkpoint(cfg.ckpt_dir, train_step.step, snapshot())
            if iou > best_iou:
                best_iou, best_epoch = iou, epoch
                save_checkpoint(os.path.join(cfg.ckpt_dir, "best"),
                                train_step.step, snapshot())
            elif epoch - best_epoch >= cfg.early_stop_epochs:
                logger.info("early stop at epoch %d (best %.4f @ %d)",
                            epoch, best_iou, best_epoch)
                break
    metrics_log.close()
    return best_iou
