"""Stage-2 inter-video contrastive pretraining: the entry point.

Counterpart of `stswincl_tpu/pipelines/contrast.py` (`:42-118`), after the
reference's `main_pretrain_swinv5.py:106-196`: a seeded `ContrastEncoder`,
optionally warm-started from a stage-1 segmentation checkpoint
(`translate_seg_to_pretrain`), LARS on the linearly scaled LR and the
warmup-cosine schedule stepped per iteration, the epoch loop, periodic and
final checkpoints of the whole state, and `resume` from the latest one.

Under torchrun each rank takes its shard of every global batch, both
encoders' BatchNorms are synced, the query encoder is DDP-wrapped and
rank 0 writes the checkpoints (`pipelines/seg.py` does the same). The LR
scales by the number of hosts (`parallel.host_count`), as the JAX package
scales by `jax.process_count()`: ranks on one machine share its LR.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from stswincl_tpu_torch.ckpt.checkpoint import (latest_step, load_checkpoint,
                                                save_checkpoint,
                                                translate_seg_to_pretrain)
from stswincl_tpu_torch.configs import ContrastTrainConfig
from stswincl_tpu_torch.data.cadis import CADIS_CLASS_NUM
from stswincl_tpu_torch.models.init import init_weights
from stswincl_tpu_torch.models.pixpro import ContrastEncoder
from stswincl_tpu_torch.parallel import (data_parallel, host_count,
                                         initialize_distributed, replicate,
                                         sync_batchnorm)
from stswincl_tpu_torch.pipelines.common import (build_contrast_dataset,
                                                 build_loader, resolve_device,
                                                 resolve_dtype)
from stswincl_tpu_torch.pipelines.seg import _dump_config
from stswincl_tpu_torch.train.optim import (make_lars, scale_lr_linear,
                                            warmup_cosine_schedule)
from stswincl_tpu_torch.train.train_contrast import (ContrastTrainState,
                                                     make_contrast_train_step)
from stswincl_tpu_torch.utils.logging import MetricLogger, setup_logger


def build_contrast_encoder(cfg: ContrastTrainConfig, class_num: int,
                           device) -> ContrastEncoder:
    """The encoder the config names, weights seeded from `cfg.data.seed`,
    on `device`. Both dtypes run the kernels on a CUDA device on every
    `attn_impl` (`kernels=None`; fp32 on the fp32 forms of K1-K3, K5 and
    K6, and of rows 10 and 11 on their routes)."""
    dtype = resolve_dtype(cfg.model.dtype)
    model = ContrastEncoder(
        class_num, swin_dim=cfg.model.swin_dim, num_heads=cfg.model.num_heads,
        with_instance=cfg.pixpro_ins_loss_weight > 0,
        swin_depths=tuple(cfg.model.swin_depths), dtype=dtype,
        input_hw=tuple(cfg.data.crop_hw),
        attn_impl=cfg.model.attn_impl)
    init_weights(model, torch.Generator().manual_seed(cfg.data.seed))
    return model.to(device)


def contrast_lr(cfg: ContrastTrainConfig) -> float:
    """The base LR scaled linearly by the global batch and the number of
    hosts (`stswincl_tpu/pipelines/contrast.py:79-80`)."""
    return scale_lr_linear(cfg.base_lr, cfg.data.batch_size, host_count())


def run_contrast_pretraining(cfg: ContrastTrainConfig,
                             device="cuda") -> ContrastTrainState:
    """Train stage 2 as `cfg` says and return the final state. Runs on the
    card unless the caller passes `device="cpu"`; without a card it raises.

    `cfg.init_checkpoint`: a port checkpoint directory whose latest step
    holds the stage-1 model's `state_dict` under "model"; its encoder
    subtrees initialise the encoder's `segmentor` (both branches). Under
    torchrun it joins the process group and trains data-parallel (the
    module docstring)."""
    device = initialize_distributed(resolve_device(
        device, "run_contrast_pretraining"))
    logger = setup_logger(cfg.log_dir)
    metrics_log = MetricLogger(cfg.log_dir)
    _dump_config(cfg)

    class_num = (CADIS_CLASS_NUM[cfg.data.tag]
                 if cfg.data.dataset == "cadis" else cfg.data.num_classes)
    model = build_contrast_encoder(cfg, class_num, device)

    dataset = build_contrast_dataset(cfg.data)
    loader = build_loader(dataset, cfg.data, shuffle=True)
    steps_per_epoch = loader.steps_per_epoch()
    total_steps = cfg.num_epochs * steps_per_epoch

    if cfg.init_checkpoint:
        seg = load_checkpoint(cfg.init_checkpoint)["model"]
        sd, skipped = translate_seg_to_pretrain(seg, model.state_dict())
        model.load_state_dict(sd)
        logger.info("warm start from %s (%d entries kept their init)",
                    cfg.init_checkpoint, len(skipped))

    lr = contrast_lr(cfg)
    schedule = warmup_cosine_schedule(
        lr, cfg.warmup_epochs * steps_per_epoch, total_steps,
        warmup_multiplier=cfg.warmup_multiplier)
    state = ContrastTrainState.create(
        model, lambda params: make_lars(params, schedule,
                                        weight_decay=cfg.weight_decay,
                                        trust_coefficient=cfg.lars_trust_coef))
    start_epoch = 0
    if cfg.resume and latest_step(cfg.ckpt_dir) is not None:
        state.load_state_dict(load_checkpoint(cfg.ckpt_dir,
                                              map_location=device))
        start_epoch = state.step // max(steps_per_epoch, 1)
        logger.info("resumed at step %d (epoch %d)", state.step, start_epoch)

    # after `create`'s deepcopy of the query: a process group does not copy
    sync_batchnorm(state.query)
    replicate(sync_batchnorm(state.key))
    train_step = make_contrast_train_step(
        state, class_num=class_num, total_steps=total_steps,
        base_momentum=cfg.momentum,
        ins_loss_weight=cfg.pixpro_ins_loss_weight,
        query=data_parallel(state.query, device))

    for epoch in range(start_epoch, cfg.num_epochs):
        t0 = time.time()
        losses, m = [], None
        for batch in loader.epoch(epoch):
            clips = torch.as_tensor(batch["clips"]).to(device)
            labels = torch.as_tensor(batch["labels"]).to(device).long()
            m = train_step(clips, labels)
            losses.append(m["loss"])
        loss = float(np.mean([float(v) for v in losses])) if losses else 0.0
        logger.info("epoch %d: loss %.4f (%.1fs)", epoch, loss,
                    time.time() - t0)
        if m is not None:
            metrics_log.log(state.step, {"pretrain/loss": loss,
                                         "pretrain/momentum":
                                             float(m["momentum"])})
        if ((epoch + 1) % cfg.save_every_epochs == 0
                or epoch == cfg.num_epochs - 1):
            save_checkpoint(cfg.ckpt_dir, state.step, state.state_dict())
    metrics_log.close()
    return state
