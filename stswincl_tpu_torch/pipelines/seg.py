"""Stage-1 / stage-3 segmentation training: optimizer set-up and step loop.

Counterpart of `stswincl_tpu/pipelines/seg.py`: `make_tx` is the port of
`_make_tx` (`:61-79`) and reads the shared `SegTrainConfig`
(`stswincl_tpu/configs.py`, standard library only); `train_steps` takes
N steps from any iterable of batches. Evaluation in the loop,
checkpoints, warm starts and the CLI are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Tuple

import torch
import torch.nn as nn

from stswincl_tpu.configs import SegTrainConfig
from stswincl_tpu_torch.train.optim import (Schedule, constant_schedule,
                                            make_adam, make_sgd,
                                            poly_schedule, step_schedule,
                                            warmup_cosine_schedule)
from stswincl_tpu_torch.train.train_seg import SegTrainStep


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
