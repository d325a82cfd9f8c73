"""Supervised segmentation training step (stages 1 and 3) and the eval step.

Counterpart of `stswincl_tpu/train/train_seg.py`: OHEM cross-entropy (or
plain CE, Dice, BCE), computed in fp32 on the model's logits; the model
computes in its own dtype (bf16 on the card) with fp32 parameters, so no
loss scaler is needed; BatchNorm uses batch statistics and updates its
running ones; the LR schedule is applied per step. `make_seg_eval_step`
maps a clip to its class map at the scoring resolution.

Under a process group the step's model is a DDP wrap
(`parallel.data_parallel`) and the step is the JAX package's over the
global batch: every loss reduces its sums and counts over the wrap's
group (OHEM's selection, CE's valid count, dice's three sums, BCE's
per-class sums and row count), so each rank's loss is the global loss,
the same on every rank, and DDP's mean of the gradients is its gradient.
A step under a process group of more than one rank whose model is not
wrapped would train each rank on its shard alone: it raises.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from stswincl_tpu_torch.ops.resize import composed_upsample_argmax_cf
from stswincl_tpu_torch.parallel import distributed as pdist
from stswincl_tpu_torch.parallel.collectives import sum_over
from stswincl_tpu_torch.parallel.mesh import is_data_parallel, unwrap
from stswincl_tpu_torch.ops.ohem import (ohem_cross_entropy,
                                         ohem_cross_entropy_channels_first,
                                         per_pixel_ce_channels_first)
from stswincl_tpu_torch.train.optim import Schedule, apply_schedule


def _one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """fp32 one-hot; labels outside [0, num_classes) give a zero row, as
    `jax.nn.one_hot` does."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[..., None] == classes).float()


def cross_entropy_loss(logits_cf: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = -1, group=None) -> torch.Tensor:
    """Plain CE on (B, C, H, W) logits: the mean over the valid pixels (of
    the ranks' batches together with `group`)."""
    ce = per_pixel_ce_channels_first(logits_cf, labels, ignore_index)
    total = sum_over(ce.sum(), group)
    count = sum_over((labels != ignore_index).sum(), group)
    return total / count.clamp(min=1)


def dice_loss(logits: torch.Tensor, labels: torch.Tensor,
              num_classes: int, group=None) -> torch.Tensor:
    """Global soft dice over one-hot targets (`seg18/utils/losses.py:9-14`)
    on (..., C) logits; with `group`, over the ranks' batches together."""
    probs = torch.softmax(logits.float(), dim=-1)
    onehot = _one_hot(labels, num_classes)
    inter, psum, osum = sum_over(torch.stack([
        (probs * onehot).sum(), probs.sum(), onehot.sum()]), group)
    union = psum + osum + 1e-6
    return 1.0 - 2.0 * inter / union


def bce_loss(logits: torch.Tensor, labels: torch.Tensor, num_classes: int,
             ignore_index: int = -1, group=None) -> torch.Tensor:
    """Per-class binary cross-entropy of the softmax against the one-hot
    target, averaged over classes; an ignored class contributes nothing
    (`seg18/utils/losses.py:92-124`). With `group`, each class's mean is
    over the ranks' pixels together."""
    probs = torch.softmax(logits.float(), dim=-1).clamp(1e-7, 1.0 - 1e-7)
    onehot = _one_hot(labels, num_classes)
    per_class_bce = -(onehot * torch.log(probs)
                      + (1.0 - onehot) * torch.log(1.0 - probs))
    rows = per_class_bce.reshape(-1, num_classes)
    per_class = sum_over(rows.sum(dim=0), group) / sum_over(
        rows.new_tensor(float(rows.shape[0])), group)
    if 0 <= ignore_index < num_classes:
        mask = torch.ones(num_classes, device=logits.device)
        mask[ignore_index] = 0.0
        per_class = per_class * mask
    return per_class.sum() / num_classes


class SegTrainStep:
    """One supervised step: (images (B, T, H, W, 3), labels (B, H, W)) ->
    {"loss", "grad_norm"} (0-d fp32 tensors on the model's device); it
    updates the parameters, the BatchNorm running statistics and `step`.
    `ohem_n_min` defaults to the reference's per-image H * W / 16
    (`train_swin.py:123`), for the global batch under a process group as
    in the JAX step. `model` may be a DDP wrap (`parallel.data_parallel`):
    the losses then reduce over its group, and the optimizer's param
    groups are built on the module it wraps, so names carry no
    `module.` prefix."""

    def __init__(self, model: nn.Module, opt: torch.optim.Optimizer,
                 schedule: Optional[Schedule] = None,
                 loss_type: str = "ohem", ohem_n_min: Optional[int] = None,
                 ohem_thresh: float = 0.7, ignore_index: int = -1):
        if loss_type not in ("ohem", "ce", "dice", "bce"):
            raise ValueError(f"unknown loss_type {loss_type!r}")
        self.model, self.opt, self.schedule = model, opt, schedule
        self.net = unwrap(model)  # the model's own attributes
        self.group = model.process_group if is_data_parallel(model) \
            else None
        require_reduced(model)
        self.loss_type, self.ohem_n_min = loss_type, ohem_n_min
        self.ohem_thresh, self.ignore_index = ohem_thresh, ignore_index
        self.step = 0

    def loss(self, images: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
        """The training loss of the model in train mode (grad enabled).
        OHEM and CE take channels-first logits from a model whose
        `channels_first_loss` says it makes them (TswinPlus, as the JAX
        step asks every model with a `trunk`); from any other model
        (DeepLabV3Plus) they take its (B, H, W, C) logits."""
        cf = (self.loss_type in ("ohem", "ce")
              and getattr(self.net, "channels_first_loss", False))
        if cf:
            logits = self.model(images, channels_first_logits=True)
        else:
            logits = self.model(images)
        if self.loss_type == "ohem":
            n_min = self.ohem_n_min
            if n_min is None:
                _, h, w = labels.shape
                n_min = h * w // 16
            if cf:
                return ohem_cross_entropy_channels_first(
                    logits, labels, n_min, self.ohem_thresh,
                    self.ignore_index, self.group)
            return ohem_cross_entropy(logits, labels, n_min,
                                      self.ohem_thresh, self.ignore_index,
                                      self.group)
        if self.loss_type == "ce":
            lcf = logits if cf else logits.permute(0, 3, 1, 2)
            return cross_entropy_loss(lcf, labels, self.ignore_index,
                                      self.group)
        if self.loss_type == "dice":
            return dice_loss(logits, labels, logits.shape[-1], self.group)
        return bce_loss(logits, labels, logits.shape[-1], self.ignore_index,
                        self.group)

    def __call__(self, images: torch.Tensor,
                 labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        self.model.train()
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss(images, labels)
        loss.backward()  # DDP's mean all-reduce of the gradients
        grads = [p.grad for p in self.model.parameters()
                 if p.grad is not None]
        grad_norm = torch.sqrt(sum(g.float().pow(2).sum() for g in grads))
        if self.schedule is not None:
            apply_schedule(self.opt, self.schedule, self.step)
        self.opt.step()
        self.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm}


def require_reduced(model: nn.Module) -> None:
    """Raise unless a train step on `model` reduces its gradients: under a
    process group of more than one rank the model must be a DDP wrap."""
    if pdist.world_size() > 1 and not is_data_parallel(model):
        raise ValueError(
            f"a train step under a process group of {pdist.world_size()} "
            "ranks needs its model wrapped by parallel.data_parallel: "
            "unreduced, each rank would train on its own shard")


def make_seg_train_step(model: nn.Module, opt: torch.optim.Optimizer,
                        schedule: Optional[Schedule] = None,
                        loss_type: str = "ohem",
                        ohem_n_min: Optional[int] = None,
                        ohem_thresh: float = 0.7,
                        ignore_index: int = -1) -> SegTrainStep:
    """The train step (port of `make_seg_train_step`)."""
    return SegTrainStep(model, opt, schedule, loss_type, ohem_n_min,
                        ohem_thresh, ignore_index)


def make_seg_eval_step(model: nn.Module,
                       out_hw: Optional[Tuple[int, int]] = None,
                       align_corners: bool = True,
                       head_res_logits: bool = True,
                       exact: Optional[bool] = None) -> Callable:
    """Eval step: a clip (B, T, H, W, 3) (numpy or torch) -> (B, OH, OW)
    int32 class map on the model's device, under `torch.inference_mode()`
    with the model in eval mode.

    EndoVis scores with align_corners=True (`seg18/test.py:155`), CaDIS
    with False (`segcata/cata_test.py:129`). With `head_res_logits`
    (`TswinPlus`) the model returns channels-first head-resolution logits,
    and its upsample to the input resolution is composed with the eval
    resize to `out_hw` into one matrix pair: K4
    (`composed_upsample_argmax_cf`) takes the argmax, which equals the
    argmax of the softmax, and no full-resolution logits are made. False
    is the path of a model without that keyword: its (B, H', W', C)
    logits are resized from their own resolution. `exact` (None: iff the
    model computes in fp32) keeps the resize in fp32."""
    if exact is None:
        exact = getattr(model, "dtype", torch.float32) == torch.float32
    kernels = getattr(model, "kernels", None)

    @torch.inference_mode()
    def eval_step(images) -> torch.Tensor:
        model.eval()
        device = next(model.parameters()).device
        x = torch.as_tensor(images, device=device).float()
        mid = (x.shape[-3], x.shape[-2])
        if head_res_logits:
            lcf = model(x, head_res_logits=True)
            hw = out_hw if out_hw is not None else mid
        else:
            logits = model(x)
            lcf = logits.permute(0, 3, 1, 2)
            mid = tuple(logits.shape[-3:-1])
            hw = out_hw if out_hw is not None else mid
        return composed_upsample_argmax_cf(lcf, mid, hw,
                                           align_out=align_corners,
                                           exact=exact, kernels=kernels)

    return eval_step
