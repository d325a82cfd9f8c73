"""Supervised segmentation training step (stages 1 and 3) and the eval step.

Counterpart of `stswincl_tpu/train/train_seg.py`: OHEM cross-entropy (or
plain CE, Dice, BCE), computed in fp32 on the model's logits; the model
computes in its own dtype (bf16 on the card) with fp32 parameters, so no
loss scaler is needed; BatchNorm uses batch statistics and updates its
running ones; the LR schedule is applied per step. `make_seg_eval_step`
maps a clip to its class map at the scoring resolution.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from stswincl_tpu_torch.ops.resize import composed_upsample_argmax_cf
from stswincl_tpu_torch.ops.ohem import (ohem_cross_entropy,
                                         ohem_cross_entropy_channels_first,
                                         per_pixel_ce_channels_first)
from stswincl_tpu_torch.train.optim import Schedule, apply_schedule


def _one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """fp32 one-hot; labels outside [0, num_classes) give a zero row, as
    `jax.nn.one_hot` does."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[..., None] == classes).float()


def dice_loss(logits: torch.Tensor, labels: torch.Tensor,
              num_classes: int) -> torch.Tensor:
    """Global soft dice over one-hot targets (`seg18/utils/losses.py:9-14`)
    on (..., C) logits."""
    probs = torch.softmax(logits.float(), dim=-1)
    onehot = _one_hot(labels, num_classes)
    inter = (probs * onehot).sum()
    union = probs.sum() + onehot.sum() + 1e-6
    return 1.0 - 2.0 * inter / union


def bce_loss(logits: torch.Tensor, labels: torch.Tensor, num_classes: int,
             ignore_index: int = -1) -> torch.Tensor:
    """Per-class binary cross-entropy of the softmax against the one-hot
    target, averaged over classes; an ignored class contributes nothing
    (`seg18/utils/losses.py:92-124`)."""
    probs = torch.softmax(logits.float(), dim=-1).clamp(1e-7, 1.0 - 1e-7)
    onehot = _one_hot(labels, num_classes)
    per_class_bce = -(onehot * torch.log(probs)
                      + (1.0 - onehot) * torch.log(1.0 - probs))
    per_class = per_class_bce.reshape(-1, num_classes).mean(dim=0)
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
    (`train_swin.py:123`)."""

    def __init__(self, model: nn.Module, opt: torch.optim.Optimizer,
                 schedule: Optional[Schedule] = None,
                 loss_type: str = "ohem", ohem_n_min: Optional[int] = None,
                 ohem_thresh: float = 0.7, ignore_index: int = -1):
        if loss_type not in ("ohem", "ce", "dice", "bce"):
            raise ValueError(f"unknown loss_type {loss_type!r}")
        self.model, self.opt, self.schedule = model, opt, schedule
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
              and getattr(self.model, "channels_first_loss", False))
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
                    self.ignore_index)
            return ohem_cross_entropy(logits, labels, n_min,
                                      self.ohem_thresh, self.ignore_index)
        if self.loss_type == "ce":
            valid = labels != self.ignore_index
            lcf = logits if cf else logits.permute(0, 3, 1, 2)
            ce = per_pixel_ce_channels_first(lcf, labels, self.ignore_index)
            return ce.sum() / valid.sum().clamp(min=1)
        if self.loss_type == "dice":
            return dice_loss(logits, labels, logits.shape[-1])
        return bce_loss(logits, labels, logits.shape[-1], self.ignore_index)

    def __call__(self, images: torch.Tensor,
                 labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        self.model.train()
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss(images, labels)
        loss.backward()
        grads = [p.grad for p in self.model.parameters()
                 if p.grad is not None]
        grad_norm = torch.sqrt(sum(g.float().pow(2).sum() for g in grads))
        if self.schedule is not None:
            apply_schedule(self.opt, self.schedule, self.step)
        self.opt.step()
        self.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm}


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
