"""Online hard-example-mining cross entropy (plain PyTorch).

Counterpart of `stswincl_tpu/ops/ohem.py`. The reference
(`seg18/utils/losses.py:16-40`) keeps every pixel whose CE exceeds
-log(thresh) when the (n_min + 1)-th largest CE does, else exactly the
n_min largest, and returns the mean of what it kept. Both branches are
computed as masked means over the whole loss vector and one is selected,
as in the JAX package, so no data-dependent shape arises.
"""

from __future__ import annotations

import math

import torch


def per_pixel_ce_channels_first(logits_cf: torch.Tensor,
                                labels: torch.Tensor,
                                ignore_index: int = -1) -> torch.Tensor:
    """Per-pixel CE map (B, H, W) from (B, C, H, W) logits, in fp32;
    ignored pixels contribute 0."""
    lf = logits_cf.float()
    m = lf.amax(dim=1)
    lse = m + torch.log(torch.exp(lf - m[:, None]).sum(dim=1))
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    picked = lf.gather(1, safe[:, None])[:, 0]
    return torch.where(valid, lse - picked, torch.zeros_like(lse))


def _kth_largest(loss: torch.Tensor, k: int) -> torch.Tensor:
    """The exact k-th largest value (1-indexed) of a flat vector. Like the
    JAX package's bit bisection it carries no gradient."""
    return torch.topk(loss.detach(), k, sorted=False).values.min()


def _ohem_select(loss: torch.Tensor, n_min: int,
                 thresh: float) -> torch.Tensor:
    """OHEM branch selection over a flat per-pixel loss vector (port of
    `_ohem_select`): the threshold branch when more than n_min pixels
    exceed -log(thresh), else the mean of the top n_min with exact tie
    handling (values above the k-th largest v* count themselves, the
    remaining slots are copies of v*)."""
    loss_thresh = math.log(1.0 / thresh)
    loss = torch.maximum(loss, torch.zeros_like(loss))
    hard = loss > loss_thresh
    n_hard = hard.sum()
    zero = torch.zeros_like(loss)
    mean_hard = torch.where(hard, loss, zero).sum() / n_hard.clamp(min=1)
    use_thresh = n_hard > n_min
    vk = _kth_largest(loss, n_min)
    gt = loss > vk
    n_gt = gt.sum()
    sum_topk = torch.where(gt, loss, zero).sum() + (n_min - n_gt) * vk
    return torch.where(use_thresh, mean_hard, sum_topk / n_min)


def ohem_cross_entropy_channels_first(logits_cf: torch.Tensor,
                                      labels: torch.Tensor, n_min: int,
                                      thresh: float = 0.7,
                                      ignore_index: int = -1) -> torch.Tensor:
    """OHEM CE on (B, C, H, W) logits: a scalar fp32 mean."""
    loss = per_pixel_ce_channels_first(logits_cf, labels, ignore_index)
    return _ohem_select(loss.reshape(-1), n_min, thresh)


def ohem_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                       n_min: int, thresh: float = 0.7,
                       ignore_index: int = -1) -> torch.Tensor:
    """OHEM CE on (..., C) logits (classes last)."""
    C = logits.shape[-1]
    flat = logits.reshape(-1, C).float()
    lab = labels.reshape(-1)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab)).long()
    logp = torch.log_softmax(flat, dim=-1).gather(1, safe[:, None])[:, 0]
    loss = torch.where(valid, -logp, torch.zeros_like(logp))
    return _ohem_select(loss, n_min, thresh)
