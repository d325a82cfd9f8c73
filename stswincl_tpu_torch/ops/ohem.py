"""Online hard-example-mining cross entropy (plain PyTorch).

Counterpart of `stswincl_tpu/ops/ohem.py`. The reference
(`seg18/utils/losses.py:16-40`) keeps every pixel whose CE exceeds
-log(thresh) when the (n_min + 1)-th largest CE does, else exactly the
n_min largest, and returns the mean of what it kept. Both branches are
computed as masked means over the whole loss vector and one is selected,
as in the JAX package, so no data-dependent shape arises.

Under a process group (`group`, each rank holding its shard of the
batch) the selection is the JAX package's over the global flattened loss:
the hard count and sum, the (n_min)-th largest value and the counts and
sums above it are global, so every rank returns the same global loss and
takes the same branch. Its sums are all-reduced differentiably
(`parallel.collectives`), so after DDP's mean the gradient is the
global-batch gradient.
"""

from __future__ import annotations

import math

import torch

from stswincl_tpu_torch.parallel.collectives import dist_collect, sum_over


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


def _kth_largest(loss: torch.Tensor, k: int, group=None) -> torch.Tensor:
    """The exact k-th largest value (1-indexed) of a flat vector, or with
    `group` of the ranks' vectors together: the global top k lies within
    the union of each rank's local top k (a rank with fewer values pads
    with -1, below every clamped loss). Like the JAX package's bit
    bisection it carries no gradient."""
    local = loss.detach()
    if group is None:
        return torch.topk(local, k, sorted=False).values.min()
    if local.numel() < k:
        local = torch.cat([local, local.new_full((k - local.numel(),),
                                                 -1.0)])
    top = torch.topk(local, k, sorted=False).values
    return _kth_largest(dist_collect(top, group), k)


def _ohem_select(loss: torch.Tensor, n_min: int, thresh: float,
                 group=None) -> torch.Tensor:
    """OHEM branch selection over a flat per-pixel loss vector (port of
    `_ohem_select`): the threshold branch when more than n_min pixels
    exceed -log(thresh), else the mean of the top n_min with exact tie
    handling (values above the k-th largest v* count themselves, the
    remaining slots are copies of v*). With `group`, over the ranks'
    vectors together: one all-reduce of the counts and one
    (differentiable) of the sums, the tie term added once, after."""
    loss_thresh = math.log(1.0 / thresh)
    loss = torch.maximum(loss, torch.zeros_like(loss))
    hard = loss > loss_thresh
    zero = torch.zeros_like(loss)
    vk = _kth_largest(loss, n_min, group)
    gt = loss > vk
    n_hard, n_gt = sum_over(torch.stack([hard.sum(), gt.sum()]), group)
    sum_hard, sum_gt = sum_over(torch.stack([
        torch.where(hard, loss, zero).sum(),
        torch.where(gt, loss, zero).sum()]), group)
    mean_hard = sum_hard / n_hard.clamp(min=1)
    sum_topk = sum_gt + (n_min - n_gt) * vk
    return torch.where(n_hard > n_min, mean_hard, sum_topk / n_min)


def ohem_cross_entropy_channels_first(logits_cf: torch.Tensor,
                                      labels: torch.Tensor, n_min: int,
                                      thresh: float = 0.7,
                                      ignore_index: int = -1,
                                      group=None) -> torch.Tensor:
    """OHEM CE on (B, C, H, W) logits: a scalar fp32 mean (over the
    ranks' batches together with `group`)."""
    loss = per_pixel_ce_channels_first(logits_cf, labels, ignore_index)
    return _ohem_select(loss.reshape(-1), n_min, thresh, group)


def ohem_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                       n_min: int, thresh: float = 0.7,
                       ignore_index: int = -1,
                       group=None) -> torch.Tensor:
    """OHEM CE on (..., C) logits (classes last)."""
    C = logits.shape[-1]
    flat = logits.reshape(-1, C).float()
    lab = labels.reshape(-1)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab)).long()
    logp = torch.log_softmax(flat, dim=-1).gather(1, safe[:, None])[:, 0]
    loss = torch.where(valid, -logp, torch.zeros_like(logp))
    return _ohem_select(loss, n_min, thresh, group)
