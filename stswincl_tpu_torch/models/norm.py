"""BatchNorm with the JAX package's constants and flax's semantics.

Counterpart of `stswincl_tpu/models/norm.py` and of flax's
`nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)` (flax 0.12.3,
`_compute_stats` / `_normalize`). The mode follows `module.train()` /
`.eval()`:

  * eval: the running statistics normalise (`use_running_average=True`);
  * train: the batch statistics over every axis but the channel one, in
    fp32, the variance as E[x^2] - E[x]^2 clipped at 0 (biased), normalise
    the output, and the running statistics move by
    `ra = 0.9 * ra + 0.1 * batch` with that biased variance.

`F.batch_norm` cannot stand in: it updates the running variance with the
unbiased estimate.

Synchronised train mode (`parallel.sync_batchnorm` sets `process_group`):
the sums of x and x^2 and the count are all-reduced over the ranks in
fp32, differentiably, so every rank normalises by, and moves its running
statistics by, the statistics of the global batch, as the JAX step over a
sharded batch does. Without a group the local path runs unchanged.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from stswincl_tpu_torch.parallel.collectives import \
    cross_replica_batch_norm_stats

BN_EPSILON = 1e-5
BN_MOMENTUM = 0.9  # flax convention: ra = momentum * ra + (1 - momentum) * batch


class BatchNorm(nn.Module):
    """BatchNorm over the last (channel) axis of an NHWC tensor, in fp32:
    (x - mean) * (rsqrt(var + eps) * scale) + bias, flax's order.
    Returns fp32; callers cast back to their compute dtype."""

    def __init__(self, features: int, eps: float = BN_EPSILON):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.process_group = None  # set by parallel.sync_batchnorm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training:
            if self.process_group is None:
                dims = tuple(range(x.dim() - 1))
                mean = x.mean(dims)
                var = (x * x).mean(dims) - mean * mean
            else:
                mean, var = cross_replica_batch_norm_stats(
                    x, self.process_group)
            var = torch.clamp(var, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(BN_MOMENTUM).add_(
                    mean.detach(), alpha=1.0 - BN_MOMENTUM)
                self.running_var.mul_(BN_MOMENTUM).add_(
                    var.detach(), alpha=1.0 - BN_MOMENTUM)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias
