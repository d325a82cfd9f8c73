"""BatchNorm in eval mode, with the JAX package's constants.

Counterpart of `stswincl_tpu/models/norm.py` and of flax's
`nn.BatchNorm(use_running_average=True, dtype=float32)`: the port serves,
so it keeps running statistics and never updates them.
"""

from __future__ import annotations

import torch
import torch.nn as nn

BN_EPSILON = 1e-5


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over the last (channel) axis of an NHWC tensor,
    in fp32: (x - mean) * (rsqrt(var + eps) * scale) + bias, flax's order.
    Returns fp32; callers cast back to their compute dtype."""

    def __init__(self, features: int, eps: float = BN_EPSILON):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x.float() - self.running_mean) * mul + self.bias
