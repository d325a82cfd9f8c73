"""Seeded PyTorch-default initialisation of the port's models.

Counterpart of `stswincl_tpu/models/init.py`: weights and biases of convs
and dense layers ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in))
(`torch_conv_kernel_init`, `torch_dense_kernel_init`, `torch_bias_init`;
the contrastive encoder's 1x1-conv projector and predictor included, whose
bias bound is their input width's, as `MLP2d` draws it), LayerNorm and
BatchNorm at identity, relative-position tables ~ N(0, 0.02) truncated at
two standard deviations. Every draw comes from the given
`torch.Generator`, so a seed fixes the weights. The JAX package's own
weights reach the port through `ckpt/from_jax.py` instead.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from stswincl_tpu_torch.models.layers import Conv, Dense
from stswincl_tpu_torch.models.swin import WindowAttention


def _uniform_(t: torch.Tensor, bound: float, g: torch.Generator) -> None:
    t.copy_(torch.rand(t.shape, generator=g) * (2 * bound) - bound)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every Conv, Dense and relative-bias table of `model` in
    place (on the CPU generator, so the result is device-independent)."""
    for mod in model.modules():
        if isinstance(mod, (Conv, Dense)):
            w = mod.weight
            fan_in = w[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            _uniform_(w, bound, generator)
            if mod.bias is not None:
                _uniform_(mod.bias, bound, generator)
        if isinstance(mod, WindowAttention):
            t = torch.randn(mod.relative_position_bias_table.shape,
                            generator=generator)
            while (bad := t.abs() > 2.0).any():
                t[bad] = torch.randn(int(bad.sum()), generator=generator)
            mod.relative_position_bias_table.copy_(t * 0.02)
    return model
