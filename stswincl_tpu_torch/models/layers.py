"""Parameter holders shared by the port's models.

Each holder keeps its parameters in fp32 under the names that
`ckpt/from_jax.py` maps the JAX tree onto (`weight`, `bias`, ...), and
hands out working copies cast to the compute dtype. Where autograd will
want the parameter's gradient, the working copy is a cast in the graph,
made anew each call, so the gradient reaches the fp32 parameter.
Otherwise (serving) it is cast once and reused until the parameter is
replaced or written in place (a `load_state_dict`, a `.to(device)`, an
optimizer step), so a forward pass casts nothing.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class CastCache(nn.Module):
    """Base for holders whose parameters feed kernels in another dtype or
    layout: `working(name, make)` returns `make(param)`, rebuilt only when
    the parameter's storage, device or version changes."""

    def __init__(self):
        super().__init__()
        self._working = {}

    def working(self, name: str, key, make):
        p = getattr(self, name)
        if torch.is_grad_enabled() and p.requires_grad:
            return make(p)
        stamp = (key, p.device, p.data_ptr(), p._version)
        hit = self._working.get((name, key))
        if hit is None or hit[0] != stamp:
            with torch.no_grad():
                hit = (stamp, make(p.detach()))
            self._working[(name, key)] = hit
        return hit[1]


class Dense(CastCache):
    """nn.Dense / torch Linear parameters: weight (out, in), bias (out)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def weight_as(self, dtype: torch.dtype) -> torch.Tensor:
        return self.working("weight", dtype,
                            lambda w: w.to(dtype).contiguous())

    def bias_as(self, dtype: torch.dtype) -> torch.Tensor:
        return self.working("bias", dtype, lambda b: b.to(dtype))


class LayerNormParams(nn.Module):
    """LayerNorm scale (`weight`) and bias; kernels read them in fp32."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class Conv(CastCache):
    """Conv2d with torch's symmetric padding, applied to NHWC tensors.

    `x.permute(0, 3, 1, 2)` of a contiguous NHWC tensor is a channels_last
    NCHW view, and the cached weight is channels_last too, so cuDNN runs
    channels_last with no copy; the result is returned as an NHWC view."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 dilation: int = 1, bias: bool = False):
        super().__init__()
        self.stride, self.dilation = stride, dilation
        self.padding = dilation * (kernel - 1) // 2
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        w = self.working("weight", dtype, lambda t: t.to(
            dtype, memory_format=torch.channels_last))
        b = None
        if self.bias is not None:
            b = self.working("bias", dtype, lambda t: t.to(dtype))
        y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), w, b, self.stride,
                     self.padding, self.dilation)
        return y.permute(0, 2, 3, 1)
