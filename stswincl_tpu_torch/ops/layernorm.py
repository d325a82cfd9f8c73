"""Row 15: LayerNorm over the last axis, and the `FusedLayerNorm` module.

Counterpart of `stswincl_tpu/ops/pallas_layernorm.py` (`fused_layer_norm`,
`_xla_layer_norm`, the custom VJP `_fln_bwd` and `FusedLayerNorm`).
`fused_layer_norm` launches `stswin_layer_norm` (`csrc/add_layernorm.cu`,
row 14's kernel without y) on a CUDA tensor and runs the plain twin
`layer_norm_ref` on a CPU tensor, for any row width C, as the JAX kernel
takes the whole row (a warp a row for C a multiple of 8 up to 2048, else a
block a row); when autograd needs a gradient it goes
through `LayerNormFn`, whose backward is the formula of `_fln_bwd`
(`:95-112`) in plain PyTorch on either device. Numerics, as the JAX
kernel: fp32 mean, then the mean of squared deviations (two passes, not
E[x^2] - E[x]^2), eps inside the rsqrt, the affine in fp32, the output in
x's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from stswincl_tpu_torch import kernels
from stswincl_tpu_torch.ops.add_ln_mlp import layer_norm_f32


def layer_norm_ref(x, scale, bias, eps: float = 1e-5):
    """Plain twin of row 15 (`_xla_layer_norm`): LayerNorm(x) with fp32
    statistics and affine, rounded to x's dtype."""
    return layer_norm_f32(x.float(), scale, bias, eps).to(x.dtype)


def _kernel(x, scale, bias, eps):
    """Launch row 15."""
    name = "fused_layer_norm"
    kernels.require(x.is_cuda, lambda: f"{name}: no kernel for device "
                    f"{x.device}")
    kernels.require_bf16_cuda(name, x)
    kernels.require_f32(name, scale, bias)
    kernels.require_on(x.device, name, x, scale, bias)
    C = x.shape[-1]
    kernels.require(scale.shape == (C,) and bias.shape == (C,),
                    lambda: f"{name}: x {tuple(x.shape)}, scale "
                    f"{tuple(scale.shape)}, bias {tuple(bias.shape)}")
    kernels.require(C > 0, f"{name}: empty rows")
    out = torch.empty_like(x)
    rows = x.numel() // C
    if rows == 0:
        return out
    P = kernels.ptr
    kernels.launch("stswin_layer_norm", x.device, P(x), P(scale), P(bias),
                   P(out), rows, C, float(eps))
    fused_layer_norm.launches += 1
    return out


def _forward(x, scale, bias, eps):
    if x.device.type == "cpu":
        return layer_norm_ref(x, scale, bias, eps)
    return _kernel(x, scale, bias, eps)


def fused_layer_norm(x, scale, bias, eps: float = 1e-5):
    """Pallas row 15 (`pallas_layernorm.py:82`): x (..., C); scale and bias
    (C,) fp32. Returns LayerNorm(x) in x's shape and dtype."""
    if kernels.needs_grad(x, scale, bias):
        return LayerNormFn.apply(x, scale, bias, eps)
    return _forward(x, scale, bias, eps)


fused_layer_norm.launches = 0


def layer_norm_bwd_f32(s32, scale, g32, eps: float = 1e-5):
    """(ds, dscale, dbias), fp32, of LayerNorm(s32) given its output
    gradient g32: the formula of `_fln_bwd` (and of row 14's `_faln_bwd`),
    the statistics recomputed from s32."""
    mu = s32.mean(dim=-1, keepdim=True)
    xc = s32 - mu
    inv = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    shat = xc * inv
    gsc = g32 * scale.float()
    m1 = gsc.mean(dim=-1, keepdim=True)
    m2 = (gsc * shat).mean(dim=-1, keepdim=True)
    dims = tuple(range(s32.dim() - 1))
    return ((gsc - m1 - shat * m2) * inv, (g32 * shat).sum(dim=dims),
            g32.sum(dim=dims))


class LayerNormFn(torch.autograd.Function):
    """Row 15: the kernel forward on CUDA (the twin on the CPU); backward
    `layer_norm_bwd_f32`, each gradient in its input's dtype."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, scale)
        return _forward(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_bwd_f32(x.float(), scale, g.float(),
                                               ctx.eps)
        return (dx.to(x.dtype), dscale.to(scale.dtype),
                dbias.to(scale.dtype), None)


class FusedLayerNorm(nn.Module):
    """Drop-in LayerNorm over the last axis (`pallas_layernorm.
    FusedLayerNorm`), parameters `weight` and `bias` (fp32), onto which
    `ckpt/from_jax.py` maps the JAX module's `scale` and `bias`.

    The JAX module's `impl` becomes `kernels`: 'xla' is `kernels=False`
    (the plain twin `layer_norm_ref`, autograd through it); 'auto' and
    'pallas' are `kernels=None` on a card (row 15 iff the input is on
    CUDA, else the twin); 'interpret', the Pallas kernel and its custom
    VJP run on the CPU, is `kernels=True` on a CPU tensor
    (`fused_layer_norm`: the twin forward, `LayerNormFn`'s backward). The
    output keeps x's dtype; the JAX module's `dtype` field is unused there
    too."""

    def __init__(self, dim: int, eps: float = 1e-5,
                 kernels: Optional[bool] = None):
        super().__init__()
        self.eps, self.kernels = eps, kernels
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if kernels.use_kernels(self.kernels, x):
            return fused_layer_norm(x, self.weight, self.bias, self.eps)
        return layer_norm_ref(x, self.weight, self.bias, self.eps)
