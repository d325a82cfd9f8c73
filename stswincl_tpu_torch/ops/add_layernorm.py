"""Row 14: the residual add and LayerNorm in one pass, and its backward.

Counterpart of `stswincl_tpu/ops/pallas_add_layernorm.py`
(`fused_add_layer_norm`, `add_layer_norm_ref` and the custom VJP
`_faln_bwd`). `add_layer_norm` launches `stswin_add_layer_norm`
(`csrc/add_layernorm.cu`) on a CUDA tensor and runs the plain twin
`add_layer_norm_ref` on a CPU tensor; when autograd needs a gradient it
goes through `AddLayerNormFn`, whose backward is the formula of
`_faln_bwd` (`:128-150`) in plain PyTorch on either device.
"""

from __future__ import annotations

import torch

from stswincl_tpu_torch import kernels
from stswincl_tpu_torch.ops.add_ln_mlp import layer_norm_f32
from stswincl_tpu_torch.ops.layernorm import layer_norm_bwd_f32


def add_layer_norm_ref(x, y, scale, bias, eps: float = 1e-5,
                       return_sum: bool = True):
    """(x + y, LayerNorm(x + y)) with fp32 statistics, both rounded to x's
    dtype; (None, LayerNorm(x + y)) without `return_sum`."""
    s32 = x.float() + y.float()
    n = layer_norm_f32(s32, scale, bias, eps).to(x.dtype)
    return (s32.to(x.dtype) if return_sum else None), n


def _kernel(x, y, scale, bias, eps, return_sum):
    """Launch row 14."""
    name = "add_layer_norm"
    kernels.require(x.is_cuda, lambda: f"{name}: no kernel for device "
                    f"{x.device}")
    kernels.require_bf16_cuda(name, x, y)
    kernels.require_f32(name, scale, bias)
    kernels.require_on(x.device, name, x, y, scale, bias)
    C = x.shape[-1]
    kernels.require(y.shape == x.shape and scale.shape == (C,)
                    and bias.shape == (C,),
                    lambda: f"{name}: x {tuple(x.shape)}, y {tuple(y.shape)},"
                    f" scale {tuple(scale.shape)}, bias {tuple(bias.shape)}")
    kernels.require(C % 256 == 0 and C <= 2048,
                    lambda: f"{name}: needs C a multiple of 256 up to 2048, "
                    f"got {C}")
    out = torch.empty_like(x)
    s = torch.empty_like(x) if return_sum else None
    P = kernels.ptr
    kernels.launch("stswin_add_layer_norm", x.device, P(x), P(y), P(scale),
                   P(bias), P(s), P(out), x.numel() // C, C, float(eps))
    add_layer_norm.launches += 1
    return s, out


def _forward(x, y, scale, bias, eps, return_sum):
    if x.device.type == "cpu":
        return add_layer_norm_ref(x, y, scale, bias, eps, return_sum)
    return _kernel(x, y, scale, bias, eps, return_sum)


def add_layer_norm(x, y, scale, bias, eps: float = 1e-5,
                   return_sum: bool = True):
    """Pallas row 14 (`pallas_add_layernorm.py:110`): x, y (..., C) in one
    dtype, scale and bias (C,) fp32. Returns (x + y, LayerNorm(x + y)),
    or (None, LayerNorm(x + y)) without `return_sum`."""
    args = (x, y, scale, bias, eps, return_sum)
    if kernels.needs_grad(x, y, scale, bias):
        out = AddLayerNormFn.apply(*args)
        return out if return_sum else (None, out)
    return _forward(*args)


add_layer_norm.launches = 0


def add_layer_norm_bwd(x, y, scale, gs, gn, eps: float = 1e-5):
    """The gradients (dx, dy, dscale, dbias) of `add_layer_norm` given the
    output gradients gs (of the sum, or None) and gn (of the norm): the
    formula of `_faln_bwd` (`layer_norm_bwd_f32`) plus gs, in fp32, each
    returned in its input's dtype."""
    ds, dscale, dbias = layer_norm_bwd_f32(x.float() + y.float(), scale,
                                           gn.float(), eps)
    if gs is not None:
        ds = ds + gs.float()
    return (ds.to(x.dtype), ds.to(y.dtype), dscale.to(scale.dtype),
            dbias.to(scale.dtype))


class AddLayerNormFn(torch.autograd.Function):
    """Row 14: the kernel forward on CUDA (the twin on the CPU) returning
    (sum, norm) with `return_sum`, else the norm alone; backward
    `add_layer_norm_bwd`."""

    @staticmethod
    def forward(ctx, x, y, scale, bias, eps, return_sum):
        ctx.cfg = (eps, return_sum)
        ctx.save_for_backward(x, y, scale)
        s, n = _forward(x, y, scale, bias, eps, return_sum)
        return (s, n) if return_sum else n

    @staticmethod
    def backward(ctx, *grads):
        eps, return_sum = ctx.cfg
        x, y, scale = ctx.saved_tensors
        gs, gn = grads if return_sum else (None, grads[0])
        return (*add_layer_norm_bwd(x, y, scale, gs, gn, eps), None, None)
