"""K1 and K5: the swin block's attention sub-block (qkv -> windowed joint
space-time attention -> proj) on the image-layout clip, and its backward.

Counterparts of `stswincl_tpu/ops/pallas_block_attention.py`
(`fused_swin_block_attention`, its reference, and
`fused_swin_block_attention_bwd` behind `_fsba_bwd`).
`swin_block_attention` launches K1 (`csrc/block_attention.cu`) on a CUDA
tensor and runs the plain twin `swin_block_attention_ref` on a CPU tensor.
When autograd needs a gradient it goes through `BlockAttentionFn`, whose
backward launches K5 on CUDA (`swin_block_attention_bwd`) and runs the
plain twin `swin_block_attention_bwd_ref` on the CPU.

Weights use the torch Linear layout: wqkv (3C, C), wproj (C, C), in any
float dtype: they are cast to x's dtype for the product, and their
gradients come back in their own dtype from fp32 accumulators. With
`shift` > 0, x is the UNSHIFTED clip and the output stays in the SHIFTED
layout; `swin_block_epilogue(..., shift=shift)` reads it back, and the
output's gradient arrives in that layout too.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from stswincl_tpu_torch import kernels
from stswincl_tpu_torch.ops.attention import attend_tiled


def windowed_attention_image_ref(qkv: torch.Tensor, bias_tiled: torch.Tensor,
                                 mask_tiled: Optional[torch.Tensor],
                                 heads: int, scale: float,
                                 ws: int) -> torch.Tensor:
    """Partition (B, T, H, W, 3C) qkv into frame-joint windows, attend,
    and reverse to (B, T, H, W, C)."""
    B, T, H, W, C3 = qkv.shape
    C = C3 // 3
    hd = C // heads
    nH, nW = H // ws, W // ws
    TN = T * ws * ws
    xw = qkv.reshape(B, T, nH, ws, nW, ws, C3).permute(0, 2, 4, 1, 3, 5, 6)
    xw = xw.reshape(B * nH * nW, TN, 3, heads, hd).permute(2, 0, 3, 1, 4)
    o = attend_tiled(xw[0], xw[1], xw[2], bias_tiled, mask_tiled, scale)
    o = o.permute(0, 2, 1, 3).reshape(B, nH, nW, T, ws, ws, C)
    return o.permute(0, 3, 1, 4, 2, 5, 6).reshape(B, T, H, W, C)


def swin_block_attention_ref(x, wqkv, bqkv, wproj, bproj, bias_tiled,
                             mask_tiled, heads, scale, ws, shift=0):
    """Plain twin of K1 (port of `fused_swin_block_attention_ref`):
    matmul inputs in x's dtype with fp32 accumulation, fp32 bias."""
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(2, 3))
    qkv = F.linear(x.float(), wqkv.float(), bqkv.float()).to(x.dtype)
    attn = windowed_attention_image_ref(qkv, bias_tiled, mask_tiled, heads,
                                        scale, ws)
    return F.linear(attn.float(), wproj.float(), bproj.float()).to(x.dtype)


def swin_block_attention_bwd_ref(x, wqkv, bqkv, wproj, bproj, bias_tiled,
                                 mask_tiled, g, heads, scale, ws, shift=0):
    """Plain twin of K5: autograd of `swin_block_attention_ref`. Returns
    (dx, dwqkv, dbqkv, dwproj, dbproj, dbias_tiled), each in its input's
    dtype; the mask gets no gradient."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_()
                  for t in (x, wqkv, bqkv, wproj, bproj, bias_tiled)]
        out = swin_block_attention_ref(*leaves, mask_tiled, heads, scale, ws,
                                       shift)
        return torch.autograd.grad(out, leaves, g)


def _align(b: int) -> int:
    return (b + 127) // 128 * 128


def _attn_smem_bytes(TN: int, hd: int) -> int:
    """Dynamic shared memory of K1's attention block (`attn_smem` in the
    CUDA source)."""
    return (3 * _align(TN * (hd + 8) * 2)
            + _align(TN * max(TN + 4, hd + 4) * 4)
            + _align(TN * (TN + 8) * 2))


def _attn_bwd_smem_bytes(TN: int, hd: int) -> int:
    """Dynamic shared memory of K5's attention block (`attn_bwd_smem`):
    q, k, dO in bf16, the fp32 P / dS, one bf16 buffer for P / V / dS,
    eight 16x16 fp32 staging tiles and the row sums."""
    return (3 * _align(TN * (hd + 8) * 2) + _align(TN * (TN + 4) * 4)
            + _align(TN * (max(hd, TN) + 8) * 2) + _align(8 * 256 * 4)
            + _align(TN * 4))


def _validate(name, x, wqkv, wproj, bias_tiled, mask_tiled, heads, ws,
              shift, smem_bytes):
    """Check what the CUDA kernels take; return (mask or None, n_mask)."""
    kernels.require(x.is_cuda, f"{name}: no kernel for device {x.device}")
    if mask_tiled is not None and mask_tiled.shape[0] == 1:
        mask_tiled = None
    kernels.require(x.dim() == 5, f"{name}: x must be (B, T, H, W, C)")
    B, T, H, W, C = x.shape
    hd, TN = C // heads, T * ws * ws
    kernels.require_bf16_cuda(name, x)
    kernels.require(wqkv.dtype == x.dtype and wproj.dtype == x.dtype,
                    f"{name}: weights must be cast to {x.dtype}")
    kernels.require_f32(name, bias_tiled,
                        *(() if mask_tiled is None else (mask_tiled,)))
    kernels.require_on(x.device, name, x, wqkv, wproj, bias_tiled,
                       mask_tiled)
    kernels.require(tuple(wqkv.shape) == (3 * C, C)
                    and tuple(wproj.shape) == (C, C)
                    and tuple(bias_tiled.shape) == (heads, TN, TN),
                    f"{name}: weight shapes do not match x {tuple(x.shape)}")
    n_mask = 0
    if mask_tiled is not None:
        n_mask = (H // ws) * (W // ws)
        kernels.require(tuple(mask_tiled.shape) == (n_mask, TN, TN),
                        f"{name}: mask {tuple(mask_tiled.shape)}")
    kernels.require(H % ws == 0 and W % ws == 0 and 0 <= shift < ws,
                    f"{name}: H, W must be multiples of ws > shift")
    kernels.require(C % heads == 0 and hd % 16 == 0 and TN % 16 == 0
                    and C % 128 == 0,
                    f"{name}: needs C % 128, head_dim % 16 and T*ws*ws % 16 "
                    f"(C={C}, heads={heads}, ws={ws}, T={T})")
    kernels.require(smem_bytes(TN, hd) <= kernels.SMEM_LIMIT,
                    f"{name}: window of {TN} tokens x {hd} does not fit "
                    "shared memory")
    return mask_tiled, n_mask


def _forward_kernel(x, wqkv, bqkv, wproj, bproj, bias_tiled, mask_tiled,
                    heads, scale, ws, shift):
    """Launch K1; return (out, qkv, attn), the last two in window order
    (the scratch the backward reuses). Weights already in x's dtype."""
    name = "swin_block_attention"
    mask_tiled, n_mask = _validate(name, x, wqkv, wproj, bias_tiled,
                                   mask_tiled, heads, ws, shift,
                                   _attn_smem_bytes)
    B, T, H, W, C = x.shape
    kernels.require_f32(name, bqkv, bproj)
    kernels.require_on(x.device, name, bqkv, bproj)
    kernels.require(tuple(bqkv.shape) == (3 * C,)
                    and tuple(bproj.shape) == (C,),
                    f"{name}: bias shapes do not match C={C}")
    rows = B * T * H * W
    qkv = torch.empty((rows, 3 * C), dtype=x.dtype, device=x.device)
    attn = torch.empty((rows, C), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    P = kernels.ptr
    kernels.launch("stswin_block_attention", x.device, P(x), P(wqkv),
                   P(bqkv), P(wproj), P(bproj), P(bias_tiled), P(mask_tiled),
                   P(qkv), P(attn), P(out), B, T, H, W, C, heads, ws,
                   float(scale), shift, n_mask)
    swin_block_attention.launches += 1
    return out, qkv, attn


def swin_block_attention(x, wqkv, bqkv, wproj, bproj, bias_tiled, mask_tiled,
                         heads: int, scale: float, ws: int, shift: int = 0):
    """x: (B, T, H, W, C); wqkv: (3C, C); bqkv: (3C,); wproj: (C, C);
    bproj: (C,); bias_tiled: (heads, TN, TN); mask_tiled: (nW, TN, TN)
    for SW-MSA, or None (or a single zero entry) for W-MSA.
    Returns (B, T, H, W, C), shifted by `shift`."""
    args = (x, wqkv, bqkv, wproj, bproj, bias_tiled, mask_tiled, heads,
            scale, ws, shift)
    if kernels.needs_grad(x, wqkv, bqkv, wproj, bproj, bias_tiled):
        return BlockAttentionFn.apply(*args)
    wqkv, wproj = wqkv.to(x.dtype), wproj.to(x.dtype)
    args = (x, wqkv, bqkv, wproj) + args[4:]
    if x.device.type == "cpu":
        return swin_block_attention_ref(*args)
    return _forward_kernel(*args)[0]


swin_block_attention.launches = 0


def swin_block_attention_bwd(x, g, qkv, attn, wqkv, wproj, bias_tiled,
                             mask_tiled, heads: int, scale: float, ws: int,
                             shift: int = 0):
    """K5: the gradients of K1's output given its gradient g (in K1's
    output layout) and K1's window-order `qkv` and `attn` scratch. Returns
    (dx, dwqkv, dbqkv, dwproj, dbproj, dbias_tiled): dx in x's dtype and
    layout (unshifted), the rest fp32."""
    name = "swin_block_attention_bwd"
    mask_tiled, n_mask = _validate(name, x, wqkv, wproj, bias_tiled,
                                   mask_tiled, heads, ws, shift,
                                   _attn_bwd_smem_bytes)
    B, T, H, W, C = x.shape
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    rows = B * T * H * W
    kernels.require(g.shape == x.shape and g.dtype == x.dtype
                    and tuple(qkv.shape) == (rows, 3 * C)
                    and tuple(attn.shape) == (rows, C),
                    f"{name}: g / saved scratch do not match x")
    kernels.require_on(dev, name, g, qkv, attn)
    TN = T * ws * ws
    dattn = torch.empty((rows, C), dtype=x.dtype, device=dev)
    dqkv = torch.empty((rows, 3 * C), dtype=x.dtype, device=dev)
    dx = torch.empty_like(x)
    dwqkv = torch.empty((3 * C, C), **f32)
    dbqkv = torch.empty(3 * C, **f32)
    dwproj = torch.empty((C, C), **f32)
    dbproj = torch.empty(C, **f32)
    dbias = torch.empty((heads, TN, TN), **f32)
    wqkv_t, wproj_t = wqkv.t().contiguous(), wproj.t().contiguous()
    P = kernels.ptr
    kernels.launch("stswin_block_attention_bwd", dev, P(x), P(g), P(qkv),
                   P(attn), P(wqkv_t), P(wproj_t), P(bias_tiled),
                   P(mask_tiled), P(dattn), P(dqkv), P(dx), P(dwqkv),
                   P(dbqkv), P(dwproj), P(dbproj), P(dbias), B, T, H, W, C,
                   heads, ws, float(scale), shift, n_mask)
    swin_block_attention_bwd.launches += 1
    return dx, dwqkv, dbqkv, dwproj, dbproj, dbias


swin_block_attention_bwd.launches = 0


class BlockAttentionFn(torch.autograd.Function):
    """K1 forward, K5 backward (the twins on the CPU). Weights arrive in
    any float dtype (the model's fp32 parameters) and are cast to x's
    dtype; their gradients return in their own dtype, from K5's fp32
    accumulators on CUDA."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wproj, bproj, bias_tiled, mask_tiled,
                heads, scale, ws, shift):
        ctx.cfg = (heads, scale, ws, shift)
        ctx.dtypes = (wqkv.dtype, bqkv.dtype, wproj.dtype, bproj.dtype,
                      bias_tiled.dtype)
        wq, wp = wqkv.to(x.dtype), wproj.to(x.dtype)
        if x.device.type == "cpu":
            ctx.save_for_backward(x, wq, bqkv, wp, bproj, bias_tiled,
                                  mask_tiled)
            return swin_block_attention_ref(x, wq, bqkv, wp, bproj,
                                            bias_tiled, mask_tiled, heads,
                                            scale, ws, shift)
        out, qkv, attn = _forward_kernel(x, wq, bqkv, wp, bproj, bias_tiled,
                                         mask_tiled, heads, scale, ws, shift)
        ctx.save_for_backward(x, wq, wp, bias_tiled, mask_tiled, qkv, attn)
        return out

    @staticmethod
    def backward(ctx, g):
        heads, scale, ws, shift = ctx.cfg
        g = g.contiguous()
        if g.device.type == "cpu":
            x, wq, bqkv, wp, bproj, bias_tiled, mask_tiled = \
                ctx.saved_tensors
            grads = swin_block_attention_bwd_ref(
                x, wq, bqkv, wp, bproj, bias_tiled, mask_tiled, g, heads,
                scale, ws, shift)
        else:
            x, wq, wp, bias_tiled, mask_tiled, qkv, attn = ctx.saved_tensors
            grads = swin_block_attention_bwd(x, g, qkv, attn, wq, wp,
                                             bias_tiled, mask_tiled, heads,
                                             scale, ws, shift)
        dx, *dparams = grads
        dparams = [d.to(t) for d, t in zip(dparams, ctx.dtypes)]
        return (dx, *dparams, None, None, None, None, None)
