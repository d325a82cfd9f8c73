"""K1: the swin block's attention sub-block (qkv -> windowed joint
space-time attention -> proj) on the image-layout clip.

Counterpart of `stswincl_tpu/ops/pallas_block_attention.py`
(`fused_swin_block_attention` and its reference). `swin_block_attention`
launches the CUDA kernel in `csrc/block_attention.cu` on a CUDA tensor and
runs the plain twin `swin_block_attention_ref` on a CPU tensor.

Weights use the torch Linear layout: wqkv (3C, C), wproj (C, C). With
`shift` > 0, x is the UNSHIFTED clip and the output stays in the SHIFTED
layout; `swin_block_epilogue(..., shift=shift)` reads it back.
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


def _attn_smem_bytes(TN: int, hd: int) -> int:
    """Dynamic shared memory of the attention block (`attn_smem` in the
    CUDA source)."""
    a = lambda b: (b + 127) // 128 * 128
    return (3 * a(TN * (hd + 8) * 2) + a(TN * max(TN + 4, hd + 4) * 4)
            + a(TN * (TN + 8) * 2))


def swin_block_attention(x, wqkv, bqkv, wproj, bproj, bias_tiled, mask_tiled,
                         heads: int, scale: float, ws: int, shift: int = 0):
    """x: (B, T, H, W, C); wqkv: (3C, C); bqkv: (3C,); wproj: (C, C);
    bproj: (C,); bias_tiled: (heads, TN, TN); mask_tiled: (nW, TN, TN)
    for SW-MSA, or None (or a single zero entry) for W-MSA.
    Returns (B, T, H, W, C), shifted by `shift`."""
    if x.device.type == "cpu":
        return swin_block_attention_ref(x, wqkv, bqkv, wproj, bproj,
                                        bias_tiled, mask_tiled, heads, scale,
                                        ws, shift)
    name = "swin_block_attention"
    kernels.require(x.is_cuda, f"{name}: no kernel for device {x.device}")
    if mask_tiled is not None and mask_tiled.shape[0] == 1:
        mask_tiled = None
    kernels.require(x.dim() == 5, f"{name}: x must be (B, T, H, W, C)")
    B, T, H, W, C = x.shape
    hd, TN = C // heads, T * ws * ws
    kernels.require_bf16_cuda(name, x, wqkv, wproj)
    kernels.require_f32(name, bqkv, bproj, bias_tiled,
                        *(() if mask_tiled is None else (mask_tiled,)))
    kernels.require_on(x.device, name, x, wqkv, bqkv, wproj, bproj,
                       bias_tiled, mask_tiled)
    kernels.require(tuple(wqkv.shape) == (3 * C, C)
                    and tuple(wproj.shape) == (C, C)
                    and tuple(bqkv.shape) == (3 * C,)
                    and tuple(bproj.shape) == (C,)
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
    kernels.require(_attn_smem_bytes(TN, hd) <= kernels.SMEM_LIMIT,
                    f"{name}: window of {TN} tokens x {hd} does not fit "
                    "shared memory")
    rows = B * T * H * W
    qkv = torch.empty((rows, 3 * C), dtype=x.dtype, device=x.device)
    attn = torch.empty((rows, C), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    P = kernels.ptr
    kernels.launch("stswin_block_attention", x.device, P(x), P(wqkv),
                   P(bqkv),
                   P(wproj), P(bproj), P(bias_tiled), P(mask_tiled), P(qkv),
                   P(attn), P(out), B, T, H, W, C, heads, ws, float(scale),
                   shift, n_mask)
    swin_block_attention.launches += 1
    return out


swin_block_attention.launches = 0
