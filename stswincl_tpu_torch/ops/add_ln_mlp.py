"""K2: the swin block's post-attention tail, LN1(s + MLP(LN2(s))) with
s = x + y in fp32 (the reference's nonstandard norm order).

Counterpart of `fused_swin_block_epilogue` and
`fused_swin_block_epilogue_shifted` in
`stswincl_tpu/ops/pallas_add_ln_mlp.py`. `swin_block_epilogue` launches
the CUDA kernel in `csrc/epilogue.cu` on a CUDA tensor and runs the plain
twin `swin_block_epilogue_ref` on a CPU tensor. With `shift` > 0, y is in
the SW-MSA shifted layout that `swin_block_attention(shift=...)` leaves,
and is read back through the inverse cyclic shift.

Weights use the torch Linear layout: w1 (4C, C), w2 (C, 4C).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from stswincl_tpu_torch import kernels
from stswincl_tpu_torch.ops.mlp import gelu


def layer_norm_f32(s32: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Two-pass fp32 LayerNorm over the last axis (`_ln_math`)."""
    mu = s32.mean(dim=-1, keepdim=True)
    xc = s32 - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return (xc * torch.rsqrt(var + eps)) * scale.float() + bias.float()


def swin_block_epilogue_ref(x, y, s2, b2, w1, b1, w2, bw2, s1, b1n,
                            gelu_exact: bool = True, shift: int = 0,
                            ws: Optional[int] = None, eps: float = 1e-5):
    """Plain twin of K2 (port of `swin_block_epilogue_ref` and its
    `_shifted_ref`; same signature as `swin_block_epilogue`, `ws` unused).
    The MLP output is added to s in fp32, unrounded, as the kernels do
    (`pallas_add_ln_mlp.py:743`)."""
    if shift:
        y = torch.roll(y, (shift, shift), dims=(2, 3))
    s32 = x.float() + y.float()
    n2 = layer_norm_f32(s32, s2, b2, eps).to(x.dtype)
    h = gelu(F.linear(n2.float(), w1.float(), b1.float()), gelu_exact)
    m = F.linear(h.to(x.dtype).float(), w2.float(), bw2.float())
    return layer_norm_f32(s32 + m, s1, b1n, eps).to(x.dtype)


def swin_block_epilogue(x, y, s2, b2, w1, b1, w2, bw2, s1, b1n,
                        gelu_exact: bool = True, shift: int = 0,
                        ws: Optional[int] = None, eps: float = 1e-5):
    """x, y: (..., C), or (B, T, H, W, C) when `shift` > 0 (then y is
    shifted and 0 < shift < ws). LayerNorm scale/bias and the MLP biases
    are fp32; returns x's shape and dtype."""
    if x.device.type == "cpu":
        return swin_block_epilogue_ref(x, y, s2, b2, w1, b1, w2, bw2, s1,
                                       b1n, gelu_exact, shift, ws, eps)
    name = "swin_block_epilogue"
    kernels.require(x.is_cuda, f"{name}: no kernel for device {x.device}")
    C = x.shape[-1]
    hidden = w1.shape[0]
    kernels.require_bf16_cuda(name, x, y, w1, w2)
    kernels.require_f32(name, s2, b2, b1, bw2, s1, b1n)
    kernels.require_on(x.device, name, x, y, s2, b2, w1, b1, w2, bw2, s1,
                       b1n)
    kernels.require(y.shape == x.shape, f"{name}: y {tuple(y.shape)} vs x "
                    f"{tuple(x.shape)}")
    kernels.require(tuple(w1.shape) == (hidden, C)
                    and tuple(w2.shape) == (C, hidden)
                    and all(tuple(v.shape) == (C,)
                            for v in (s2, b2, bw2, s1, b1n))
                    and tuple(b1.shape) == (hidden,),
                    f"{name}: parameter shapes do not match C={C}")
    kernels.require(C % 128 == 0 and hidden % 128 == 0,
                    f"{name}: needs C and hidden multiples of 128 "
                    f"(C={C}, hidden={hidden})")
    if shift:
        kernels.require(x.dim() == 5 and ws is not None and 0 < shift < ws,
                        f"{name}: the shifted epilogue takes (B, T, H, W, C)"
                        " and 0 < shift < ws")
        B, T, H, W, _ = x.shape
        BT = B * T
    else:
        BT, H, W = 1, 1, x.numel() // C
    rows = BT * H * W
    dev = x.device
    s32 = torch.empty((rows, C), dtype=torch.float32, device=dev)
    n2 = torch.empty((rows, C), dtype=x.dtype, device=dev)
    hid = torch.empty((rows, hidden), dtype=x.dtype, device=dev)
    out = torch.empty_like(x)
    P = kernels.ptr
    kernels.launch("stswin_block_epilogue", dev, P(x), P(y), P(s2), P(b2),
                   P(w1), P(b1), P(w2), P(bw2), P(s1), P(b1n), P(s32),
                   P(n2), P(hid), P(out), BT, H, W, C, hidden, shift,
                   1 if gelu_exact else 2, float(eps))
    swin_block_epilogue.launches += 1
    return out


swin_block_epilogue.launches = 0
