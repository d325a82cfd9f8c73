"""Row 16: the whole W-MSA swin block in one kernel, and its backward.

Counterpart of `stswincl_tpu/ops/pallas_swin_block.py`
(`fused_whole_swin_block`, `whole_swin_block_ref` and the custom VJP
`_fwsb_bwd`). The block is K1 with shift 0 followed by the epilogue:

    y = proj(attention(qkv(x))), s = x + y, out = LN1(s + MLP(LN2(s)))

`whole_swin_block` launches `stswin_whole_block` (`csrc/swin_block.cu`),
one launch per block call, on a CUDA tensor and runs the plain twin
`whole_swin_block_ref` on a CPU tensor. The twin is the rounded-m form:
the TPU kernel rounds the MLP output m to bf16 before the residual add
(`pallas_swin_block.py:140-143`), where K2 as served adds the fp32 sum
(`pallas_add_ln_mlp.py:743`), so row 16 and the K1 + K2 pair differ in m's
last bit, in the JAX package too; row 16 is held against this twin.

When autograd needs a gradient the call goes through `WholeBlockFn`. It
saves only the inputs; its backward re-runs the pair through the port's
own Functions (`BlockAttentionFn` with shift 0, then `EpilogueFn`) and
differentiates them, as `_fwsb_bwd` takes `jax.vjp` of the two-kernel
composition: on the card that launches K1, K2, K6 and K5; on the CPU it
runs their twins. The JAX package has no backward kernel for row 16.

Weights use the torch Linear layout: wqkv (3C, C), wproj (C, C), w1 (4C,
C), w2 (C, 4C), in any float dtype (cast to x's dtype for the kernel);
the biases, LayerNorm vectors and the tiled relative bias are fp32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from stswincl_tpu_torch import kernels
from stswincl_tpu_torch.ops.add_ln_mlp import (swin_block_epilogue,
                                               swin_block_epilogue_with_m_ref)
from stswincl_tpu_torch.ops.attention import (_attend_smem_bytes,
                                              check_attention_core)
from stswincl_tpu_torch.ops.block_attention import (swin_block_attention,
                                                    swin_block_attention_ref)

TILE_ROWS = 128  # token rows one block of the kernel owns (whole windows)


def whole_swin_block_ref(x, wqkv, bqkv, wproj, bproj, bias_tiled,
                         mask_tiled, s2, b2, w1, b1, w2, bw2, s1, b1n,
                         heads: int, scale: float, ws: int,
                         gelu_exact: bool = True, eps: float = 1e-5):
    """Plain twin of row 16: K1's twin with shift 0, then the epilogue's
    rounded-m twin (`swin_block_epilogue_with_m_ref`). x: (B, T, H, W, C);
    returns x's shape and dtype."""
    y = swin_block_attention_ref(x, wqkv, bqkv, wproj, bproj, bias_tiled,
                                 mask_tiled, heads, scale, ws)
    return swin_block_epilogue_with_m_ref(x, y, s2, b2, w1, b1, w2, bw2, s1,
                                          b1n, gelu_exact, eps=eps)[0]


@functools.lru_cache(maxsize=None)
def _slots(T: int, C: int, heads: int, ws: int) -> int:
    """Workspace slots of the kernel's persistent grid: the blocks the card
    holds at once, from the kernel's own shared-memory layout and the
    occupancy API (`stswin_whole_block_slots`)."""
    n = ctypes.c_int(0)
    err = kernels.load().stswin_whole_block_slots(T, C, heads, ws,
                                                  ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"stswin_whole_block_slots: CUDA error {err}")
    return n.value


def _forward_kernel(x, wqkv, bqkv, wproj, bproj, bias_tiled, mask_tiled, s2,
                    b2, w1, b1, w2, bw2, s1, b1n, heads, scale, ws,
                    gelu_exact, eps):
    """Launch row 16 (weights already in x's dtype)."""
    name = "whole_swin_block"
    kernels.require(x.is_cuda, f"{name}: no kernel for device {x.device}")
    kernels.require(x.dim() == 5, f"{name}: x must be (B, T, H, W, C)")
    kernels.require_bf16_cuda(name, x)
    B, T, H, W, C = x.shape
    hidden = w1.shape[0]
    kernels.require(all(w.dtype == x.dtype for w in (wqkv, wproj, w1, w2)),
                    f"{name}: weights must be cast to {x.dtype}")
    vectors = (bqkv, bproj, s2, b2, b1, bw2, s1, b1n)
    kernels.require_f32(name, *vectors)
    kernels.require_on(x.device, name, x, wqkv, wproj, w1, w2, *vectors)
    kernels.require(
        tuple(wqkv.shape) == (3 * C, C) and tuple(wproj.shape) == (C, C)
        and tuple(w1.shape) == (hidden, C) and tuple(w2.shape) == (C, hidden)
        and tuple(bqkv.shape) == (3 * C,) and tuple(b1.shape) == (hidden,)
        and all(tuple(v.shape) == (C,)
                for v in (bproj, s2, b2, bw2, s1, b1n)),
        f"{name}: parameter shapes do not match x {tuple(x.shape)}")
    kernels.require(C % 128 == 0 and C <= 1024 and hidden % 128 == 0
                    and C % heads == 0,
                    f"{name}: needs C % 128 == 0, C <= 1024, hidden % 128 "
                    f"== 0 and C % heads == 0 (C={C}, hidden={hidden}, "
                    f"heads={heads})")
    kernels.require(H % ws == 0 and W % ws == 0,
                    f"{name}: ({H}, {W}) over windows of {ws}")
    TN = T * ws * ws
    mask_tiled, n_mask = check_attention_core(name, x.device, bias_tiled,
                                              mask_tiled, heads, TN,
                                              C // heads, _attend_smem_bytes)
    kernels.require(n_mask == 0, f"{name}: the whole-block kernel takes "
                    "W-MSA blocks (shift 0, no attention mask)")
    kernels.require(TILE_ROWS % TN == 0,
                    f"{name}: windows of {TN} tokens do not tile "
                    f"{TILE_ROWS} rows")
    slots = min(-(-B * T * H * W // TILE_ROWS), _slots(T, C, heads, ws))
    dev = x.device
    ws_wide = torch.empty((slots, TILE_ROWS, max(3 * C, hidden)),
                          dtype=x.dtype, device=dev)
    ws_narrow = torch.empty((slots, TILE_ROWS, C), dtype=x.dtype, device=dev)
    ws_s = torch.empty((slots, TILE_ROWS, C), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    P = kernels.ptr
    kernels.launch("stswin_whole_block", dev, P(x), P(wqkv), P(bqkv),
                   P(wproj), P(bproj), P(bias_tiled), P(s2), P(b2), P(w1),
                   P(b1), P(w2), P(bw2), P(s1), P(b1n), P(ws_wide),
                   P(ws_narrow), P(ws_s), P(out), B, T, H, W, C, hidden,
                   heads, ws, slots, 1 if gelu_exact else 2, float(scale),
                   float(eps))
    whole_swin_block.launches += 1
    return out


def whole_swin_block(x, wqkv, bqkv, wproj, bproj, bias_tiled,
                     mask_tiled: Optional[torch.Tensor], s2, b2, w1, b1, w2,
                     bw2, s1, b1n, heads: int, scale: float, ws: int,
                     gelu_exact: bool = True, eps: float = 1e-5):
    """Pallas row 16 (`pallas_swin_block.py:229`): the whole W-MSA block.
    x: (B, T, H, W, C), unshifted; bias_tiled (heads, TN, TN) fp32;
    mask_tiled None or W-MSA's single (1, TN, TN) zero entry. Returns x's
    shape and dtype."""
    args = (x, wqkv, bqkv, wproj, bproj, bias_tiled, mask_tiled, s2, b2, w1,
            b1, w2, bw2, s1, b1n, heads, scale, ws, gelu_exact, eps)
    if kernels.needs_grad(x, wqkv, bqkv, wproj, bproj, bias_tiled, s2, b2,
                          w1, b1, w2, bw2, s1, b1n):
        return WholeBlockFn.apply(*args)
    return _forward(*args)


whole_swin_block.launches = 0


def _forward(x, wqkv, bqkv, wproj, bproj, bias_tiled, mask_tiled, s2, b2,
             w1, b1, w2, bw2, s1, b1n, *cfg):
    """The kernel on a CUDA tensor, the twin on a CPU one; weights cast to
    x's dtype."""
    wqkv, wproj, w1, w2 = (w.to(x.dtype) for w in (wqkv, wproj, w1, w2))
    args = (x, wqkv, bqkv, wproj, bproj, bias_tiled, mask_tiled, s2, b2, w1,
            b1, w2, bw2, s1, b1n, *cfg)
    if x.device.type == "cpu":
        return whole_swin_block_ref(*args)
    return _forward_kernel(*args)


class WholeBlockFn(torch.autograd.Function):
    """Row 16 forward (the twin on the CPU); backward: the gradients of
    the K1 + K2 pair, recomputed from the saved inputs through
    `BlockAttentionFn` and `EpilogueFn` (`_fwsb_bwd`,
    `pallas_swin_block.py:309-320`). The mask takes no gradient."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wproj, bproj, bias_tiled, mask_tiled, s2,
                b2, w1, b1, w2, bw2, s1, b1n, heads, scale, ws, gelu_exact,
                eps):
        ctx.cfg = (heads, scale, ws, gelu_exact, eps)
        ctx.save_for_backward(x, wqkv, bqkv, wproj, bproj, bias_tiled,
                              mask_tiled, s2, b2, w1, b1, w2, bw2, s1, b1n)
        return _forward(x, wqkv, bqkv, wproj, bproj, bias_tiled, mask_tiled,
                        s2, b2, w1, b1, w2, bw2, s1, b1n, *ctx.cfg)

    @staticmethod
    def backward(ctx, g):
        heads, scale, ws, gelu_exact, eps = ctx.cfg
        saved = ctx.saved_tensors
        mask = saved[6]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_()
                      for t in saved[:6] + saved[7:]]
            x, wqkv, bqkv, wproj, bproj, bias_tiled = leaves[:6]
            s2, b2, w1, b1, w2, bw2, s1, b1n = leaves[6:]
            y = swin_block_attention(x, wqkv, bqkv, wproj, bproj, bias_tiled,
                                     mask, heads, scale, ws, 0)
            out = swin_block_epilogue(x, y, s2, b2, w1, b1, w2, bw2, s1, b1n,
                                      gelu_exact, 0, ws, eps)
            grads = torch.autograd.grad(out, leaves, g.contiguous())
        return (*grads[:6], None, *grads[6:], None, None, None, None, None)
