"""K1 and K5: the swin block's attention sub-block (qkv -> windowed joint
space-time attention -> proj) on the image-layout clip, and its backward;
and the row-10 kernel, window attention on an image-layout qkv.

Counterparts of `stswincl_tpu/ops/pallas_block_attention.py`
(`fused_swin_block_attention`, its reference, and
`fused_swin_block_attention_bwd` behind `_fsba_bwd`).
`swin_block_attention` launches K1 (`csrc/block_attention.cu`) on a bf16
CUDA tensor, its fp32 form (`swin_block_attention_f32`,
`csrc/fp32_forms.cu`) on an fp32 one, and runs the plain twin
`swin_block_attention_ref` on a CPU tensor. When autograd needs a
gradient it goes through `BlockAttentionFn`, whose backward launches K5 on
CUDA (`swin_block_attention_bwd` in bf16, its fp32 form
`swin_block_attention_bwd_f32`, `csrc/fp32_train.cu`, in fp32) and runs
the plain twin `swin_block_attention_bwd_ref` on the CPU. K5 takes
every window K1 takes in both dtypes (bf16: a one-pass kernel where its
slot fits, two passes elsewhere, `_attn_bwd_slot_takes`; fp32: resident
passes where they fit, streamed ones elsewhere, `_attn_f32_bwd_resident`),
and sums every gradient in a fixed order: two calls give the same bits.

Weights use the torch Linear layout: wqkv (3C, C), wproj (C, C), in any
float dtype: they are cast to x's dtype for the product, and their
gradients come back in their own dtype from fp32 accumulators. With
`shift` > 0, x is the UNSHIFTED clip and the output stays in the SHIFTED
layout; `swin_block_epilogue(..., shift=shift)` reads it back, and the
output's gradient arrives in that layout too.

`windowed_attention_image` (Pallas row 10, the `attn_impl='pallas'`
route) launches `stswin_window_attention_image`
(`csrc/window_attention.cu`) on a bf16 CUDA tensor, its fp32 form
(`windowed_attention_image_f32`, `csrc/fp32_forms.cu`) on an fp32 one,
and runs its twin `windowed_attention_image_ref` on a CPU tensor; its
backward (`WindowedAttentionImageFn`) is autograd of that twin, as in
JAX.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from stswincl_tpu_torch import kernels
from stswincl_tpu_torch.ops.attention import (F32_RING, F32_SLOT,
                                              MAX_WINDOW_TOKENS, _align,
                                              _attn_f32_smem_bytes,
                                              _attn_plan_bytes, attend_tiled,
                                              check_attention_core)
from stswincl_tpu_torch.ops.window import partition_qkv, reverse_windows


def windowed_attention_image_ref(qkv: torch.Tensor, bias_tiled: torch.Tensor,
                                 mask_tiled: Optional[torch.Tensor],
                                 heads: int, scale: float,
                                 ws: int) -> torch.Tensor:
    """Partition (B, T, H, W, 3C) qkv into frame-joint windows, attend,
    and reverse to (B, T, H, W, C)."""
    B, T, H, W, _ = qkv.shape
    q, k, v = partition_qkv(qkv, heads, ws)
    o = attend_tiled(q, k, v, bias_tiled, mask_tiled, scale)
    return reverse_windows(o, B, T, H, W, ws)


def _image_kernel(qkv, bias_tiled, mask_tiled, heads, scale, ws):
    """Launch row 10 in qkv's dtype: the bf16 kernel, or the fp32 form."""
    f32 = qkv.dtype == torch.float32
    sfx = "_f32" if f32 else ""
    name = "windowed_attention_image" + sfx
    kernels.require(qkv.is_cuda, f"{name}: no kernel for device {qkv.device}")
    kernels.require(qkv.dim() == 5 and qkv.shape[-1] % 3 == 0,
                    f"{name}: qkv must be (B, T, H, W, 3C), got "
                    f"{tuple(qkv.shape)}")
    kernels.require_form(name, None if f32 else "Pallas row 10", qkv)
    kernels.require_on(qkv.device, name, qkv)
    kernels.require(qkv.data_ptr() % 16 == 0,
                    f"{name}: qkv must be 16-byte aligned")
    B, T, H, W, C3 = qkv.shape
    C = C3 // 3
    kernels.require(C % heads == 0 and H % ws == 0 and W % ws == 0,
                    f"{name}: C={C} over {heads} heads, ({H}, {W}) over "
                    f"windows of {ws}")
    n_win = (H // ws) * (W // ws)
    mask_tiled, n_mask = check_attention_core(
        name, qkv.device, bias_tiled, mask_tiled, heads, T * ws * ws,
        C // heads, _attn_f32_smem_bytes if f32 else _attn_plan_bytes)
    kernels.require(n_mask in (0, n_win),
                    f"{name}: {n_mask} masks for {n_win} windows an image")
    out = torch.empty((B, T, H, W, C), dtype=qkv.dtype, device=qkv.device)
    P = kernels.ptr
    kernels.launch("stswin_window_attention_image" + sfx, qkv.device,
                   P(qkv), P(bias_tiled), P(mask_tiled), P(out), B, T, H, W,
                   C, heads, ws, float(scale), n_mask)
    form = windowed_attention_image_f32 if f32 else windowed_attention_image
    form.launches += 1
    return out


def windowed_attention_image_f32(qkv, bias_tiled, mask_tiled, heads: int,
                                 scale: float, ws: int) -> torch.Tensor:
    """Row 10's fp32 form (`stswin_window_attention_image_f32`,
    `csrc/fp32_forms.cu`) on an fp32 CUDA qkv, the arguments of
    `windowed_attention_image`: K1's fp32 attention core gathering
    straight from the image layout, P unrounded; the windows of the bf16
    form, through the resident or the streamed pair
    (`_attn_f32_smem_bytes`)."""
    return _image_kernel(qkv, bias_tiled, mask_tiled, heads, scale, ws)


windowed_attention_image_f32.launches = 0


def windowed_attention_image(qkv: torch.Tensor, bias_tiled: torch.Tensor,
                             mask_tiled: Optional[torch.Tensor], heads: int,
                             scale: float, ws: int) -> torch.Tensor:
    """Pallas row 10 (`pallas_block_attention.py:128`): window attention
    on the image-layout qkv (B, T, H, W, 3C), already rolled for SW-MSA;
    bias_tiled (heads, TN, TN) fp32; mask_tiled (nH * nW, TN, TN) fp32,
    one entry per window of an image (index i * nW + j, the same for every
    batch element), or None / a single (1, TN, TN) zero entry, the W-MSA
    marker. qkv in bf16 launches the kernel, in fp32 its fp32 form.
    Returns (B, T, H, W, C) in the image layout."""
    args = (qkv, bias_tiled, mask_tiled, heads, scale, ws)
    if kernels.needs_grad(qkv, bias_tiled):
        return WindowedAttentionImageFn.apply(*args)
    if qkv.device.type == "cpu":
        return windowed_attention_image_ref(*args)
    return _image_kernel(*args)


windowed_attention_image.launches = 0


class WindowedAttentionImageFn(torch.autograd.Function):
    """Row 10: the kernel forward on CUDA in qkv's dtype (the twin on the
    CPU); backward: autograd of the twin `windowed_attention_image_ref`,
    recomputed from the saved qkv, as `_wai_bwd`
    (`pallas_block_attention.py:668-673`) takes `jax.vjp` of the XLA
    reference. The mask takes no gradient."""

    @staticmethod
    def forward(ctx, qkv, bias_tiled, mask_tiled, heads, scale, ws):
        ctx.cfg = (heads, scale, ws)
        ctx.save_for_backward(qkv, bias_tiled, mask_tiled)
        if qkv.device.type == "cpu":
            return windowed_attention_image_ref(qkv, bias_tiled, mask_tiled,
                                                heads, scale, ws)
        return _image_kernel(qkv, bias_tiled, mask_tiled, heads, scale, ws)

    @staticmethod
    def backward(ctx, g):
        qkv, bias_tiled, mask_tiled = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (qkv, bias_tiled)]
            out = windowed_attention_image_ref(*leaves, mask_tiled, *ctx.cfg)
            dqkv, dbias = torch.autograd.grad(out, leaves, g)
        return dqkv, dbias, None, None, None, None


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


# The widest window of K5 fp32's resident attention backward: its query
# pass's score tile holds at most 16 key tiles of 8. Wider windows stream.
MAX_F32_BWD_WINDOW_TOKENS = 128


def _attn_bwd_smem_bytes(TN: int, hd: int) -> int:
    """Dynamic shared memory of one (window, head) slot of K5's one-pass
    attention backward (`bwd_smem` in `csrc/block_attention.cu`): q and dO
    in bf16 rows of hd + 8, the k / v region that later holds P / dS (rows
    of TN + 8), and the slot's fp32 (TN, TN) dbias table; the scores, P, dP
    and dS stay in registers. The library runs this kernel where the slot
    fits (`_attn_bwd_slot_takes`), the two passes elsewhere."""
    return (2 * _align(TN * (hd + 8) * 2)
            + _align(2 * TN * max(hd + 8, TN + 8) * 2) + _align(TN * TN * 4))


def _attn_bwd_slot_takes(TN: int, hd: int) -> bool:
    """Whether K5's bf16 attention backward runs its one-pass slot kernel
    (`slot_takes`): at most 8 key tiles of 16 (its score and dP
    registers) and the slot within SMEM_LIMIT; every other window K1 takes
    runs the two passes (`_attn_bwd_plan_bytes`)."""
    return TN <= 128 and _attn_bwd_smem_bytes(TN, hd) <= kernels.SMEM_LIMIT


def _attn_bwd_plan_bytes(TN: int, hd: int) -> int:
    """Dynamic shared memory of K5's bf16 attention backward for a window:
    the slot kernel's slot (`_attn_bwd_smem_bytes`) where it takes the
    window, else the larger of the two passes' (`wide_q_smem`,
    `wide_kv_smem` in `csrc/block_attention.cu`), neither of which depends
    on the head dim: the query pass streams k and v through a ring of three
    64-column chunks (rows of 72 bf16) and holds fp32 P (rows of TN + 8);
    the key pass holds bf16 P and dS (rows of TN + 8) and 64-column chunks
    of q and dO (rows of 72)."""
    if _attn_bwd_slot_takes(TN, hd):
        return _attn_bwd_smem_bytes(TN, hd)
    query = _align(3 * TN * 72 * 2) + TN * (TN + 8) * 4
    key = 2 * _align(TN * (TN + 8) * 2) + 2 * _align(TN * 72 * 2)
    return max(query, key)


def attn_bwd_passes_launches(reset: bool = False) -> int:
    """Runs of K5 bf16's two-pass attention backward (a streamed query pass
    and a key pass each) counted by the library since the last reset;
    `reset` sets the count to 0 after reading."""
    return kernels.query("stswin_attn_bwd_passes_launches", int(reset))


def _attn_f32_bwd_resident(TN: int, hd: int) -> bool:
    """Whether K5 fp32's attention backward runs its resident passes
    (`attn32b::resident`): 16-token tiles up to MAX_F32_BWD_WINDOW_TOKENS
    (the query pass's score tile holds 16 key tiles of 8), head dims a
    multiple of 8 up to 256 at TN <= 32 and 128 beyond (the key pass's dk
    and dv accumulators: 128 columns a warp, two warps a key group past
    128). Every other window K1 takes runs the streamed passes."""
    return (0 < TN <= MAX_F32_BWD_WINDOW_TOKENS and TN % 16 == 0 and hd > 0
            and hd % 8 == 0 and hd <= (256 if TN <= 32 else 128))


def _attn_f32_bwd_smem_bytes(TN: int, hd: int) -> int:
    """Dynamic shared memory of K5 fp32's attention backward
    (`attn32b::smem_bytes`, `csrc/fp32_attention_bwd.cuh`), the larger of
    its two passes. Resident (`_attn_f32_bwd_resident`), fp32 rows of hd +
    4: the query pass holds k, v and a region of TN rows for each warp's
    16 rows of q, then of dO; the key pass k, v and a ring of 16-query
    chunks of q and dO (three chunks past 32 tokens, else two). Streamed:
    the query pass the fp32 forward's streamed ring (864 TN bytes); the
    key pass three 16-query chunks of P and dS (rows of TN + 8) and of 64
    columns of q and dO (rows of 72)."""
    if _attn_f32_bwd_resident(TN, hd):
        ld, stages = hd + 4, 3 if TN // 16 >= 3 else 2
        return 4 * max(3 * TN * ld, (2 * TN + 2 * 16 * stages) * ld)
    return max(F32_RING * TN * F32_SLOT * 4,
               4 * 3 * (2 * 16 * (TN + 8) + 2 * 16 * 72))


def _attn_f32_bwd_takes(TN: int, hd: int) -> bool:
    """The windows K5 fp32's attention backward takes (`attn_bwd_f32_takes`):
    exactly K1's (`_attn_bwd_takes`), the resident passes where they fit,
    the streamed ones elsewhere."""
    return _attn_bwd_takes(TN, hd)


def attn_bwd_f32_streamed_launches(reset: bool = False) -> int:
    """Runs of K5 fp32's streamed attention backward (a query pass and a
    key pass each) counted by the library since the last reset; `reset`
    sets the count to 0 after reading."""
    return kernels.query("stswin_attn_bwd_f32_streamed_launches", int(reset))


def check_backward_window(name: str, x: torch.Tensor, heads: int,
                          ws: int) -> None:
    """Refuse a window that K5's attention backward in x's dtype does not
    take: in either dtype, what K1's attention core refuses
    (`_attn_bwd_takes`: more than MAX_WINDOW_TOKENS tokens, a token count
    off 16 or a head dim off 8), so that every window that serves also
    trains. The forward of `BlockAttentionFn` and of the whole-block
    Function checks it before K1 or row 16 runs, so a training step on such
    a window fails before its forward rather than inside its backward."""
    TN, hd = x.shape[1] * ws * ws, x.shape[-1] // heads
    form = "'s fp32 form" if x.dtype == torch.float32 else ""
    kernels.require(_attn_bwd_takes(TN, hd),
                    lambda: f"{name}: K5{form} (the attention backward) "
                    "takes the windows K1 takes: at most "
                    f"{MAX_WINDOW_TOKENS} tokens, token count a multiple of "
                    f"16, head dim a multiple of 8; got {TN} tokens x head "
                    f"dim {hd}")


def _attn_bwd_takes(TN: int, hd: int) -> bool:
    """The windows K5's attention backward takes in both dtypes: exactly
    those of K1's attention core (`check_attention_core`), a token count a
    multiple of 16 up to MAX_WINDOW_TOKENS and a head dim a multiple of 8;
    no term of shared memory (every instance's plan fits at any head
    dim)."""
    return (0 < TN <= MAX_WINDOW_TOKENS and TN % 16 == 0 and hd > 0
            and hd % 8 == 0)


def _validate(name, row, x, wqkv, wproj, bias_tiled, mask_tiled, heads,
              ws, shift, smem_bytes):
    """Check what the CUDA kernels take (x's dtype: `kernels.require_form`
    of `row`); return (mask or None, n_mask)."""
    kernels.require(x.is_cuda, f"{name}: no kernel for device {x.device}")
    kernels.require(x.dim() == 5, f"{name}: x must be (B, T, H, W, C)")
    B, T, H, W, C = x.shape
    kernels.require_form(name, row, x)
    kernels.require(wqkv.dtype == x.dtype and wproj.dtype == x.dtype,
                    f"{name}: weights must be cast to {x.dtype}")
    kernels.require_on(x.device, name, x, wqkv, wproj)
    kernels.require(tuple(wqkv.shape) == (3 * C, C)
                    and tuple(wproj.shape) == (C, C),
                    f"{name}: weight shapes do not match x {tuple(x.shape)}")
    kernels.require(H % ws == 0 and W % ws == 0 and 0 <= shift < ws,
                    f"{name}: H, W must be multiples of ws > shift")
    kernels.require(C % heads == 0 and C % 8 == 0,
                    f"{name}: needs C % 8 and C % heads (C={C}, "
                    f"heads={heads})")
    mask_tiled, n_mask = check_attention_core(
        name, x.device, bias_tiled, mask_tiled, heads, T * ws * ws,
        C // heads, smem_bytes)
    kernels.require(n_mask in (0, (H // ws) * (W // ws)),
                    f"{name}: {n_mask} masks for {(H // ws) * (W // ws)} "
                    "windows an image")
    return mask_tiled, n_mask


def _launch_k1(entry, name, row, x, wqkv, bqkv, wproj, bproj, bias_tiled,
               mask_tiled, heads, scale, ws, shift, smem_bytes):
    """Check and launch C entry `entry` of K1 (the bf16 kernel of `row`,
    or with `row` None the fp32 form); return (out, qkv, attn), the last
    two in window order. Weights already in x's dtype."""
    mask_tiled, n_mask = _validate(name, row, x, wqkv, wproj, bias_tiled,
                                   mask_tiled, heads, ws, shift, smem_bytes)
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
    kernels.launch(entry, x.device, P(x), P(wqkv), P(bqkv), P(wproj),
                   P(bproj), P(bias_tiled), P(mask_tiled), P(qkv), P(attn),
                   P(out), B, T, H, W, C, heads, ws, float(scale), shift,
                   n_mask)
    return out, qkv, attn


def _forward_kernel(x, wqkv, bqkv, wproj, bproj, bias_tiled, mask_tiled,
                    heads, scale, ws, shift):
    """Launch K1; return (out, qkv, attn), the last two in window order
    (the scratch the backward reuses). Weights already in x's dtype."""
    name = "swin_block_attention"
    res = _launch_k1("stswin_block_attention", name,
                     "Pallas row 1's bf16 form", x, wqkv, bqkv, wproj, bproj,
                     bias_tiled, mask_tiled, heads, scale, ws, shift,
                     _attn_plan_bytes)
    swin_block_attention.launches += 1
    return res


def _forward_f32(x, wqkv, bqkv, wproj, bproj, bias_tiled, mask_tiled,
                 heads, scale, ws, shift):
    """Launch K1's fp32 form; return (out, qkv, attn), the last two in
    window order (the scratch K5's fp32 form reuses)."""
    name = "swin_block_attention_f32"
    res = _launch_k1("stswin_block_attention_f32", name, None, x, wqkv,
                     bqkv, wproj, bproj, bias_tiled, mask_tiled, heads, scale,
                     ws, shift, _attn_f32_smem_bytes)
    swin_block_attention_f32.launches += 1
    return res


def swin_block_attention_f32(x, wqkv, bqkv, wproj, bproj, bias_tiled,
                             mask_tiled, heads: int, scale: float, ws: int,
                             shift: int = 0):
    """K1's fp32 form (`stswin_block_attention_f32`, `csrc/fp32_forms.cu`)
    on fp32 CUDA tensors, the arguments of `swin_block_attention` with the
    weights in fp32: every product on the fp32 GEMM, the attention in fp32
    with P unrounded; the windows of the bf16 form, through the resident
    or the streamed pair (`_attn_f32_smem_bytes`). Under autograd
    `BlockAttentionFn` keeps its window-order qkv and attention scratch
    for K5's fp32 form."""
    return _forward_f32(x, wqkv, bqkv, wproj, bproj, bias_tiled, mask_tiled,
                        heads, scale, ws, shift)[0]


swin_block_attention_f32.launches = 0


def swin_block_attention(x, wqkv, bqkv, wproj, bproj, bias_tiled, mask_tiled,
                         heads: int, scale: float, ws: int, shift: int = 0):
    """x: (B, T, H, W, C); wqkv: (3C, C); bqkv: (3C,); wproj: (C, C);
    bproj: (C,); bias_tiled: (heads, TN, TN); mask_tiled: (nW, TN, TN)
    for SW-MSA, or None (or a single zero entry) for W-MSA. x in bf16
    launches K1, in fp32 its fp32 form; under autograd both go through
    `BlockAttentionFn`. Returns (B, T, H, W, C), shifted by `shift`."""
    args = (x, wqkv, bqkv, wproj, bproj, bias_tiled, mask_tiled, heads,
            scale, ws, shift)
    params = (wqkv, bqkv, wproj, bproj, bias_tiled)
    if kernels.needs_grad(x, *params):
        return BlockAttentionFn.apply(*args)
    wqkv, wproj = wqkv.to(x.dtype), wproj.to(x.dtype)
    args = (x, wqkv, bqkv, wproj) + args[4:]
    if x.device.type == "cpu":
        return swin_block_attention_ref(*args)
    if x.dtype == torch.float32:
        return swin_block_attention_f32(*args)
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
    mask_tiled, n_mask = _validate(name, "Pallas row 6", x, wqkv, wproj,
                                   bias_tiled, mask_tiled, heads, ws, shift,
                                   _attn_bwd_plan_bytes)
    check_backward_window(name, x, heads, ws)
    B, T, H, W, C = x.shape
    TN = T * ws * ws
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    rows = B * T * H * W
    kernels.require(g.shape == x.shape and g.dtype == x.dtype
                    and tuple(qkv.shape) == (rows, 3 * C)
                    and tuple(attn.shape) == (rows, C),
                    f"{name}: g / saved scratch do not match x")
    kernels.require_on(dev, name, g, qkv, attn)
    dattn = torch.empty((rows, C), dtype=x.dtype, device=dev)
    dqkv = torch.empty((rows, 3 * C), dtype=x.dtype, device=dev)
    work = torch.empty(kernels.query("stswin_block_attention_bwd_work", rows,
                                     C, heads, TN), **f32)
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
                   P(mask_tiled), P(dattn), P(dqkv), P(work), P(dx),
                   P(dwqkv), P(dbqkv), P(dwproj), P(dbproj), P(dbias), B, T,
                   H, W, C, heads, ws, float(scale), shift, n_mask)
    swin_block_attention_bwd.launches += 1
    return dx, dwqkv, dbqkv, dwproj, dbproj, dbias


swin_block_attention_bwd.launches = 0


def swin_block_attention_bwd_f32(x, g, qkv, attn, wqkv, wproj, bias_tiled,
                                 mask_tiled, heads: int, scale: float,
                                 ws: int, shift: int = 0):
    """K5's fp32 form (`stswin_block_attention_bwd_f32`,
    `csrc/fp32_train.cu`): `swin_block_attention_bwd` on fp32 CUDA tensors
    with K1 fp32's window-order scratch; every product 3xTF32 on the
    tensor cores (the fp32 GEMMs, `wgrad_f32`, the attention backward of
    `csrc/fp32_attention_bwd.cuh`), P and dS in fp32, every sum over
    windows and rows in a fixed order.
    Returns (dx, dwqkv, dbqkv, dwproj, dbproj, dbias_tiled), fp32."""
    name = "swin_block_attention_bwd_f32"
    mask_tiled, n_mask = _validate(name, None, x, wqkv, wproj, bias_tiled,
                                   mask_tiled, heads, ws, shift,
                                   _attn_f32_bwd_smem_bytes)
    check_backward_window(name, x, heads, ws)
    B, T, H, W, C = x.shape
    TN = T * ws * ws
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    rows = B * T * H * W
    kernels.require(g.shape == x.shape and g.dtype == x.dtype
                    and tuple(qkv.shape) == (rows, 3 * C)
                    and tuple(attn.shape) == (rows, C)
                    and qkv.dtype == attn.dtype == x.dtype,
                    f"{name}: g / saved scratch do not match x")
    kernels.require_on(dev, name, g, qkv, attn)
    work = torch.empty(kernels.query("stswin_block_attention_bwd_f32_work",
                                     rows, C, heads, TN), **f32)
    dx = torch.empty_like(x)
    dwqkv = torch.empty((3 * C, C), **f32)
    dbqkv = torch.empty(3 * C, **f32)
    dwproj = torch.empty((C, C), **f32)
    dbproj = torch.empty(C, **f32)
    dbias = torch.empty((heads, TN, TN), **f32)
    wqkv_t, wproj_t = wqkv.t().contiguous(), wproj.t().contiguous()
    P = kernels.ptr
    kernels.launch("stswin_block_attention_bwd_f32", dev, P(x), P(g), P(qkv),
                   P(attn), P(wqkv_t), P(wproj_t), P(bias_tiled),
                   P(mask_tiled), P(work), P(dx), P(dwqkv), P(dbqkv),
                   P(dwproj), P(dbproj), P(dbias), B, T, H, W, C, heads, ws,
                   float(scale), shift, n_mask)
    swin_block_attention_bwd_f32.launches += 1
    return dx, dwqkv, dbqkv, dwproj, dbproj, dbias


swin_block_attention_bwd_f32.launches = 0


def attn_bwd_ref(qkv, dattn, bias_tiled, mask_tiled, heads: int,
                 scale: float, TN: int):
    """Plain twin of K5's attention backward alone, in qkv's dtype:
    autograd of the window attention (`attend_tiled`: the scale after the
    product, the tiled bias, the mask of window bw % n_mask, fp32 P, in
    bf16 rounded before P V) over window-order qkv (rows, 3C), given the
    gradient dattn (rows, C) of its output. Returns (dqkv (rows, 3C) in
    qkv's dtype, dbias (heads, TN, TN) fp32)."""
    rows, C3 = qkv.shape
    C, hd = C3 // 3, C3 // 3 // heads
    with torch.enable_grad():
        leaves = [qkv.detach().requires_grad_(),
                  bias_tiled.detach().float().requires_grad_()]
        q, k, v = (leaves[0].reshape(rows // TN, TN, 3, heads, hd)
                   .permute(2, 0, 3, 1, 4).unbind(0))
        out = attend_tiled(q, k, v, leaves[1], mask_tiled, scale)
        out = out.permute(0, 2, 1, 3).reshape(rows, C)
        return torch.autograd.grad(out, leaves, dattn.to(out.dtype))


def attn_bwd_f32_ref(qkv, dattn, bias_tiled, mask_tiled, heads: int,
                     scale: float, TN: int):
    """Plain twin of K5 fp32's attention backward alone: `attn_bwd_ref` on
    qkv and dattn in fp32. Returns (dqkv (rows, 3C), dbias (heads, TN,
    TN)), fp32."""
    return attn_bwd_ref(qkv.float(), dattn.float(), bias_tiled, mask_tiled,
                        heads, scale, TN)


def attn_bwd(qkv, dattn, attn, bias_tiled, mask_tiled, heads: int,
             scale: float, TN: int):
    """K5 bf16's attention backward alone (`stswin_attn_bwd`,
    `csrc/block_attention.cu`): the second of K5's four steps, over its
    workspace, for timing and checking it by itself; the twin
    `attn_bwd_ref` on a CPU tensor. qkv (rows, 3C), dattn and attn, the
    forward's attention output (rows, C), bf16 in window order (rows =
    windows x TN); bias (heads, TN, TN), mask (n_mask, TN, TN) or None. The
    slot kernel where it takes the window, else the two passes
    (`_attn_bwd_plan_bytes`). Returns (dqkv bf16, dbias fp32)."""
    if qkv.device.type == "cpu":
        return attn_bwd_ref(qkv, dattn, bias_tiled, mask_tiled, heads, scale,
                            TN)
    name = "attn_bwd"
    kernels.require(qkv.is_cuda, f"{name}: no kernel for device "
                    f"{qkv.device}")
    kernels.require_form(name, "Pallas row 6's attention", qkv, dattn, attn)
    rows, C3 = qkv.shape
    C = C3 // 3
    kernels.require(C3 == 3 * C and C % heads == 0 and rows % TN == 0
                    and tuple(dattn.shape) == tuple(attn.shape) == (rows, C)
                    and all(t.is_contiguous() and t.data_ptr() % 16 == 0
                            for t in (qkv, dattn, attn)),
                    f"{name}: qkv {tuple(qkv.shape)}, dattn "
                    f"{tuple(dattn.shape)}, attn {tuple(attn.shape)} for "
                    f"{heads} heads, TN {TN}")
    hd = C // heads
    kernels.require(_attn_bwd_takes(TN, hd), f"{name}: K5 does not take "
                    f"{TN} tokens x head dim {hd}")
    mask_tiled, n_mask = check_attention_core(
        name, qkv.device, bias_tiled, mask_tiled, heads, TN, hd,
        _attn_bwd_plan_bytes)
    kernels.require_on(qkv.device, name, qkv, dattn, attn)
    f32 = dict(dtype=torch.float32, device=qkv.device)
    work = torch.empty(kernels.query("stswin_attn_bwd_work", rows, C, heads,
                                     TN), **f32)
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty((heads, TN, TN), **f32)
    P = kernels.ptr
    kernels.launch("stswin_attn_bwd", qkv.device, P(qkv), P(dattn), P(attn),
                   P(bias_tiled), P(mask_tiled), P(work), P(dqkv), P(dbias),
                   rows, C, heads, TN, float(scale), n_mask)
    attn_bwd.launches += 1
    return dqkv, dbias


attn_bwd.launches = 0


def attn_bwd_f32(qkv, dattn, bias_tiled, mask_tiled, heads: int,
                 scale: float, TN: int):
    """K5 fp32's attention backward alone (`stswin_attn_bwd_f32`,
    `csrc/fp32_train.cu`): the second of K5 fp32's four steps, over its
    workspace, for timing and checking it by itself; the twin
    `attn_bwd_f32_ref` on a CPU tensor. qkv (rows, 3C) and dattn (rows,
    C) fp32 in window order (rows = windows x TN), bias (heads, TN, TN),
    mask (n_mask, TN, TN) or None. Returns (dqkv, dbias), fp32."""
    if qkv.device.type == "cpu":
        return attn_bwd_f32_ref(qkv, dattn, bias_tiled, mask_tiled, heads,
                                scale, TN)
    name = "attn_bwd_f32"
    kernels.require(qkv.is_cuda, f"{name}: no kernel for device "
                    f"{qkv.device}")
    kernels.require_f32(name, qkv, dattn)
    rows, C3 = qkv.shape
    C = C3 // 3
    kernels.require(C3 == 3 * C and C % heads == 0 and rows % TN == 0
                    and tuple(dattn.shape) == (rows, C)
                    and qkv.is_contiguous() and dattn.is_contiguous(),
                    f"{name}: qkv {tuple(qkv.shape)}, dattn "
                    f"{tuple(dattn.shape)} for {heads} heads, TN {TN}")
    hd = C // heads
    kernels.require(_attn_f32_bwd_takes(TN, hd), f"{name}: K5's fp32 form "
                    f"does not take {TN} tokens x head dim {hd}")
    mask_tiled, n_mask = check_attention_core(
        name, qkv.device, bias_tiled, mask_tiled, heads, TN, hd,
        _attn_f32_bwd_smem_bytes)
    kernels.require_on(qkv.device, name, qkv, dattn)
    f32 = dict(dtype=torch.float32, device=qkv.device)
    work = torch.empty(kernels.query("stswin_block_attention_bwd_f32_work",
                                     rows, C, heads, TN), **f32)
    dqkv = torch.empty((rows, 3 * C), **f32)
    dbias = torch.empty((heads, TN, TN), **f32)
    P = kernels.ptr
    kernels.launch("stswin_attn_bwd_f32", qkv.device, P(qkv), P(dattn),
                   P(bias_tiled), P(mask_tiled), P(work), P(dqkv), P(dbias),
                   rows, C, heads, TN, float(scale), n_mask)
    attn_bwd_f32.launches += 1
    return dqkv, dbias


attn_bwd_f32.launches = 0


class BlockAttentionFn(torch.autograd.Function):
    """K1 forward, K5 backward, each in x's dtype (bf16 or the fp32
    forms); the twins on the CPU. Weights arrive in any float dtype (the
    model's fp32 parameters) and are cast to x's dtype; their gradients
    return in their own dtype, from K5's fp32 accumulators on CUDA."""

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
        check_backward_window("swin_block_attention", x, heads, ws)
        fwd = _forward_f32 if x.dtype == torch.float32 else _forward_kernel
        out, qkv, attn = fwd(x, wq, bqkv, wp, bproj, bias_tiled, mask_tiled,
                             heads, scale, ws, shift)
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
            bwd = (swin_block_attention_bwd_f32 if x.dtype == torch.float32
                   else swin_block_attention_bwd)
            grads = bwd(x, g, qkv, attn, wq, wp, bias_tiled, mask_tiled,
                        heads, scale, ws, shift)
        dx, *dparams = grads
        dparams = [d.to(t) for d, t in zip(dparams, ctx.dtypes)]
        return (dx, *dparams, None, None, None, None, None)
