"""Joint space-time window attention, and the row-11 kernel.

Counterpart of `stswincl_tpu/ops/attention.py` and
`stswincl_tpu/ops/pallas_attention.py`. `attend_tiled` is the shared
softmax contract of every attention path in both packages: fp32 scores,
the scale applied to the fp32 scores after the matmul, the tiled relative
bias added, the mask added only when there is one per window, and the row
sum applied as a multiply by its reciprocal.

`fused_window_attention` (Pallas row 11, `fused_window_attention`) attends
over pre-partitioned q, k, v: it launches `stswin_window_attention_heads`
(`csrc/window_attention.cu`) on a bf16 CUDA tensor, its fp32 form
(`fused_window_attention_f32`, `stswin_window_attention_heads_f32` in
`csrc/fp32_forms.cu`) on an fp32 one, and runs its plain twin
`attend_tiled` on a CPU tensor. When autograd needs a gradient it goes
through `FusedWindowAttentionFn`, whose backward is the JAX package's own
einsum backward, ported to plain PyTorch (the JAX package has no backward
kernel for row 11).
"""

from __future__ import annotations

from typing import Optional

import torch

from stswincl_tpu_torch import kernels


def attend_tiled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 bias_tiled: torch.Tensor, mask_tiled: Optional[torch.Tensor],
                 scale: float) -> torch.Tensor:
    """q, k, v: (Bw, heads, TN, hd); bias_tiled: (heads, TN, TN);
    mask_tiled: (nW, TN, TN) applied to consecutive groups of nW windows,
    or None / a single (1, TN, TN) entry for W-MSA (its zero add is
    skipped). Returns (Bw, heads, TN, hd) in v's dtype."""
    Bw, heads, TN, _ = q.shape
    scores = q.float() @ k.float().transpose(-1, -2)
    scores = scores * scale + bias_tiled.float()[None]
    if mask_tiled is not None and mask_tiled.shape[0] > 1:
        nW = mask_tiled.shape[0]
        scores = (scores.reshape(Bw // nW, nW, heads, TN, TN)
                  + mask_tiled.float()[None, :, None]).reshape(
                      Bw, heads, TN, TN)
    mx = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - mx)
    p = e * (1.0 / e.sum(dim=-1, keepdim=True))
    out = p.to(v.dtype).float() @ v.float()
    return out.to(v.dtype)


def space_time_window_attention(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, rel_bias: torch.Tensor,
                                mask: Optional[torch.Tensor],
                                scale: float) -> torch.Tensor:
    """Attention over joint space-time windows.

    q, k, v: (Bw, heads, T*N, head_dim), tokens ordered frame-major;
    rel_bias: (heads, N, N), tiled T x T; mask: optional (nW, N, N)
    SW-MSA mask, tiled T x T. Returns (Bw, heads, T*N, head_dim)."""
    N = rel_bias.shape[-1]
    T = q.shape[2] // N
    bias = rel_bias.float().repeat(1, T, T)
    m = None if mask is None else mask.float().repeat(1, T, T)
    return attend_tiled(q, k, v, bias, m, scale)


def _align(b: int) -> int:
    return (b + 127) // 128 * 128


# The widest window of the attention core of K1 and rows 10-11: its score
# registers are sized for at most 11 key tiles of 16 (`attn::MAX_NT` in
# `csrc/attention_core.cuh`).
MAX_WINDOW_TOKENS = 176


def _attn_smem_bytes(TN: int, hd: int) -> int:
    """Dynamic shared memory of one (window, head) pair of the attention
    core's resident instance (`attn::pair_smem` in
    `csrc/attention_core.cuh`), what K1, rows 10 and 11 hold for a pair
    where it fits and row 16 for each pair of its attention phase: q, k
    and v in bf16 rows of hd + 8, and the TN row offsets; the scores and P
    stay in registers."""
    return _align(3 * TN * (hd + 8) * 2) + _align(TN * 8)


# The bf16 core's streamed pair (`attn::pairs_streamed`): a ring of
# ATTN_RING slots of TN rows of ATTN_SLOT bf16, each a chunk of 64 columns
# of q and of k (rows of 72) or of 128 of v (rows of 136)
ATTN_RING, ATTN_SLOT = 3, 144


def _attn_plan_bytes(TN: int, hd: int) -> int:
    """Dynamic shared memory of the bf16 attention core of K1 and rows 10
    and 11 for a window (`attn::plan_bytes`, `stswin_attn_smem`): the
    resident pair (`_attn_smem_bytes`) where it fits SMEM_LIMIT, else the
    streamed pair, whose ring takes 864 TN bytes whatever the head dim."""
    resident = _attn_smem_bytes(TN, hd)
    if resident <= kernels.SMEM_LIMIT:
        return resident
    return ATTN_RING * TN * ATTN_SLOT * 2


def attn_streamed_launches(reset: bool = False) -> int:
    """Launches of the bf16 core's streamed instance (K1's, row 10's and
    row 11's bf16 kernels on windows whose resident pair does not fit),
    counted by the library since the last reset; `reset` sets the count to
    0 after reading."""
    return kernels.query("stswin_attn_streamed_launches", int(reset))


def _attn_f32_resident_bytes(TN: int, hd: int) -> int:
    """Dynamic shared memory of the fp32 attention core's resident pair
    (`attn32::smem_bytes` in `csrc/fp32_attention.cuh`), what row 16's fp32
    form holds for each pair of its attention phase: the q-and-k region,
    then v, in fp32 rows of hd + 4 (4 mod 32 words: the tensor-core
    fragment reads of q, k and v fall on distinct banks); the scores and P
    stay in registers. The core runs pairs back to back in this one
    region, the next pair's q and k copied in while this pair's P V runs,
    its v while the next scores are formed. 198 KiB at stage 1 (TN 128, hd
    128), 98 KiB at stage 2 (TN 32, hd 256)."""
    return _align(3 * TN * (hd + 4) * 4)


# The fp32 core's streamed pair (`attn32::pairs_streamed`): a ring of
# F32_RING slots of TN rows of F32_SLOT floats, each a chunk of 32 columns
# of q and of k (rows of 36) or 64 of v (rows of 68)
F32_RING, F32_SLOT = 3, 72


def _attn_f32_smem_bytes(TN: int, hd: int) -> int:
    """Dynamic shared memory of the fp32 attention core of K1 and rows 10
    and 11 for a window (`attn32::plan_bytes`, `stswin_attn_f32_smem`):
    the resident pair (`_attn_f32_resident_bytes`) where it fits, else the
    streamed pair, whose ring takes 864 TN bytes whatever the head dim."""
    resident = _attn_f32_resident_bytes(TN, hd)
    if resident <= kernels.SMEM_LIMIT:
        return resident
    return F32_RING * TN * F32_SLOT * 4


def attn_f32_streamed_launches(reset: bool = False) -> int:
    """Launches of the fp32 core's streamed instance (K1's, row 10's and
    row 11's fp32 forms on windows whose resident pair does not fit),
    counted by the library since the last reset; `reset` sets the count to
    0 after reading."""
    return kernels.query("stswin_attn_f32_streamed_launches", int(reset))


def check_attention_core(name: str, device: torch.device,
                         bias_tiled: torch.Tensor,
                         mask_tiled: Optional[torch.Tensor], heads: int,
                         TN: int, hd: int, smem_bytes=_attn_plan_bytes):
    """What a (window, head) attention block of the kernels takes (K1, K5,
    rows 10, 11 and 16): a token count a multiple of 16 up to
    MAX_WINDOW_TOKENS and a head dim a multiple of 8, with `smem_bytes`, the
    shared memory of the instance that will run, within SMEM_LIMIT (K1's,
    rows 10's and 11's instances fit at every such window; row 16's own
    plan may not); returns (mask or None, n_mask). A single-entry mask is
    the W-MSA marker: it is dropped and its add skipped."""
    if mask_tiled is not None and mask_tiled.shape[0] == 1:
        mask_tiled = None
    kernels.require_f32(name, bias_tiled,
                        *(() if mask_tiled is None else (mask_tiled,)))
    kernels.require_on(device, name, bias_tiled, mask_tiled)
    kernels.require(tuple(bias_tiled.shape) == (heads, TN, TN),
                    f"{name}: bias {tuple(bias_tiled.shape)}, expected "
                    f"{(heads, TN, TN)}")
    n_mask = 0
    if mask_tiled is not None:
        n_mask = mask_tiled.shape[0]
        kernels.require(tuple(mask_tiled.shape[1:]) == (TN, TN),
                        f"{name}: mask {tuple(mask_tiled.shape)}")
    kernels.require(hd > 0 and hd % 8 == 0 and TN % 16 == 0,
                    f"{name}: needs head_dim % 8 and tokens % 16 (hd={hd}, "
                    f"TN={TN})")
    kernels.require(TN <= MAX_WINDOW_TOKENS,
                    f"{name}: window of {TN} tokens, at most "
                    f"{MAX_WINDOW_TOKENS}")
    kernels.require(smem_bytes(TN, hd) <= kernels.SMEM_LIMIT,
                    f"{name}: window of {TN} tokens x {hd} does not fit "
                    "shared memory")
    return mask_tiled, n_mask


def _heads_kernel(q, k, v, bias_tiled, mask_tiled, scale):
    """Launch row 11 in q's dtype: the bf16 kernel, or the fp32 form."""
    f32 = q.dtype == torch.float32
    sfx = "_f32" if f32 else ""
    name = "fused_window_attention" + sfx
    kernels.require(q.is_cuda, f"{name}: no kernel for device {q.device}")
    kernels.require(q.dim() == 4 and q.shape == k.shape == v.shape,
                    f"{name}: q, k, v must share one (Bw, heads, TN, hd) "
                    f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                    f"{tuple(v.shape)}")
    kernels.require_form(name, None if f32 else "Pallas row 11", q, k, v)
    kernels.require_on(q.device, name, q, k, v)
    kernels.require(all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
                    f"{name}: q, k, v must be 16-byte aligned")
    Bw, heads, TN, hd = q.shape
    mask_tiled, n_mask = check_attention_core(
        name, q.device, bias_tiled, mask_tiled, heads, TN, hd,
        _attn_f32_smem_bytes if f32 else _attn_plan_bytes)
    kernels.require(n_mask == 0 or Bw % n_mask == 0,
                    f"{name}: {n_mask} masks do not divide {Bw} windows")
    out = torch.empty_like(v)
    P = kernels.ptr
    kernels.launch("stswin_window_attention_heads" + sfx, q.device, P(q),
                   P(k), P(v), P(bias_tiled), P(mask_tiled), P(out), Bw,
                   heads, TN, hd, float(scale), n_mask)
    form = fused_window_attention_f32 if f32 else fused_window_attention
    form.launches += 1
    return out


def fused_window_attention_f32(q, k, v, bias_tiled, mask_tiled,
                               scale: float) -> torch.Tensor:
    """Row 11's fp32 form (`stswin_window_attention_heads_f32`,
    `csrc/fp32_forms.cu`) on fp32 CUDA q, k, v, the arguments of
    `fused_window_attention`: K1's fp32 attention core on the head-major
    tensors, P unrounded; the windows of the bf16 form, through the
    resident or the streamed pair (`_attn_f32_smem_bytes`)."""
    return _heads_kernel(q, k, v, bias_tiled, mask_tiled, scale)


fused_window_attention_f32.launches = 0


def fused_window_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, bias_tiled: torch.Tensor,
                           mask_tiled: Optional[torch.Tensor],
                           scale: float) -> torch.Tensor:
    """Pallas row 11 (`pallas_attention.py:118`): q, k, v (Bw, heads, TN,
    hd), windows minor (Bw = batch * nW + window); bias_tiled (heads, TN,
    TN) fp32; mask_tiled (nW, TN, TN) fp32, window b taking entry b % nW,
    or None / a single (1, TN, TN) zero entry, the W-MSA marker whose add
    is skipped. q, k, v in bf16 launch the kernel, in fp32 its fp32 form.
    Returns (Bw, heads, TN, hd) in v's dtype."""
    args = (q, k, v, bias_tiled, mask_tiled, scale)
    if kernels.needs_grad(q, k, v, bias_tiled):
        return FusedWindowAttentionFn.apply(*args)
    if q.device.type == "cpu":
        return attend_tiled(*args)
    return _heads_kernel(*args)


fused_window_attention.launches = 0


def fused_window_attention_bwd(q, k, v, bias_tiled, mask_tiled, scale, g):
    """The backward of row 11 in plain PyTorch: a port of the JAX
    package's `_bwd` (`pallas_attention.py:134-166`), not autograd of the
    forward. q is scaled in fp32 before the product, the softmax divides
    by the row sum, and everything is fp32 until dq, dk, dv return in
    their inputs' dtypes; dbias (heads, TN, TN) is summed over the windows.
    The mask takes no gradient."""
    Bw, heads, TN, _ = q.shape
    qf = q.float() * scale
    kf, vf, gf = k.float(), v.float(), g.float()
    scores = qf @ kf.transpose(-1, -2) + bias_tiled.float()[None]
    if mask_tiled is not None and mask_tiled.shape[0] > 1:
        nW = mask_tiled.shape[0]
        scores = (scores.reshape(Bw // nW, nW, heads, TN, TN)
                  + mask_tiled.float()[None, :, None]).reshape(
                      Bw, heads, TN, TN)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dv = p.transpose(-1, -2) @ gf
    dp = gf @ vf.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = (ds @ kf) * scale
    dk = ds.transpose(-1, -2) @ qf
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
            ds.sum(dim=0).to(bias_tiled.dtype))


class FusedWindowAttentionFn(torch.autograd.Function):
    """Row 11: the kernel forward on CUDA in q's dtype (`attend_tiled` on
    the CPU), and `fused_window_attention_bwd`, the port of the JAX custom
    VJP's `_bwd`, as backward on either device."""

    @staticmethod
    def forward(ctx, q, k, v, bias_tiled, mask_tiled, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, bias_tiled, mask_tiled)
        if q.device.type == "cpu":
            return attend_tiled(q, k, v, bias_tiled, mask_tiled, scale)
        return _heads_kernel(q, k, v, bias_tiled, mask_tiled, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias_tiled, mask_tiled = ctx.saved_tensors
        grads = fused_window_attention_bwd(q, k, v, bias_tiled, mask_tiled,
                                           ctx.scale, g)
        return (*grads, None, None)


def space_time_window_attention_fused(q: torch.Tensor, k: torch.Tensor,
                                      v: torch.Tensor, rel_bias: torch.Tensor,
                                      mask: Optional[torch.Tensor],
                                      scale: float) -> torch.Tensor:
    """`space_time_window_attention` through row 11 (counterpart of
    `pallas_attention.py:186-212`): tiles the (heads, N, N) bias and the
    optional (nW, N, N) mask T x T and calls `fused_window_attention`."""
    N = rel_bias.shape[-1]
    T = q.shape[2] // N
    bias = rel_bias.float().repeat(1, T, T).contiguous()
    m = None if mask is None else mask.float().repeat(1, T, T).contiguous()
    return fused_window_attention(q, k, v, bias, m, scale)
