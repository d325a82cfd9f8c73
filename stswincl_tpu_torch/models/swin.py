"""Space-time shifted-window Swin stack ("STswin").

Counterpart of `stswincl_tpu/models/swin.py`. `attn_impl` picks the
attention route of every block, as in the JAX package (`resolve_attn_impl`):

  * 'pallas_full' ('auto'): K1 (`swin_block_attention`: qkv, attention and
    proj in one launch sequence) followed by K2 (`swin_block_epilogue`).
    SW blocks are roll-free: K1 with shift > 0 reads the unshifted clip and
    leaves its output in the shifted layout, and K2 with the same shift
    reads it back.
  * 'pallas': a qkv linear, the row-10 kernel on the image-layout qkv
    (`windowed_attention_image`), a proj linear;
  * 'pallas_windows': a qkv linear, the window partition, the row-11
    kernel on the partitioned q, k, v (`fused_window_attention`), the
    reverse, a proj linear;
  * 'einsum': the same with `attend_tiled`, no kernel.

On the last three the SW block rolls the clip around the attention and
runs K2 unshifted, as the JAX package's blocks do off the 'pallas_full'
route (`swin.py:403-437`).

`whole_block` is the port's form of the JAX knob `STSWIN_WHOLE_BLOCK=1`
(`swin.py:346-369`): on 'pallas_full', a block with shift 0 and no
`out_frame` runs as one launch of the whole-block kernel, Pallas row 16
(`ops/swin_block.whole_swin_block`), in place of K1 + K2, at every shape
K1 + K2 take (it refuses, with its message, only what they refuse); every
other block keeps its route. Two quirks of the reference are kept:

  * the nonstandard norm order: no pre-norm on the attention branch, and
    x = norm1(x + mlp(norm2(x))) after it (`swin_512.py:234-235`);
  * the temporal pairing schedule [[0:2, 2:4], [1:3], [0:2, 2:4]]; frames
    outside the active pair pass through unchanged.

`kernels` (None: iff the input is on CUDA) chooses the CUDA kernels or
their plain twins. Tensors keep the JAX layout (B, T, H, W, C).

Training: on the kernel route the wrappers take the fp32 parameters
themselves and go through their autograd Functions (K1/K5, K2/K6, K3),
which return fp32 weight gradients from fp32 accumulators; on the plain
route autograd runs through the twins, with the bf16 working copies cast
in the graph (`models/layers.py`). An fp32 model on the kernel route runs
the fp32 forms of K1-K3 forward and of K5 and K6 backward, through the
same Functions, on every route: 'pallas' and 'pallas_windows' on the fp32
forms of rows 10 and 11 in place of K1's, `whole_block` on row 16's for
its W-MSA blocks. `remat` is the JAX stack's
`nn.remat(SpaceTimeSwinBlock)`: with grad enabled each block call runs
under a non-reentrant `torch.utils.checkpoint`, which keeps only the
block's input and recomputes its forward (the same kernels on the same
input) when the backward reaches it. Grad mode stays on in the first
forward, so the working copies stay casts in the graph. Only the swin
blocks are recomputed, not the patch merge or the CNN; without grad it
changes nothing.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from stswincl_tpu_torch.kernels import use_kernels
from stswincl_tpu_torch.models.layers import (CastCache, Dense,
                                              LayerNormParams)
from stswincl_tpu_torch.ops.add_ln_mlp import (swin_block_epilogue,
                                               swin_block_epilogue_ref)
from stswincl_tpu_torch.ops.attention import (attend_tiled,
                                              fused_window_attention)
from stswincl_tpu_torch.ops.block_attention import (
    swin_block_attention, swin_block_attention_ref, windowed_attention_image,
    windowed_attention_image_ref)
from stswincl_tpu_torch.ops.mlp import fused_mlp, mlp_ref
from stswincl_tpu_torch.ops.patch_merge import patch_merge, patch_merge_ref
from stswincl_tpu_torch.ops.swin_block import (whole_swin_block,
                                               whole_swin_block_ref)
from stswincl_tpu_torch.ops.window import (cyclic_shift, partition_qkv,
                                           relative_position_index,
                                           reverse_windows,
                                           shifted_window_attention_mask)

ATTN_IMPLS = ("auto", "pallas_full", "pallas", "pallas_windows", "einsum")


def resolve_attn_impl(attn_impl: str) -> str:
    """The attention route an `attn_impl` name selects: 'auto' is
    'pallas_full', the K1/K2 route; the other names of `ATTN_IMPLS` stand
    for themselves. The JAX package's fallback from 'pallas_full' to
    'pallas' for weights too large for the TPU's VMEM (`swin.py:155-165`)
    is a TPU workaround and is not ported. An unknown name raises
    ValueError here, where the JAX package runs it as 'einsum' (its
    WindowAttention's last branch)."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r}; expected one of "
                         f"{ATTN_IMPLS}")
    return "pallas_full" if attn_impl == "auto" else attn_impl


class WindowAttention(CastCache):
    """qkv / proj / relative-position-bias parameters of one block."""

    def __init__(self, dim: int, window_size: int, num_heads: int):
        super().__init__()
        self.window_size, self.num_heads = window_size, num_heads
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer(
            "rel_index", torch.from_numpy(relative_position_index(
                window_size, window_size).reshape(-1).astype("int64")),
            persistent=False)

    def bias_tiled(self, T: int) -> torch.Tensor:
        """(heads, T*N, T*N) fp32 relative bias, tiled over frame pairs."""
        N = self.window_size ** 2

        def make(table):
            b = table[self.rel_index].reshape(N, N, self.num_heads)
            return b.permute(2, 0, 1).float().repeat(1, T, T).contiguous()
        return self.working("relative_position_bias_table", T, make)

    def attend(self, x: torch.Tensor, mask_tiled: Optional[torch.Tensor],
               scale: float, impl: str, kern: bool,
               dtype: torch.dtype) -> torch.Tensor:
        """qkv -> window attention -> proj on the routes other than
        'pallas_full' (`swin.py:253-290` of the JAX package): x is the
        (B, T, H, W, C) clip in `dtype`, already rolled for SW-MSA;
        mask_tiled (nW, TN, TN) or None. `kern` picks the route's kernel
        (row 10 for 'pallas', row 11 for 'pallas_windows') or its plain
        twin; 'einsum' has no kernel. The linears take the working copies
        (casts in the graph when autograd wants the fp32 parameters'
        gradients). Returns (B, T, H, W, C) in `dtype`."""
        B, T, H, W, _ = x.shape
        ws, heads = self.window_size, self.num_heads
        bias = self.bias_tiled(T)
        qkv = F.linear(x, self.qkv.weight_as(dtype), self.qkv.bias_as(dtype))
        if impl == "pallas":
            attn = (windowed_attention_image if kern
                    else windowed_attention_image_ref)
            out = attn(qkv, bias, mask_tiled, heads, scale, ws)
        else:
            q, k, v = partition_qkv(qkv, heads, ws).contiguous()
            attn = (fused_window_attention
                    if kern and impl == "pallas_windows" else attend_tiled)
            out = reverse_windows(attn(q, k, v, bias, mask_tiled, scale),
                                  B, T, H, W, ws)
        return F.linear(out, self.proj.weight_as(dtype),
                        self.proj.bias_as(dtype))


def _weights_for(kern: bool, dtype: torch.dtype):
    """Dense -> the weight a block hands its op: the fp32 parameter to a
    kernel wrapper that autograd will differentiate (its Function casts
    and returns an fp32 gradient), else the working copy in `dtype`."""
    def weight(dense: Dense) -> torch.Tensor:
        if kern and torch.is_grad_enabled() and dense.weight.requires_grad:
            return dense.weight
        return dense.weight_as(dtype)
    return weight


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2, the JAX package's standalone `Mlp`
    (`stswincl_tpu/models/swin.py:48-82`), parameters `fc1` and `fc2`.

    The JAX module runs Pallas row 12 (`fused_mlp`) on the TPU; the port's
    form of that routing is `kernels`: None runs row 12
    (`ops/mlp.fused_mlp`) iff the input is on CUDA and its plain twin
    `mlp_ref` otherwise, True or False force one of them. Both use the
    kernels' erf polynomial for `gelu_exact`, as the TPU routing does; the
    JAX module off the TPU (flax `nn.gelu`, the exact erf) differs by at
    most the polynomial's 2.6e-5 in the erf. The swin blocks hold an `Mlp`
    for its parameters and fuse the MLP into their epilogue: they never
    call it."""

    def __init__(self, in_features: int, hidden: int, out: int,
                 gelu_exact: bool = True, dtype: torch.dtype = torch.float32,
                 kernels: Optional[bool] = None):
        super().__init__()
        self.gelu_exact, self.dtype, self.kernels = gelu_exact, dtype, kernels
        self.fc1 = Dense(in_features, hidden)
        self.fc2 = Dense(hidden, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kern = use_kernels(self.kernels, x)
        w = _weights_for(kern, self.dtype)
        fn = fused_mlp if kern else mlp_ref
        return fn(x.to(self.dtype).contiguous(), w(self.fc1), self.fc1.bias,
                  w(self.fc2), self.fc2.bias, self.gelu_exact)


class SpaceTimeSwinBlock(nn.Module):
    """One (S)W-MSA block over a 2-frame group: (B, T, H, W, C) ->
    (B, T, H, W, C), or (B, 1, H, W, C) with `out_frame`."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 num_heads: int, window_size: int = 8, shift_size: int = 0,
                 mlp_ratio: float = 4.0, gelu_exact: bool = True,
                 dtype: torch.dtype = torch.float32,
                 kernels: Optional[bool] = None, attn_impl: str = "auto",
                 whole_block: bool = False, remat: bool = False):
        super().__init__()
        H, W = input_resolution
        ws, ss = window_size, shift_size
        if min(H, W) <= ws:  # the reference clamps the window (`:155-158`)
            ss, ws = 0, min(H, W)
        self.input_resolution = (H, W)
        self.window_size, self.shift_size = ws, ss
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.gelu_exact, self.dtype, self.kernels = gelu_exact, dtype, kernels
        self.attn_impl = resolve_attn_impl(attn_impl)
        self.whole_block, self.remat = whole_block, remat
        self.attn = WindowAttention(dim, ws, num_heads)
        self.norm1 = LayerNormParams(dim)
        self.norm2 = LayerNormParams(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, gelu_exact, dtype,
                       kernels)
        self._masks = {}

    def _mask(self, T: int, device) -> Optional[torch.Tensor]:
        if not self.shift_size:
            return None
        key = (T, device)
        if key not in self._masks:
            H, W = self.input_resolution
            m = shifted_window_attention_mask(H, W, self.window_size,
                                              self.shift_size)
            # a normal tensor even when first made under inference_mode
            # (serving): the training Functions save it for their backward
            with torch.inference_mode(False):
                self._masks[key] = torch.from_numpy(m).repeat(
                    1, T, T).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor,
                out_frame: Optional[int] = None) -> torch.Tensor:
        """out_frame: eval dead-compute skip (`final_pair_only`): only that
        group frame's output is consumed, so the epilogue runs on it
        alone; attention still spans both frames. With `remat` and grad
        enabled the block runs under `torch.utils.checkpoint`."""
        if self.remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(
                self.block, x, out_frame, use_reentrant=False)
        return self.block(x, out_frame)

    def block(self, x: torch.Tensor,
              out_frame: Optional[int] = None) -> torch.Tensor:
        """The block's computation (`forward` without the checkpoint)."""
        B, T, H, W, C = x.shape
        assert (H, W) == self.input_resolution, (H, W)
        dt, ss, ws = self.dtype, self.shift_size, self.window_size
        kern = use_kernels(self.kernels, x)
        epi = swin_block_epilogue if kern else swin_block_epilogue_ref
        w = _weights_for(kern, dt)
        a, mlp = self.attn, self.mlp
        x = x.to(dt).contiguous()
        mask = self._mask(T, x.device)
        if (self.whole_block and ss == 0 and out_frame is None
                and self.attn_impl == "pallas_full"):
            whole = whole_swin_block if kern else whole_swin_block_ref
            n1, n2 = self.norm1, self.norm2
            return whole(x, w(a.qkv), a.qkv.bias, w(a.proj), a.proj.bias,
                         a.bias_tiled(T), mask, n2.weight, n2.bias,
                         w(mlp.fc1), mlp.fc1.bias, w(mlp.fc2), mlp.fc2.bias,
                         n1.weight, n1.bias, self.num_heads, self.scale, ws,
                         self.gelu_exact)
        if self.attn_impl == "pallas_full":
            attn = swin_block_attention if kern else swin_block_attention_ref
            y = attn(x, w(a.qkv), a.qkv.bias, w(a.proj), a.proj.bias,
                     a.bias_tiled(T), mask, self.num_heads, self.scale, ws,
                     ss)
            epi_shift = ss
        else:
            # roll, attend, roll back; the epilogue then runs unshifted
            xs = cyclic_shift(x.reshape(B * T, H, W, C), ss)
            y = a.attend(xs.reshape(B, T, H, W, C), mask, self.scale,
                         self.attn_impl, kern, dt)
            y = cyclic_shift(y.reshape(B * T, H, W, C), ss, reverse=True)
            y = y.reshape(B, T, H, W, C).contiguous()
            epi_shift = 0
        if out_frame is not None:
            # the frame axis is orthogonal to the spatial shift: drop the
            # dead frame before the epilogue pays for it
            x = x[:, out_frame:out_frame + 1].contiguous()
            y = y[:, out_frame:out_frame + 1].contiguous()
        return epi(x, y, self.norm2.weight, self.norm2.bias,
                   w(mlp.fc1), mlp.fc1.bias,
                   w(mlp.fc2), mlp.fc2.bias, self.norm1.weight,
                   self.norm1.bias, gelu_exact=self.gelu_exact,
                   shift=epi_shift, ws=ws)


class PatchMerging(nn.Module):
    """2x2 space-to-depth + LayerNorm + Linear(4C -> 2C, no bias), per
    frame: (B, T, H, W, C) -> (B, T, H/2, W/2, 2C)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32,
                 kernels: Optional[bool] = None):
        super().__init__()
        self.dtype, self.kernels = dtype, kernels
        self.norm = LayerNormParams(4 * dim)
        self.reduction = Dense(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, H, W, C = x.shape
        kern = use_kernels(self.kernels, x)
        fn = patch_merge if kern else patch_merge_ref
        out = fn(x.to(self.dtype).reshape(B * T, H, W, C), self.norm.weight,
                 self.norm.bias, _weights_for(kern, self.dtype)(self.reduction))
        return out.reshape(B, T, H // 2, W // 2, 2 * C)


# temporal pair schedule: (start, stop) frame groups per layer (`:287`)
PAIR_SCHEDULE = (((0, 2), (2, 4)), ((1, 3),), ((0, 2), (2, 4)))


def _apply_paired(block_pair, x, pairs, out_frame=None, g0_out_frame=None):
    """Apply a (W-MSA, SW-MSA) block pair to x (B, 4, H, W, C) under the
    temporal group schedule. The two-group schedule folds both groups into
    the batch axis; the [1:3] group passes the outer frames through.
    `out_frame` / `g0_out_frame`: the `final_pair_only` elisions; dead
    slots of the result carry pass-through filler that nothing reads."""
    B, T, H, W, C = x.shape
    w_blk, sw_blk = block_pair
    if pairs == ((0, 2), (2, 4)):
        if g0_out_frame is not None:
            g01 = sw_blk(w_blk(x[:, 0:2]), g0_out_frame)
            g23 = sw_blk(w_blk(x[:, 2:4]))
            return torch.cat([x[:, 0:1].to(g01.dtype), g01, g23], dim=1)
        xr = sw_blk(w_blk(x.reshape(B * 2, 2, H, W, C)))
        return xr.reshape(B, T, H, W, C)
    if pairs == ((1, 3),):
        mid = sw_blk(w_blk(x[:, 1:3]), out_frame)
        if out_frame is not None:
            assert out_frame == 1  # frame 2 feeds the next layer's group
            head = x[:, 0:2]
        else:
            head = x[:, 0:1]
        return torch.cat([head.to(mid.dtype), mid,
                          x[:, 3:4].to(mid.dtype)], dim=1)
    if pairs == ((2, 4),):
        tail = sw_blk(w_blk(x[:, 2:4]), out_frame)
        if out_frame is not None:
            assert out_frame == 1  # only frame -1 feeds the heads
            head = x[:, 0:3]
        else:
            head = x[:, 0:2]
        return torch.cat([head.to(tail.dtype), tail], dim=1)
    raise ValueError(f"unsupported pair schedule {pairs}")


class SwinTemporalStack(nn.Module):
    """The full STswin module: `depths[0]` paired layers at (H, W) with
    window 8 / shift 4, patch merging, `depths[1]` paired layers at
    (H/2, W/2) with window 4 / shift 2. `whole_block` and `remat`: see
    the module docstring.

    Input (B, 4, H, W, C); output (stage1 (B, 4, H, W, C),
    stage2 (B, 4, H/2, W/2, 2C))."""

    def __init__(self, dim: int = 512,
                 input_resolution: Tuple[int, int] = (64, 80),
                 num_heads: int = 4, gelu_exact: bool = True,
                 final_pair_only: bool = False,
                 depths: Tuple[int, int] = (3, 3),
                 dtype: torch.dtype = torch.float32,
                 kernels: Optional[bool] = None, attn_impl: str = "auto",
                 whole_block: bool = False, remat: bool = False):
        super().__init__()
        H, W = input_resolution
        self.input_resolution = (H, W)
        self.final_pair_only = final_pair_only
        self.depths = tuple(depths)
        common = dict(gelu_exact=gelu_exact, dtype=dtype, kernels=kernels,
                      attn_impl=attn_impl, whole_block=whole_block,
                      remat=remat)
        d1, d2 = self.depths
        for i in range(d1 + d2):
            stage1 = i < d1
            c, res = (dim, (H, W)) if stage1 else (2 * dim, (H // 2, W // 2))
            ws = 8 if stage1 else 4
            self.add_module(f"layers_{i}_w", SpaceTimeSwinBlock(
                c, res, num_heads, ws, 0, **common))
            self.add_module(f"layers_{i}_sw", SpaceTimeSwinBlock(
                c, res, num_heads, ws, ws // 2, **common))
        self.downsample = PatchMerging(dim, dtype, kernels)

    def pair(self, i: int):
        return (getattr(self, f"layers_{i}_w"), getattr(self, f"layers_{i}_sw"))

    def forward(self, x: torch.Tensor,
                layer0_cached: Optional[torch.Tensor] = None,
                layer0_only: bool = False):
        """Streaming modes (`pipelines.streaming.StreamingSegmenter`):

        * `layer0_only`: x is ONE temporal group (B, 2, H, W, C); returns
          the first layer pair's output for it. Layer 0 has no
          absolute-position input, so the result does not depend on where
          the pair sits in the clip: it seeds the streaming cache.
        * `layer0_cached`: the (B, 2, H, W, C) layer-0 output of frames
          (0, 1), computed two steps earlier when that pair sat at
          positions (2, 3). Layer 0 then runs only on the new (2, 4) group,
          and the call returns (stage1, stage2, g_new)."""
        B, T, H, W, C = x.shape
        assert (H, W) == self.input_resolution, (H, W)
        if layer0_only:
            assert T == 2, "layer0_only expects one (B, 2, H, W, C) group"
            w_blk, sw_blk = self.pair(0)
            return sw_blk(w_blk(x))
        assert T == 4, "temporal stack expects clips of 4 frames"
        d1, d2 = self.depths
        g_new = None
        for i in range(d1):
            if i == 0 and layer0_cached is not None:
                w_blk, sw_blk = self.pair(0)
                g_new = sw_blk(w_blk(x[:, 2:4]))
                x = torch.cat([layer0_cached.to(g_new.dtype), g_new], dim=1)
            else:
                x = _apply_paired(self.pair(i), x, PAIR_SCHEDULE[i % 2])
        stage1 = x
        x = self.downsample(x)
        for i in range(d2):
            pairs = PAIR_SCHEDULE[i % 2]
            of = g0of = None
            # the same dead-compute elisions as the JAX stack
            # (`stswincl_tpu/models/swin.py:670-693`)
            if self.final_pair_only and i == d2 - 1 and len(pairs) == 2:
                pairs, of = ((2, 4),), 1
            elif (self.final_pair_only and i == d2 - 2
                  and pairs == ((1, 3),) and (d2 - 1) % 2 == 0):
                of = 1
            elif self.final_pair_only and i == 0 and d2 == 3:
                g0of = 1
            x = _apply_paired(self.pair(i + d1), x, pairs, out_frame=of,
                              g0_out_frame=g0of)
        if layer0_cached is not None:
            return stage1, x, g_new
        return stage1, x
