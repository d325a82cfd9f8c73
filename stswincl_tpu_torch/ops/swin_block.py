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
saves only the inputs; its backward re-runs the pair
(`whole_swin_block_pair`: the port's own Functions `BlockAttentionFn` with
shift 0, then `EpilogueFn`) and differentiates it, as `_fwsb_bwd` takes
`jax.vjp` of the two-kernel composition `_whole_block_fused_pair`: on the
card that launches K1, K2, K6 and K5; on the CPU it runs their twins. The
JAX package has no backward kernel for row 16. `whole_swin_block_pair`
with `m_out=True` is row 16's function on the pair's kernels (m rounded
at every shape): the same numbers as row 16 without row 16.

`whole_block_plan` is the host side of the kernel's schedule in Python:
the tiles of 128 token rows in window order, the 4-D TMA box of x each
window of a tile is read by, the slot workspace and the shared memory of
each phase. The wrapper takes its envelope and its workspace from it; the
CPU tests check it. The launch's shared memory is the library's
(`stswin_whole_block_layout`): the wrapper admits a shape on that figure
and raises if the plan's differs.

Weights use the torch Linear layout: wqkv (3C, C), wproj (C, C), w1 (4C,
C), w2 (C, 4C), in any float dtype (cast to x's dtype for the kernel);
the biases, LayerNorm vectors and the tiled relative bias are fp32.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from stswincl_tpu_torch import kernels
from stswincl_tpu_torch.ops.add_ln_mlp import (swin_block_epilogue,
                                               swin_block_epilogue_with_m_ref)
from stswincl_tpu_torch.ops.attention import (_attn_smem_bytes,
                                              check_attention_core)
from stswincl_tpu_torch.ops.block_attention import (check_backward_window,
                                                    swin_block_attention,
                                                    swin_block_attention_ref)

TILE_ROWS = 128  # token rows one block of the kernel owns (whole windows)
# the Hopper GEMM tile's TMA ring (`sm90_tile.cuh`): 6 stages of a 128 x 64
# bf16 A tile and a 128 x 64 bf16 weight tile
RING_BYTES = 6 * 2 * TILE_ROWS * 64 * 2
BARRIER_BYTES = 128  # the ring's full / empty mbarriers and `ready`
ALIGN_SLACK = 1024   # the ring starts 1024-byte aligned
CONSUMER_THREADS = 256  # two warpgroups; one producer warp beside them
PHASES = ("qkv", "attention", "proj", "ln2", "fc1", "fc2", "ln1")


@dataclass(frozen=True)
class WholeBlockPlan:
    """Row 16's schedule for one block call on a (B, T, H, W, C) clip with
    windows of ws x ws x T tokens (`csrc/swin_block.cu`).

    The window-order token rows (`ops.gemm.window_rows` with shift 0) are
    cut into `tiles` tiles of `tile_rows` rows, whole windows each; tile t
    covers windows t * windows_per_tile onwards (the last tile may hold
    fewer). Phase 1 reads each window of a tile as one 4-D TMA box of x,
    `box` = (64 channels, ws, ws, T) at the coordinates of `tile_boxes(t)`.
    Each workspace slot holds `slot_bytes`; `phase_smem` is the shared
    memory each phase uses (the product phases the ring, the attention
    phase `attention_group` pairs of the attention core in the same
    region, the ring idle) and `smem_bytes` the launch's."""
    image: Tuple[int, int, int, int]  # (B, T, H, W)
    ws: int
    C: int
    hidden: int
    heads: int
    tile_rows: int
    window_tokens: int
    windows_per_tile: int
    tiles: int
    box: Tuple[int, int, int, int]
    wide: int  # row stride of the slot's qkv-then-h buffer
    slot_bytes: Dict[str, int]
    pair_bytes: int
    attention_group: int
    phase_smem: Dict[str, int]
    smem_bytes: int

    @property
    def rows(self) -> int:
        B, T, H, W = self.image
        return B * T * H * W

    def tile_windows(self, t: int) -> int:
        """Whole windows of tile t (the last may hold fewer)."""
        return min(self.tile_rows,
                   self.rows - t * self.tile_rows) // self.window_tokens

    def tile_boxes(self, t: int) -> List[Tuple[int, int, int]]:
        """(w0, h0, bt0) of each window's box of tile t: its first column,
        row and frame of the (B * T, H, W) image."""
        _, T, H, W = self.image
        nWw = W // self.ws
        nWin = (H // self.ws) * nWw
        out = []
        for wl in range(self.tile_windows(t)):
            bw = t * self.windows_per_tile + wl
            b, win = divmod(bw, nWin)
            out.append(((win % nWw) * self.ws, (win // nWw) * self.ws,
                        b * T))
        return out


def whole_block_plan(B: int, T: int, H: int, W: int, C: int, hidden: int,
                     heads: int, ws: int) -> WholeBlockPlan:
    """Row 16's plan, or ValueError with the reason for a shape outside
    its envelope: C % 128 == 0, C <= 1024, hidden % 128 == 0, heads
    dividing C, ws dividing H and W, head_dim and TN = T * ws * ws
    multiples of 16, TN dividing 128, and one attention pair (the core's
    `_attn_smem_bytes`) in shared memory."""
    name = "whole_swin_block"
    kernels.require(C % 128 == 0 and C <= 1024 and hidden % 128 == 0
                    and heads > 0 and C % heads == 0,
                    f"{name}: needs C % 128 == 0, C <= 1024, hidden % 128 "
                    f"== 0 and C % heads == 0 (C={C}, hidden={hidden}, "
                    f"heads={heads})")
    kernels.require(ws > 0 and H % ws == 0 and W % ws == 0,
                    f"{name}: ({H}, {W}) over windows of {ws}")
    TN, hd = T * ws * ws, C // heads
    kernels.require(hd % 16 == 0 and TN % 16 == 0,
                    f"{name}: needs head_dim % 16 and tokens % 16 (hd={hd}, "
                    f"TN={TN})")
    kernels.require(TILE_ROWS % TN == 0,
                    f"{name}: windows of {TN} tokens do not tile "
                    f"{TILE_ROWS} rows")
    pair = _attn_smem_bytes(TN, hd)
    fixed = ALIGN_SLACK + BARRIER_BYTES
    group = CONSUMER_THREADS // (TN // 16 * 32)
    while group > 0 and fixed + group * pair > kernels.SMEM_LIMIT:
        group -= 1
    kernels.require(group > 0, f"{name}: a window of {TN} tokens x {hd} "
                    f"({pair} bytes of attention) does not fit shared "
                    "memory")
    phase_smem = {ph: fixed + RING_BYTES for ph in PHASES}
    phase_smem["attention"] = fixed + group * pair
    wide = max(3 * C, hidden)
    rows = B * T * H * W
    return WholeBlockPlan(
        image=(B, T, H, W), ws=ws, C=C, hidden=hidden, heads=heads,
        tile_rows=TILE_ROWS, window_tokens=TN,
        windows_per_tile=TILE_ROWS // TN,
        tiles=-(-rows // TILE_ROWS), box=(64, ws, ws, T), wide=wide,
        slot_bytes={"wide": TILE_ROWS * wide * 2,
                    "narrow": TILE_ROWS * C * 2, "s": TILE_ROWS * C * 4},
        pair_bytes=pair, attention_group=group, phase_smem=phase_smem,
        smem_bytes=max(phase_smem.values()))


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


def whole_swin_block_pair(x, wqkv, bqkv, wproj, bproj, bias_tiled,
                          mask_tiled, s2, b2, w1, b1, w2, bw2, s1, b1n,
                          heads: int, scale: float, ws: int,
                          gelu_exact: bool = True, eps: float = 1e-5,
                          m_out: Optional[bool] = None):
    """The K1 + K2 pair that row 16 fuses (`_whole_block_fused_pair`,
    `pallas_swin_block.py:213`): `swin_block_attention` with shift 0, then
    `swin_block_epilogue` with `m_out` (None: the JAX routing of m; True:
    m rounded before the residual add at every shape, as row 16 rounds
    it, and saved for K6). Takes and returns what `whole_swin_block`
    does."""
    y = swin_block_attention(x, wqkv, bqkv, wproj, bproj, bias_tiled,
                             mask_tiled, heads, scale, ws, 0)
    return swin_block_epilogue(x, y, s2, b2, w1, b1, w2, bw2, s1, b1n,
                               gelu_exact, 0, ws, eps, m_out)


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


@functools.lru_cache(maxsize=None)
def _layout(TN: int, hd: int) -> Tuple[int, int]:
    """(attention pairs a block holds, its dynamic shared memory in bytes)
    as the kernel launches with them (`stswin_whole_block_layout`)."""
    group, total = ctypes.c_int(0), ctypes.c_longlong(0)
    err = kernels.load().stswin_whole_block_layout(
        TN, hd, ctypes.byref(group), ctypes.byref(total))
    if err != 0:
        raise RuntimeError(f"stswin_whole_block_layout: CUDA error {err}")
    return group.value, total.value


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
    kernels.require(all(t.is_contiguous() and t.data_ptr() % 16 == 0
                        for t in (x, wqkv, wproj, w1, w2, *vectors)),
                    f"{name}: x, the weights and the vectors must be "
                    "contiguous and 16-byte aligned")
    plan = whole_block_plan(B, T, H, W, C, hidden, heads, ws)
    group, smem = _layout(plan.window_tokens, C // heads)
    if (group, smem) != (plan.attention_group, plan.smem_bytes):
        raise RuntimeError(
            f"{name}: the plan's layout ({plan.attention_group} attention "
            f"pairs, {plan.smem_bytes} bytes) is not the kernel's ({group}, "
            f"{smem})")
    mask_tiled, n_mask = check_attention_core(
        name, x.device, bias_tiled, mask_tiled, heads, plan.window_tokens,
        C // heads, lambda TN, hd: smem)
    kernels.require(n_mask == 0, f"{name}: the whole-block kernel takes "
                    "W-MSA blocks (shift 0, no attention mask)")
    slots = min(plan.tiles, _slots(T, C, heads, ws))
    dev = x.device
    ws_wide = torch.empty((slots, TILE_ROWS, plan.wide), dtype=x.dtype,
                          device=dev)
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
    `whole_swin_block_pair` (`_fwsb_bwd`, `pallas_swin_block.py:309-320`).
    The mask takes no gradient."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wproj, bproj, bias_tiled, mask_tiled, s2,
                b2, w1, b1, w2, bw2, s1, b1n, heads, scale, ws, gelu_exact,
                eps):
        ctx.cfg = (heads, scale, ws, gelu_exact, eps)
        ctx.save_for_backward(x, wqkv, bqkv, wproj, bproj, bias_tiled,
                              mask_tiled, s2, b2, w1, b1, w2, bw2, s1, b1n)
        if x.is_cuda:  # the backward runs K5
            check_backward_window("whole_swin_block", x, heads, ws)
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
            out = whole_swin_block_pair(*leaves[:6], mask, *leaves[6:],
                                        heads, scale, ws, gelu_exact, eps)
            grads = torch.autograd.grad(out, leaves, g.contiguous())
        return (*grads[:6], None, *grads[6:], None, None, None, None, None)
