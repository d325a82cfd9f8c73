"""Row 17: the fused 3x3 (dilated) conv + folded BatchNorm + residual +
ReLU.

Counterpart of `stswincl_tpu/ops/pallas_conv.py` (`conv3x3_bn_act`,
`supports`, `fold_bn`). Like the JAX kernel, no model path routes it:
`tools/profile_conv_kernel.py` times it against cuDNN. `conv3x3_bn_act`
launches `stswin_conv3x3_bn_act` (`csrc/conv.cu`: an implicit GEMM on the
Hopper GEMM of `csrc/gemm_sm90.cu`, which the library counts as its form
"conv", `ops.gemm.launch_counts`) on a CUDA tensor and runs the plain twin
`conv3x3_bn_act_ref` on a CPU tensor. The kernel's schedule is set here:
`patch_shape` picks the bh x bw output patch of a 128-row tile,
`pack_weights` lays w out tap-major with each tap's channels padded to a
multiple of 64. There is no backward: the JAX kernel has no VJP.

Layouts: x, residual and the output NHWC (the JAX layout); w OIHW (the
torch layout that `ckpt/from_jax.py` maps the JAX HWIO kernel onto).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stswincl_tpu_torch import kernels

CIN_MULTIPLE, COUT_MULTIPLE = 32, 8  # the envelope; the kernel's 16-byte stores
MAX_ROW_TILES = 65535  # 128-pixel tiles a call (the envelope)
TILE_ROWS, K_TILE = 128, 64  # output pixels a tile; channels a k tile
PATCH_WIDTHS = (8, 16, 32, 64, 128)  # bw of a patch; bh = TILE_ROWS // bw


def conv3x3_bn_act_ref(x, w, scale, shift, *, dilation: int = 1,
                       relu: bool = True, residual=None):
    """Plain twin: `F.conv2d` in fp32 on x and w rounded to x's dtype
    (stride 1, padding = dilation), then * scale + shift, + residual and
    ReLU in fp32, rounded to x's dtype. On a card the caller turns TF32
    off (`torch.backends.cudnn.allow_tf32`), or the fp32 conv is not
    fp32."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.to(x.dtype).float(),
                 padding=dilation, dilation=dilation).permute(0, 2, 3, 1)
    y = y * scale.float() + shift.float()
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = y.clamp_min(0.0)
    return y.to(x.dtype).contiguous()


def supports(x_shape, w_shape, dilation: int, stride: int) -> bool:
    """The port kernel's envelope: a 3x3 kernel, stride 1, any dilation,
    Cin a multiple of 32 (TMA wants 16-byte pixel strides; the channels up
    to the 64 of a k tile are zero-filled), Cout a multiple of 8 (16-byte
    stores), at most 65535 tiles of 128 output pixels. x_shape NHWC,
    w_shape OIHW.

    The Pallas envelope (`pallas_conv.supports`, w HWIO) also asks for Cin
    and Cout multiples of 128 (the TPU's lanes), W a multiple of 16 and a
    row band that fits VMEM with the resident weights: TPU limits that are
    not ported. So the profiler's layer1 shape, 64 -> 64 at 128x160, is
    outside the Pallas envelope and inside this one."""
    N, H, W, cin = x_shape
    cout, w_cin, kh, kw = w_shape
    if (kh, kw) != (3, 3) or stride != 1 or dilation < 1 or w_cin != cin:
        return False
    if cin % CIN_MULTIPLE or cout % COUT_MULTIPLE or min(N, H, W) < 1:
        return False
    return -(-N * H * W // 128) <= MAX_ROW_TILES


def patch_shape(H: int, W: int) -> tuple:
    """(bh, bw): the output patch of one 128-row tile of the kernel, bh x
    bw = 128 pixels of one image, one TMA box a tap. The fewest pixels of
    padding over an image tiled by it, the widest among equals: 64x80 ->
    (8, 16), 32x40 -> (16, 8), 128x160 -> (4, 32), each tiling exactly."""
    def cost(bw):
        bh = TILE_ROWS // bw
        return (-(-H // bh) * bh * (-(-W // bw) * bw), -bw)
    bw = min(PATCH_WIDTHS, key=cost)
    return TILE_ROWS // bw, bw


def pack_weights(w):
    """w (Cout, Cin, 3, 3) OIHW -> (Cout, 9 * Cin64), tap-major (tap = 3 ky
    + kx), each tap's channels zero-padded to Cin64 = 64 * ceil(Cin / 64):
    the GEMM's Wt, whose k tile kt is channel block kt % (Cin64 / 64) of
    tap kt // (Cin64 / 64)."""
    cout, cin = w.shape[:2]
    cin64 = -(-cin // K_TILE) * K_TILE
    wt = w.permute(0, 2, 3, 1)
    if cin64 != cin:
        wt = F.pad(wt, (0, cin64 - cin))
    return wt.reshape(cout, 9 * cin64).contiguous()


def _kernel(x, w, scale, shift, dilation, relu, residual):
    """Launch row 17 (w already in x's dtype)."""
    name = "conv3x3_bn_act"
    kernels.require(x.is_cuda, lambda: f"{name}: no kernel for device "
                    f"{x.device}")
    kernels.require_bf16_cuda(name, x, w,
                              *(() if residual is None else (residual,)))
    kernels.require_f32(name, scale, shift)
    kernels.require_on(x.device, name, x, scale, shift, residual)
    kernels.require(w.device == x.device, lambda: f"{name}: w on {w.device}")
    N, H, W, cin = x.shape
    cout = w.shape[0]
    kernels.require(supports(tuple(x.shape), tuple(w.shape), dilation, 1),
                    lambda: f"{name}: x {tuple(x.shape)} (NHWC), w "
                    f"{tuple(w.shape)} (OIHW), dilation {dilation}: needs a "
                    f"3x3 w over x's channels, Cin a multiple of "
                    f"{CIN_MULTIPLE}, Cout of {COUT_MULTIPLE}, dilation >= 1")
    kernels.require(scale.shape == (cout,) and shift.shape == (cout,)
                    and (residual is None
                         or residual.shape == (N, H, W, cout)),
                    lambda: f"{name}: scale, shift or residual do not match "
                    f"Cout {cout}")
    wt = pack_weights(w)
    bh, bw = patch_shape(H, W)
    out = torch.empty((N, H, W, cout), dtype=x.dtype, device=x.device)
    P = kernels.ptr
    kernels.launch("stswin_conv3x3_bn_act", x.device, P(x), P(wt), P(scale),
                   P(shift), P(residual), P(out), N, H, W, cin, cout,
                   int(dilation), int(relu), bh, bw)
    conv3x3_bn_act.launches += 1
    return out


def conv3x3_bn_act(x, w, scale, shift, *, dilation: int = 1,
                   relu: bool = True, residual=None):
    """Pallas row 17: y = [relu](conv3x3_d(x, w) * scale + shift
    [+ residual]). x (N, H, W, Cin) NHWC; w (Cout, Cin, 3, 3) OIHW in any
    float dtype (cast to x's); scale, shift (Cout,) fp32 (inference-folded
    BatchNorm, `fold_bn`); residual (N, H, W, Cout) or None. Returns
    (N, H, W, Cout) in x's dtype. A CUDA call outside `supports` raises."""
    if x.device.type == "cpu":
        return conv3x3_bn_act_ref(x, w, scale, shift, dilation=dilation,
                                  relu=relu, residual=residual)
    return _kernel(x, w.to(x.dtype), scale, shift, dilation, relu, residual)


conv3x3_bn_act.launches = 0


def fold_bn(gamma, beta, mean, var, eps: float = 1e-5):
    """Inference BatchNorm -> (scale, shift) with y = x * scale + shift."""
    scale = gamma / torch.sqrt(var + eps)
    return scale, beta - mean * scale
