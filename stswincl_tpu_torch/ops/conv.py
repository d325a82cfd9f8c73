"""Row 17: the fused 3x3 (dilated) conv + folded BatchNorm + residual +
ReLU.

Counterpart of `stswincl_tpu/ops/pallas_conv.py` (`conv3x3_bn_act`,
`supports`, `fold_bn`). Like the JAX kernel, no model path routes it:
`tools/profile_conv_kernel.py` times it against cuDNN. `conv3x3_bn_act`
launches `stswin_conv3x3_bn_act` (`csrc/conv.cu`, an implicit GEMM) on a
CUDA tensor and runs the plain twin `conv3x3_bn_act_ref` on a CPU tensor.
There is no backward: the JAX kernel has no VJP.

Layouts: x, residual and the output NHWC (the JAX layout); w OIHW (the
torch layout that `ckpt/from_jax.py` maps the JAX HWIO kernel onto).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stswincl_tpu_torch import kernels

CIN_MULTIPLE, COUT_MULTIPLE = 32, 8  # the kernel's k tile; its 16-byte stores
MAX_ROW_TILES = 65535  # 128-pixel tiles: the grid's y extent


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
    Cin a multiple of 32 (a k tile of the implicit GEMM stays within one
    tap), Cout a multiple of 8 (16-byte stores), at most 65535 tiles of
    128 output pixels. x_shape NHWC, w_shape OIHW.

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


def _kernel(x, w, scale, shift, dilation, relu, residual):
    """Launch row 17 (w already in x's dtype)."""
    name = "conv3x3_bn_act"
    kernels.require(x.is_cuda, f"{name}: no kernel for device {x.device}")
    kernels.require_bf16_cuda(name, x, w,
                              *(() if residual is None else (residual,)))
    kernels.require_f32(name, scale, shift)
    kernels.require_on(x.device, name, x, scale, shift, residual)
    kernels.require(w.device == x.device, f"{name}: w on {w.device}")
    N, H, W, cin = x.shape
    cout = w.shape[0]
    kernels.require(supports(tuple(x.shape), tuple(w.shape), dilation, 1),
                    f"{name}: x {tuple(x.shape)} (NHWC), w {tuple(w.shape)} "
                    f"(OIHW), dilation {dilation}: needs a 3x3 w over x's "
                    f"channels, Cin a multiple of {CIN_MULTIPLE}, Cout of "
                    f"{COUT_MULTIPLE}, dilation >= 1")
    kernels.require(tuple(scale.shape) == (cout,)
                    and tuple(shift.shape) == (cout,)
                    and (residual is None
                         or tuple(residual.shape) == (N, H, W, cout)),
                    f"{name}: scale, shift or residual do not match Cout "
                    f"{cout}")
    # (Cout, 9 * Cin), tap-major: the GEMM's K runs over (ky, kx, ci)
    wt = w.permute(0, 2, 3, 1).reshape(cout, 9 * cin).contiguous()
    out = torch.empty((N, H, W, cout), dtype=x.dtype, device=x.device)
    P = kernels.ptr
    kernels.launch("stswin_conv3x3_bn_act", x.device, P(x), P(wt), P(scale),
                   P(shift), P(residual), P(out), N, H, W, cin, cout,
                   int(dilation), int(relu))
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
