"""K3: PatchMerging, 2x2 space-to-depth + fp32 LayerNorm over 4C +
bias-free Linear 4C -> 2C.

Counterpart of `fused_patch_merge` and `patch_merge_ref` in
`stswincl_tpu/ops/pallas_patch_merge.py`. `patch_merge` launches the CUDA
kernel in `csrc/patch_merge.cu` on a CUDA tensor and runs the plain twin
`patch_merge_ref` on a CPU tensor. Chunks keep the reference order
[x0 | x1 | x2 | x3]; w uses the torch Linear layout (2C, 4C).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stswincl_tpu_torch import kernels


def patch_merge_ref(x, scale, bias, w, eps: float = 1e-5):
    """Plain twin: concat, single-pass fp32 variance LayerNorm, normalised
    features rounded to x's dtype, matmul with fp32 accumulation."""
    x0 = x[:, 0::2, 0::2, :]
    x1 = x[:, 1::2, 0::2, :]
    x2 = x[:, 0::2, 1::2, :]
    x3 = x[:, 1::2, 1::2, :]
    xc = torch.cat([x0, x1, x2, x3], dim=-1).float()
    mu = xc.mean(dim=-1, keepdim=True)
    var = (xc * xc).mean(dim=-1, keepdim=True) - mu * mu
    n = (xc - mu) * torch.rsqrt(var + eps)
    n = (n * scale.float() + bias.float()).to(x.dtype)
    return F.linear(n.float(), w.float()).to(x.dtype)


def patch_merge(x, scale, bias, w, eps: float = 1e-5):
    """x: (BT, H, W, C) -> (BT, H/2, W/2, 2C); scale/bias: (4C,) fp32;
    w: (2C, 4C)."""
    if x.device.type == "cpu":
        return patch_merge_ref(x, scale, bias, w, eps)
    name = "patch_merge"
    kernels.require(x.is_cuda, f"{name}: no kernel for device {x.device}")
    kernels.require(x.dim() == 4, f"{name}: x must be (BT, H, W, C)")
    BT, H, W, C = x.shape
    kernels.require_bf16_cuda(name, x, w)
    kernels.require_f32(name, scale, bias)
    kernels.require_on(x.device, name, x, scale, bias, w)
    kernels.require(tuple(scale.shape) == (4 * C,)
                    and tuple(bias.shape) == (4 * C,)
                    and tuple(w.shape) == (2 * C, 4 * C),
                    f"{name}: parameter shapes do not match C={C}")
    kernels.require(H % 2 == 0 and W % 2 == 0 and C % 64 == 0,
                    f"{name}: needs even H, W and C % 64 == 0")
    rows = BT * (H // 2) * (W // 2)
    n = torch.empty((rows, 4 * C), dtype=x.dtype, device=x.device)
    out = torch.empty((BT, H // 2, W // 2, 2 * C), dtype=x.dtype,
                      device=x.device)
    P = kernels.ptr
    kernels.launch("stswin_patch_merge", x.device, P(x), P(scale), P(bias),
                   P(w), P(n), P(out), BT, H, W, C, float(eps))
    patch_merge.launches += 1
    return out


patch_merge.launches = 0
