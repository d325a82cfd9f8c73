"""K3: PatchMerging, 2x2 space-to-depth + fp32 LayerNorm over 4C +
bias-free Linear 4C -> 2C.

Counterpart of `fused_patch_merge` and `patch_merge_ref` in
`stswincl_tpu/ops/pallas_patch_merge.py`. `patch_merge` launches the CUDA
kernel in `csrc/patch_merge.cu` on a CUDA tensor and runs the plain twin
`patch_merge_ref` on a CPU tensor. Chunks keep the reference order
[x0 | x1 | x2 | x3]; w uses the torch Linear layout (2C, 4C), in any float
dtype (cast to x's dtype for the product).

When autograd needs a gradient the call goes through `PatchMergeFn`: K3
forward, and as backward autograd of `patch_merge_ref` on the saved
inputs, as the JAX package's `_fpm_bwd` (`pallas_patch_merge.py:158`)
takes the vjp of its reference: the TPU has no patch-merge backward
kernel, so neither does the port.
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
    if kernels.needs_grad(x, scale, bias, w):
        return PatchMergeFn.apply(x, scale, bias, w, eps)
    w = w.to(x.dtype)
    if x.device.type == "cpu":
        return patch_merge_ref(x, scale, bias, w, eps)
    return _forward_kernel(x, scale, bias, w, eps)


def _forward_kernel(x, scale, bias, w, eps):
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


class PatchMergeFn(torch.autograd.Function):
    """K3 forward (the twin on the CPU); backward by autograd of the twin
    on the saved inputs, the gradient of w in w's own dtype."""

    @staticmethod
    def forward(ctx, x, scale, bias, w, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, scale, bias, w)
        wc = w.to(x.dtype)
        if x.device.type == "cpu":
            return patch_merge_ref(x, scale, bias, wc, eps)
        return _forward_kernel(x, scale, bias, wc, eps)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            x, scale, bias, w = leaves
            out = patch_merge_ref(x, scale, bias, w.to(x.dtype), ctx.eps)
            grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None)
