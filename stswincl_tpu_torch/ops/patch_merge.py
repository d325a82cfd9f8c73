"""K3: PatchMerging, 2x2 space-to-depth + fp32 LayerNorm over 4C +
bias-free Linear 4C -> 2C.

Counterpart of `fused_patch_merge` and `patch_merge_ref` in
`stswincl_tpu/ops/pallas_patch_merge.py`. `patch_merge` launches the CUDA
kernel in `csrc/patch_merge.cu` (a LayerNorm pass, then the product on the
Hopper GEMM; the same bits as the wmma kernel it replaced) on a CUDA
tensor and runs the plain twin `patch_merge_ref` on a CPU tensor. Chunks
keep the reference order [x0 | x1 | x2 | x3]; w uses the torch Linear
layout (2C, 4C), in any float dtype (cast to x's dtype for the product).

When autograd needs a gradient the call goes through `PatchMergeFn`: K3
forward; the backward is the vjp of `patch_merge_ref`, as the JAX
package's `_fpm_bwd` (`pallas_patch_merge.py:158`) takes it (the TPU has
no patch-merge backward kernel, so neither does the port): the normalised
features n recomputed by the twin's LayerNorm, dn = g @ w and dW = g^T @ n
as products in x's dtype with fp32 accumulation (dn rounded to x's dtype,
dW to x's dtype and then w's, as XLA's vjp rounds them), and the
LayerNorm's backward and the 2x2 scatter by autograd of the twin's
LayerNorm. On bf16 tensors the products run on the tensor cores
(`torch.mm`); an fp32 model keeps fp32 products.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stswincl_tpu_torch import kernels


def patch_merge_ln_ref(x, scale, bias, eps: float = 1e-5):
    """The twin's first half: concat, single-pass fp32 variance LayerNorm,
    the normalised features n rounded to x's dtype, (BT, H/2, W/2, 4C)."""
    x0 = x[:, 0::2, 0::2, :]
    x1 = x[:, 1::2, 0::2, :]
    x2 = x[:, 0::2, 1::2, :]
    x3 = x[:, 1::2, 1::2, :]
    xc = torch.cat([x0, x1, x2, x3], dim=-1).float()
    mu = xc.mean(dim=-1, keepdim=True)
    var = (xc * xc).mean(dim=-1, keepdim=True) - mu * mu
    n = (xc - mu) * torch.rsqrt(var + eps)
    return (n * scale.float() + bias.float()).to(x.dtype)


def patch_merge_ref(x, scale, bias, w, eps: float = 1e-5):
    """Plain twin: `patch_merge_ln_ref`, then the matmul with fp32
    accumulation."""
    n = patch_merge_ln_ref(x, scale, bias, eps)
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
    kernels.require(H % 2 == 0 and W % 2 == 0 and C % 8 == 0,
                    f"{name}: needs even H, W and C % 8 == 0")
    # float2 loads of the LayerNorm's scale and bias
    scale, bias = (t if t.data_ptr() % 8 == 0 else t.clone()
                   for t in (scale, bias))
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


def _product(a, b, dtype):
    """a @ b in a's dtype with fp32 accumulation, rounded to `dtype`. The
    bf16 product on the card asks for an fp32 output, so that a split of
    the long reduction (dW sums over every token row) adds in fp32."""
    if a.dtype == torch.float32:
        return (a @ b).to(dtype)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32).to(dtype)
    return (a.float() @ b.float()).to(dtype)


class PatchMergeFn(torch.autograd.Function):
    """K3 forward (the twin on the CPU); backward the vjp of the twin on
    the saved inputs (module docstring), the gradient of w in w's own
    dtype."""

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
        x, scale, bias, w = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (x, scale, bias)]
            n = patch_merge_ln_ref(*leaves, ctx.eps)
        C4 = n.shape[-1]
        g2 = g.reshape(-1, C4 // 2).to(x.dtype)
        n2 = n.detach().reshape(-1, C4)
        dn = _product(g2, w.to(x.dtype), x.dtype)
        dw = _product(g2.t(), n2, x.dtype).to(w.dtype)
        grads = torch.autograd.grad(n, leaves, dn.reshape(n.shape))
        return (*grads, dw, None)
