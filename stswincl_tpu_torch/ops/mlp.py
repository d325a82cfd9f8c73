"""GELU with the JAX package's kernel semantics, and Pallas row 12, the
fused MLP fc1 -> GELU -> fc2.

Counterpart of `stswincl_tpu/ops/pallas_mlp.py`. The kernels and their
references use an odd minimax polynomial for erf (`_erf_poly_fast`), not
the library erf, so the port does too; the CUDA device function
`erf_poly_fast` in `csrc/common.cuh` has the same coefficients and Horner
order.

`fused_mlp` (`pallas_mlp.fused_mlp`, `:226`) launches `stswin_mlp`
(`csrc/epilogue.cu`: fc1 and fc2 on the Hopper GEMM of `csrc/gemm_sm90.cu`,
two launches of its bf16 form, shared with row 13) on a CUDA tensor and
runs the plain twin `mlp_ref` on a CPU tensor. When autograd needs a gradient
it goes through `MlpFn`, whose backward is autograd of `mlp_ref`, as
JAX's `_fmlp_bwd` (`:266-277`) is `jax.vjp` of `mlp_ref`. Weights use the
torch Linear layout: w1 (hidden, C), w2 (C, hidden), in any float dtype
(cast to x's dtype for the products; gradients in their own dtype).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from stswincl_tpu_torch import kernels

ERF_CLAMP = 3.0
ERF_C = (1.1282684439e+00, -3.7531498256e-01, 1.1107952331e-01,
         -2.5103008059e-02, 4.2354873714e-03, -5.1105060172e-04,
         4.1062300646e-05, -1.9449437556e-06, 4.0745480824e-08)


def erf_poly_fast(x: torch.Tensor) -> torch.Tensor:
    """erf via the saturated odd polynomial x * P(x^2) on |x| < 3, exactly
    +-1 beyond (max abs error 2.6e-5 against the true erf)."""
    xc = x.clamp(-ERF_CLAMP, ERF_CLAMP)
    t = xc * xc
    p = torch.full_like(t, ERF_C[-1])
    for c in ERF_C[-2::-1]:
        p = p * t + c
    return torch.where(x.abs() < ERF_CLAMP, xc * p, torch.sign(x))


def gelu(x: torch.Tensor, exact: bool = True) -> torch.Tensor:
    """'exact': the erf-form GELU through `erf_poly_fast`; else the tanh
    approximation."""
    if exact:
        return 0.5 * x * (1.0 + erf_poly_fast(x * (2.0 ** -0.5)))
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3)))


def mlp_ref(x, w1, b1, w2, b2, gelu_exact: bool = True):
    """Plain twin of row 12 (port of `pallas_mlp.mlp_ref`): the products
    on x's dtype (the weights cast to it) with fp32 sums, b1 and the GELU
    in fp32, h rounded to x's dtype before fc2, b2 added in fp32 and the
    output rounded once to x's dtype."""
    h = gelu(F.linear(x.float(), w1.to(x.dtype).float(), b1.float()),
             gelu_exact)
    out = F.linear(h.to(x.dtype).float(), w2.to(x.dtype).float(),
                   b2.float())
    return out.to(x.dtype)


def check_mlp_widths(name: str, C: int, hidden: int) -> None:
    """The envelope of the MLP products of rows 12 and 13 (`mlp_gemms`,
    `csrc/epilogue.cu`) on the Hopper GEMM: its A and C row strides (C and
    hidden elements) and its N (hidden for fc1, C for fc2) multiples of 8,
    so that every row is whole 16-byte chunks for TMA and the stores; the
    k tiles past K are TMA's zero fill, so K takes any such width."""
    kernels.require(C > 0 and hidden > 0 and C % 8 == 0 and hidden % 8 == 0,
                    lambda: f"{name}: needs C and hidden multiples of 8 "
                    f"(C={C}, hidden={hidden})")


def _kernel(x, w1, b1, w2, b2, gelu_exact):
    """Launch row 12 (weights already in x's dtype, biases fp32)."""
    name = "fused_mlp"
    kernels.require(x.is_cuda, f"{name}: no kernel for device {x.device}")
    x = x.contiguous()
    kernels.require_bf16_cuda(name, x)
    kernels.require(w1.dtype == x.dtype and w2.dtype == x.dtype,
                    f"{name}: weights must be cast to {x.dtype}")
    kernels.require_f32(name, b1, b2)
    kernels.require_on(x.device, name, x, w1, b1, w2, b2)
    C, hidden = x.shape[-1], w1.shape[0]
    kernels.require(tuple(w1.shape) == (hidden, C)
                    and tuple(w2.shape) == (C, hidden)
                    and tuple(b1.shape) == (hidden,)
                    and tuple(b2.shape) == (C,),
                    f"{name}: w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)} do "
                    f"not map C={C} -> hidden -> C")
    check_mlp_widths(name, C, hidden)
    kernels.require(all(t.is_contiguous() and t.data_ptr() % 16 == 0
                        for t in (x, w1, w2)),
                    f"{name}: x and the weights must be contiguous and "
                    "16-byte aligned")
    rows = x.numel() // C
    out = torch.empty_like(x)
    if rows == 0:
        return out
    hid = torch.empty((rows, hidden), dtype=x.dtype, device=x.device)
    P = kernels.ptr
    kernels.launch("stswin_mlp", x.device, P(x), P(w1), P(b1), P(w2), P(b2),
                   P(hid), P(out), rows, C, hidden, 1 if gelu_exact else 2)
    fused_mlp.launches += 1
    return out


def _forward(x, w1, b1, w2, b2, gelu_exact):
    if x.device.type == "cpu":
        return mlp_ref(x, w1, b1, w2, b2, gelu_exact)
    return _kernel(x, w1.to(x.dtype), b1.float(), w2.to(x.dtype), b2.float(),
                   gelu_exact)


def fused_mlp(x, w1, b1, w2, b2, gelu_exact: bool = True):
    """Pallas row 12: fc2(GELU(fc1(x))) over the last axis of x (any
    leading shape). x: (..., C); w1 (hidden, C), b1 (hidden,), w2
    (C, hidden), b2 (C,). Returns x's shape and dtype."""
    args = (x, w1, b1, w2, b2, gelu_exact)
    if kernels.needs_grad(x, w1, b1, w2, b2):
        return MlpFn.apply(*args)
    return _forward(*args)


fused_mlp.launches = 0


class MlpFn(torch.autograd.Function):
    """Row 12: the kernel forward on CUDA (the twin on the CPU); backward:
    autograd of `mlp_ref` on the saved inputs (JAX's `_fmlp_bwd`)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, gelu_exact):
        ctx.gelu_exact = gelu_exact
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return _forward(x, w1, b1, w2, b2, gelu_exact)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = mlp_ref(*leaves, ctx.gelu_exact)
            grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None)
