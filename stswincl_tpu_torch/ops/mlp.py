"""GELU with the JAX package's kernel semantics (plain PyTorch).

Counterpart of `_erf_poly_fast` and `_gelu` in
`stswincl_tpu/ops/pallas_mlp.py`. The kernels and their references use an
odd minimax polynomial for erf, not the library erf, so the port does too;
the CUDA device function `erf_poly_fast` in `csrc/common.cuh` has the
same coefficients and Horner order.
"""

from __future__ import annotations

import math

import torch

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
