"""The Hopper GEMM of K1 and K2 (`csrc/gemm_sm90.cu`), called alone.

K1 and K2 launch it from their C entries; `linear_sm90` launches it by
itself (`stswin_gemm_sm90`) so that its tests and its profile hold it
against `torch.matmul` at the shapes of K1 and K2, with the row maps they
use: A rows gathered through the window partition and the SW-MSA cyclic
shift (K1's qkv product), C rows scattered back to the image layout (K1's
proj product). On a CPU tensor it runs its plain twin `linear_sm90_ref`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from stswincl_tpu_torch import kernels
from stswincl_tpu_torch.ops.mlp import gelu

# (T, H, W, ws, shift): the window-order row map of `map_row`
# (`csrc/common.cuh`) over a (B, T, H, W) token grid
RowMap = Tuple[int, int, int, int, int]

_EPI = {"bf16": 0, "resid_f32": 1, "f32": 4}


def window_rows(M: int, row_map: Optional[RowMap],
                device=None) -> torch.Tensor:
    """Row m of a window-ordered token matrix -> its row of the (B, T, H,
    W) image, read through the cyclic shift (`map_row`); the identity when
    `row_map` is None."""
    r = torch.arange(M, device=device)
    if row_map is None:
        return r
    T, H, W, ws, shift = row_map
    N = ws * ws
    TN, nWw = T * N, W // ws
    nWin = (H // ws) * nWw
    bw, p = r // TN, r % TN
    t, q = p // N, p % N
    i, j = q // ws, q % ws
    b, win = bw // nWin, bw % nWin
    h = ((win // nWw) * ws + i + shift) % H
    w = ((win % nWw) * ws + j + shift) % W
    return ((b * T + t) * H + h) * W + w


def linear_sm90_ref(a, wt, bias=None, act: str = "none", a_map=None,
                    c_map=None, out=None, epi: str = "bf16"):
    """Plain twin: y[m] = act(a[a_rows(m)] @ wt^T + bias) with fp32 sums,
    stored at row c_rows(m): bf16 into a new (M, N) tensor ("bf16"), or
    fp32 added into `out` ("resid_f32") or written into it ("f32")."""
    M = a.shape[0]
    rows_a = window_rows(M, a_map, a.device)
    y = a[rows_a].float() @ wt.float().t()
    if bias is not None:
        y = y + bias.float()
    if act != "none":
        y = gelu(y, act == "erf")
    rows_c = window_rows(M, c_map, a.device)
    if epi == "bf16":
        res = torch.empty((M, wt.shape[0]), dtype=a.dtype, device=a.device)
        res[rows_c] = y.to(a.dtype)
        return res
    res = out.clone()
    res[rows_c] = y + (res[rows_c] if epi == "resid_f32" else 0.0)
    return res


def linear_sm90(a, wt, bias=None, act: str = "none", a_map=None, c_map=None,
                out=None, epi: str = "bf16"):
    """The Hopper GEMM on a: (M, K) bf16 rows; wt: (N, K) bf16, the torch
    Linear layout; bias: (N,) fp32 or None; act 'none', 'erf' or 'tanh'
    (GELU, bf16 epilogue only); a_map / c_map: (T, H, W, ws, shift) row
    maps (the C map without shift) or None; out: the (M, N) fp32 tensor of
    the "resid_f32" and "f32" epilogues, updated in place and returned.
    N, K multiples of 8."""
    if a.device.type == "cpu":
        return linear_sm90_ref(a, wt, bias, act, a_map, c_map, out, epi)
    name = "linear_sm90"
    kernels.require_bf16_cuda(name, a, wt)
    kernels.require_on(a.device, name, a, wt, bias, out)
    kernels.require(a.dim() == 2 and wt.dim() == 2
                    and a.shape[1] == wt.shape[1],
                    f"{name}: a {tuple(a.shape)}, wt {tuple(wt.shape)}")
    M, K = a.shape
    N = wt.shape[0]
    kernels.require(N % 8 == 0 and K % 8 == 0,
                    f"{name}: needs N and K multiples of 8 (N={N}, K={K})")
    kernels.require(epi in _EPI and (act == "none" or epi == "bf16"),
                    f"{name}: epilogue {epi!r} with act {act!r}")
    if bias is not None:
        kernels.require_f32(name, bias)
        kernels.require(tuple(bias.shape) == (N,), f"{name}: bias shape")
    if epi == "bf16":
        c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    else:
        kernels.require_f32(name, out)
        kernels.require(tuple(out.shape) == (M, N), f"{name}: out shape")
        c = out
    geo = a_map or c_map or (1, 1, 1, 1, 0)
    kernels.require(c_map is None or a_map is None or
                    tuple(a_map[:4]) == tuple(c_map[:4]),
                    f"{name}: the two row maps must share their grid")
    T, H, W, ws, _ = geo
    kernels.require(ws > 0 and H % ws == 0 and W % ws == 0
                    and M % (T * H * W) == 0,
                    f"{name}: {M} rows over the grid {geo}")
    P = kernels.ptr
    kernels.launch("stswin_gemm_sm90", a.device, P(a), P(wt), P(bias),
                   P(c) if epi == "bf16" else None,
                   None if epi == "bf16" else P(c), M, N, K, K, N, _EPI[epi],
                   {"none": 0, "erf": 1, "tanh": 2}[act],
                   int(a_map is not None), int(c_map is not None), T, H, W,
                   ws, 0 if a_map is None else a_map[4])
    linear_sm90.launches += 1
    return c


linear_sm90.launches = 0
