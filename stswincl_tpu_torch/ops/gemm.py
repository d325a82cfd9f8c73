"""The Hopper GEMMs of K1-K3, K5 and K6 (`csrc/gemm_sm90.cu`), called alone.

The kernels launch them from their C entries; the wrappers here launch
each form by itself so that its tests and its profile hold it against
`torch.matmul` at the kernels' shapes, with the row maps they use:
- `linear_sm90` (`stswin_gemm_sm90`): y = act(A @ Wt^T + bias), A rows
  gathered through the window partition and the SW-MSA cyclic shift (K1's
  qkv, K5's dattn), C rows scattered back to the image layout (K1's proj,
  K5's dx);
- `gelu_bwd_sm90` (`stswin_gelu_bwd_sm90`): K6's fused pair, pre = n2 @
  w1^T + b1 and dh = dm @ w2 in one tile, into dpre = dh * gelu'(pre), h =
  gelu(pre) and the column sums db1;
- `wgrad_sm90` (`stswin_wgrad_sm90`): the weight gradients A^T B of K5 and
  K6 over the token rows, each operand read through its row map.
On a CPU tensor each runs its plain twin (`*_ref`). `launch_counts`
reads the library's own count of every GEMM launch, those made inside the
kernels' C entries included.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from stswincl_tpu_torch import kernels
from stswincl_tpu_torch.ops.mlp import gelu

# (T, H, W, ws, shift): the window-order row map of `map_row`
# (`csrc/common.cuh`) over a (B, T, H, W) token grid
RowMap = Tuple[int, int, int, int, int]

_EPI = {"bf16": 0, "resid_f32": 1, "gelu_grad": 2, "dgelu": 3, "f32": 4}
# the slots of `stswin_gemm_sm90_launches`: gemm_sm90 by epilogue (the
# fused pair's is 5, row 17's implicit-GEMM conv 6, `ops.conv`), then the
# weight-gradient GEMM
FORMS = (*_EPI, "gelu_bwd", "conv", "wgrad")


def launch_counts(reset: bool = False) -> Dict[str, int]:
    """Launches of each GEMM form (`FORMS`) counted inside the kernel
    library since the last reset, where the kernel is launched: by the
    wrappers here and by the C entries of K1-K3, K5, K6 and row 17, which
    no wrapper here sees. `reset` sets the counts to 0 after reading."""
    out = (ctypes.c_longlong * len(FORMS))()
    kernels.load().stswin_gemm_sm90_launches(out, int(reset))
    return dict(zip(FORMS, out))


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
                    c_map=None, out=None, epi: str = "bf16", aux=None):
    """Plain twin: y[m] = a[a_rows(m)] @ wt^T + bias with fp32 sums, stored
    at row c_rows(m): "bf16" act(y) into a new (M, N) tensor; "resid_f32"
    y added into a copy of `out`, "f32" y written into it; "gelu_grad"
    (bf16 gelu(y), fp32 gelu'(y)); "dgelu" (bf16 y * aux, the fp32 column
    sums of y * aux), aux in C's row layout."""
    M, N = a.shape[0], wt.shape[0]
    rows_a = window_rows(M, a_map, a.device)
    y = a[rows_a].float() @ wt.float().t()
    if bias is not None:
        y = y + bias.float()
    rows_c = window_rows(M, c_map, a.device)
    if epi in ("bf16", "gelu_grad", "dgelu"):
        res = torch.empty((M, N), dtype=a.dtype, device=a.device)
        if epi == "dgelu":
            y = y * aux[rows_c].float()
            res[rows_c] = y.to(a.dtype)
            return res, y.sum(0)
        if epi == "gelu_grad":
            g, d = gelu_and_grad(y, act == "erf")
            res[rows_c] = g.to(a.dtype)
            grad = torch.empty((M, N), dtype=torch.float32, device=a.device)
            grad[rows_c] = d
            return res, grad
        if act != "none":
            y = gelu(y, act == "erf")
        res[rows_c] = y.to(a.dtype)
        return res
    res = out.clone()
    res[rows_c] = y + (res[rows_c] if epi == "resid_f32" else 0.0)
    return res


def linear_sm90(a, wt, bias=None, act: str = "none", a_map=None, c_map=None,
                out=None, epi: str = "bf16", aux=None):
    """The Hopper GEMM on a: (M, K) bf16 rows; wt: (N, K) bf16, the torch
    Linear layout; bias: (N,) fp32 or None; act 'none', 'erf' or 'tanh'
    (the GELU of "bf16" and "gelu_grad"); a_map / c_map: (T, H, W, ws,
    shift) row maps or None; out: the (M, N) fp32 tensor of the
    "resid_f32" and "f32" epilogues, updated in place and returned;
    "gelu_grad" returns (bf16 gelu, fp32 gelu') and "dgelu" (bf16 y *
    aux, fp32 column sums) with aux (M, N) fp32: the two halves of K6's
    gelu' through device memory (m recomputed). N, K multiples of 8."""
    if a.device.type == "cpu":
        return linear_sm90_ref(a, wt, bias, act, a_map, c_map, out, epi, aux)
    name = "linear_sm90"
    kernels.require_bf16_cuda(name, a, wt)
    kernels.require_on(a.device, name, a, wt, bias, out, aux)
    kernels.require(a.dim() == 2 and wt.dim() == 2
                    and a.shape[1] == wt.shape[1],
                    f"{name}: a {tuple(a.shape)}, wt {tuple(wt.shape)}")
    M, K = a.shape
    N = wt.shape[0]
    kernels.require(N % 8 == 0 and K % 8 == 0,
                    f"{name}: needs N and K multiples of 8 (N={N}, K={K})")
    kernels.require(epi in _EPI
                    and (act == "none" or epi in ("bf16", "gelu_grad"))
                    and (act != "none" or epi != "gelu_grad"),
                    f"{name}: epilogue {epi!r} with act {act!r}")
    if bias is not None:
        kernels.require_f32(name, bias)
        kernels.require(tuple(bias.shape) == (N,), f"{name}: bias shape")
    f32 = dict(dtype=torch.float32, device=a.device)
    c, cf, colsum = None, None, None
    if epi in ("bf16", "gelu_grad", "dgelu"):
        c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if epi == "gelu_grad":
        cf = torch.empty((M, N), **f32)
    elif epi == "dgelu":
        kernels.require_f32(name, aux)
        kernels.require(tuple(aux.shape) == (M, N), f"{name}: aux shape")
        colsum = torch.zeros(N, **f32)
    elif epi != "bf16":
        kernels.require_f32(name, out)
        kernels.require(tuple(out.shape) == (M, N), f"{name}: out shape")
        cf = out
    T, H, W, ws = _grid(name, M, a_map, c_map)
    P = kernels.ptr
    kernels.launch("stswin_gemm_sm90", a.device, P(a), P(wt), P(bias), P(c),
                   P(cf), P(aux), P(colsum), M, N, K, K, N, _EPI[epi],
                   {"none": 0, "erf": 1, "tanh": 2}[act],
                   int(a_map is not None), int(c_map is not None), T, H, W,
                   ws, 0 if a_map is None else a_map[4],
                   0 if c_map is None else c_map[4])
    linear_sm90.launches += 1
    if epi == "gelu_grad":
        return c, cf
    if epi == "dgelu":
        return c, colsum
    return c if epi == "bf16" else cf


linear_sm90.launches = 0


def _grid(name, M, a_map, b_map):
    """(T, H, W, ws) shared by the two row maps over M rows."""
    geo = a_map or b_map or (1, 1, 1, 1, 0)
    kernels.require(b_map is None or a_map is None or
                    tuple(a_map[:4]) == tuple(b_map[:4]),
                    f"{name}: the two row maps must share their grid")
    T, H, W, ws, _ = geo
    kernels.require(ws > 0 and H % ws == 0 and W % ws == 0
                    and M % (T * H * W) == 0,
                    f"{name}: {M} rows over the grid {geo}")
    return T, H, W, ws


def gelu_and_grad(pre: torch.Tensor, exact: bool = True):
    """(gelu(pre), d gelu / d pre) of `ops.mlp.gelu` (the erf polynomial
    and its own derivative, or the tanh form), elementwise, fp32."""
    with torch.enable_grad():
        x = pre.detach().float().requires_grad_()
        y = gelu(x, exact)
        (d,) = torch.autograd.grad(y.sum(), x)
    return y.detach(), d


def gelu_bwd_sm90_ref(n2, dm, w1, w2_t, b1, act: str = "erf",
                      with_h: bool = True):
    """Plain twin of K6's fused pair: pre = n2 @ w1^T + b1, dh = dm @
    w2_t^T with fp32 sums; returns (dpre = bf16(dh * gelu'(pre)), h =
    bf16(gelu(pre)) or None, db1 = the fp32 column sums of dh *
    gelu'(pre))."""
    pre = n2.float() @ w1.float().t() + b1.float()
    g, d = gelu_and_grad(pre, act == "erf")
    dpre = (dm.float() @ w2_t.float().t()) * d
    return (dpre.to(n2.dtype), g.to(n2.dtype) if with_h else None,
            dpre.sum(0))


def gelu_bwd_sm90(n2, dm, w1, w2_t, b1, act: str = "erf",
                  with_h: bool = True):
    """K6's fused pair on the Hopper GEMM: n2, dm (M, K) bf16; w1, w2_t
    (N, K) bf16; b1 (N,) fp32; act 'erf' or 'tanh'. Returns (dpre (M, N)
    bf16, h (M, N) bf16 or None, db1 (N,) fp32). N, K multiples of 8."""
    if n2.device.type == "cpu":
        return gelu_bwd_sm90_ref(n2, dm, w1, w2_t, b1, act, with_h)
    name = "gelu_bwd_sm90"
    kernels.require_bf16_cuda(name, n2, dm, w1, w2_t)
    kernels.require_on(n2.device, name, n2, dm, w1, w2_t, b1)
    kernels.require_f32(name, b1)
    M, K = n2.shape
    N = w1.shape[0]
    kernels.require(dm.shape == n2.shape and w1.shape == w2_t.shape
                    and w1.shape[1] == K and tuple(b1.shape) == (N,)
                    and N % 8 == 0 and K % 8 == 0 and act in ("erf", "tanh"),
                    f"{name}: n2 {tuple(n2.shape)}, dm {tuple(dm.shape)}, w1 "
                    f"{tuple(w1.shape)}, w2_t {tuple(w2_t.shape)}, act {act}")
    dpre = torch.empty((M, N), dtype=n2.dtype, device=n2.device)
    h = torch.empty_like(dpre) if with_h else None
    db1 = torch.zeros(N, dtype=torch.float32, device=n2.device)
    P = kernels.ptr
    kernels.launch("stswin_gelu_bwd_sm90", n2.device, P(n2), P(dm), P(w1),
                   P(w2_t), P(b1), P(dpre), P(h), P(db1), M, N, K,
                   {"erf": 1, "tanh": 2}[act])
    gelu_bwd_sm90.launches += 1
    return dpre, h, db1


gelu_bwd_sm90.launches = 0


def wgrad_sm90_ref(a, b, a_map=None, b_map=None):
    """Plain twin of the weight-gradient GEMM: a[a_rows(r)]^T @
    b[b_rows(r)] in fp32 over the R rows (`window_rows`)."""
    R = a.shape[0]
    return (a[window_rows(R, a_map, a.device)].float().t()
            @ b[window_rows(R, b_map, b.device)].float())


def wgrad_sm90(a, b, a_map=None, b_map=None):
    """The weight-gradient GEMM on a: (R, M), b: (R, N) bf16 rows, each
    read through its (T, H, W, ws, shift) row map or None; returns the
    (M, N) fp32 sum over r of a[a_rows(r)]^T b[b_rows(r)]. M and N
    multiples of 128; R is ragged."""
    if a.device.type == "cpu":
        return wgrad_sm90_ref(a, b, a_map, b_map)
    name = "wgrad_sm90"
    kernels.require_bf16_cuda(name, a, b)
    kernels.require_on(a.device, name, a, b)
    kernels.require(a.dim() == 2 and b.dim() == 2
                    and a.shape[0] == b.shape[0],
                    f"{name}: a {tuple(a.shape)}, b {tuple(b.shape)}")
    R, M = a.shape
    N = b.shape[1]
    kernels.require(M % 128 == 0 and N % 128 == 0,
                    f"{name}: needs M and N multiples of 128 (M={M}, N={N})")
    T, H, W, ws = _grid(name, R, a_map, b_map)
    out = torch.zeros((M, N), dtype=torch.float32, device=a.device)
    P = kernels.ptr
    kernels.launch("stswin_wgrad_sm90", a.device, P(a), P(b), P(out), R, M,
                   N, M, N, int(a_map is not None), int(b_map is not None), T,
                   H, W, ws, 0 if a_map is None else a_map[4],
                   0 if b_map is None else b_map[4])
    wgrad_sm90.launches += 1
    return out


wgrad_sm90.launches = 0
