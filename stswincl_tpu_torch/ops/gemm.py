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
  gelu(pre) and the column sums db1 (a partial row a 128-row tile, added
  in order);
- `wgrad_sm90` (`stswin_wgrad_sm90`): the weight gradients A^T B of K5 and
  K6 over the token rows, each operand read through its row map, the
  row splits' partials in a workspace added in a fixed order (no float
  atomics: the same bits every call);
- `linear_f32` (`stswin_gemm_f32`, `csrc/fp32_forms.cu`): the fp32 GEMM of
  the fp32 forms of K1-K3, K5 and K6, y = act(A @ Wt^T + bias) in fp32
  accuracy on the tensor cores (3xTF32 on wgmma, `csrc/fp32_gemm.cuh`),
  with `linear_sm90`'s row maps, stored or added into C, and K6's two
  epilogues: fc1 writing h and gelu', dh times gelu' with the column sums
  db1 (each 128-row tile's partial taken in the epilogue, the partials
  summed in order);
- `wgrad_f32` (`stswin_wgrad_f32`, `csrc/fp32_train.cu`): the fp32
  weight-gradient GEMM of K5's and K6's fp32 forms, `wgrad_sm90`'s
  contract in fp32 accuracy on the tensor cores (the fp32 GEMM's 3xTF32
  wgmma k tile with K = the rows, `csrc/fp32_gemm.cuh`), the rows split
  in `wgrad_splits` ranges and the splits' partials added in a fixed
  order (no atomics: the same bits every call); K5 and K6 run their two
  weight gradients in one launch of it.
On a CPU tensor each runs its plain twin (`*_ref`; `linear_f32`'s is
`linear_sm90_ref` on fp32 operands, `wgrad_f32`'s `wgrad_sm90_ref`).
`launch_counts` reads the library's own count of every GEMM launch, those
made inside the kernels' C entries included.
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
SM90_FORMS = (*_EPI, "gelu_bwd", "conv", "wgrad")
# and the fp32 GEMM's, the fp32 weight-gradient GEMM's and row 17's fp32
# implicit GEMM's launches (`stswin_gemm_f32_launches`)
F32_FORMS = ("fp32", "wgrad_f32", "conv_f32")
FORMS = (*SM90_FORMS, *F32_FORMS)


def launch_counts(reset: bool = False) -> Dict[str, int]:
    """Launches of each GEMM form (`FORMS`) counted inside the kernel
    library since the last reset, where the kernel is launched: by the
    wrappers here and by the C entries of K1-K3 (both forms), K5, K6 and
    rows 12, 13 and 17 (both forms), which no wrapper here sees. `reset` sets the counts to 0 after
    reading."""
    lib = kernels.load()
    out = (ctypes.c_longlong * len(SM90_FORMS))()
    lib.stswin_gemm_sm90_launches(out, int(reset))
    f32 = (ctypes.c_longlong * len(F32_FORMS))()
    lib.stswin_gemm_f32_launches(f32, int(reset))
    return {**dict(zip(SM90_FORMS, out)), **dict(zip(F32_FORMS, f32))}


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
    kernels.require_bf16(name, "the bf16 Hopper GEMM; fp32: linear_f32", a,
                         wt)
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
    c, cf, colsum, colpart = None, None, None, None
    if epi in ("bf16", "gelu_grad", "dgelu"):
        c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if epi == "gelu_grad":
        cf = torch.empty((M, N), **f32)
    elif epi == "dgelu":
        kernels.require_f32(name, aux)
        kernels.require(tuple(aux.shape) == (M, N), f"{name}: aux shape")
        colsum = torch.empty(N, **f32)
        colpart = torch.empty(((M + 127) // 128, N), **f32)
    elif epi != "bf16":
        kernels.require_f32(name, out)
        kernels.require(tuple(out.shape) == (M, N), f"{name}: out shape")
        cf = out
    T, H, W, ws = _grid(name, M, a_map, c_map)
    P = kernels.ptr
    kernels.launch("stswin_gemm_sm90", a.device, P(a), P(wt), P(bias), P(c),
                   P(cf), P(aux), P(colsum), P(colpart), M, N, K, K, N,
                   _EPI[epi],
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


def linear_f32(a, wt, bias=None, act: str = "none", a_map=None, c_map=None,
               out=None, epi: Optional[str] = None, aux=None):
    """The fp32 GEMM on a: (M, K) fp32 rows; wt: (N, K) fp32, the torch
    Linear layout; bias: (N,) fp32 or None; act 'none', 'erf' or 'tanh';
    a_map / c_map: (T, H, W, ws, shift) row maps or None. Returns a new (M,
    N) fp32 act(y) at rows c_map(m), or with `out` ((M, N) fp32, act
    'none') adds y into it in place and returns it. K6's epilogues: `epi`
    "gelu_grad" (act 'erf' or 'tanh') returns (gelu(y), gelu'(y)), "dgelu"
    (act 'none', aux (M, N) fp32 in C's row layout) returns (y * aux, its
    fp32 column sums in a fixed order). K and the row strides multiples
    of 4; every sum fp32-accurate (three TF32 products a 32-deep k tile,
    added to fp32 sums), k tiles in order."""
    if a.device.type == "cpu":
        return linear_sm90_ref(a, wt, bias, act, a_map, c_map, out,
                               epi or ("bf16" if out is None
                                       else "resid_f32"), aux)
    name = "linear_f32"
    kernels.require_f32(name, a, wt)
    kernels.require_on(a.device, name, a, wt, bias, out, aux)
    kernels.require(a.dim() == 2 and wt.dim() == 2
                    and a.shape[1] == wt.shape[1] and a.shape[1] % 4 == 0,
                    f"{name}: a {tuple(a.shape)}, wt {tuple(wt.shape)}, K a "
                    "multiple of 4")
    M, K = a.shape
    N = wt.shape[0]
    kernels.require(epi in (None, "gelu_grad", "dgelu")
                    and act in ("none", "erf", "tanh")
                    and (out is None or (act == "none" and epi is None))
                    and (epi != "gelu_grad" or act != "none")
                    and (epi != "dgelu" or act == "none"),
                    f"{name}: act {act!r}, epi {epi!r} with out "
                    f"{out is not None}")
    if bias is not None:
        kernels.require_f32(name, bias)
        kernels.require(tuple(bias.shape) == (N,), f"{name}: bias shape")
    f32 = dict(dtype=torch.float32, device=a.device)
    c2 = None
    if out is None:
        c = torch.empty((M, N), **f32)
    else:
        kernels.require_f32(name, out)
        kernels.require(tuple(out.shape) == (M, N), f"{name}: out shape")
        c = out
    colsum = work = None
    if epi == "gelu_grad":
        c2 = torch.empty((M, N), **f32)
    elif epi == "dgelu":
        kernels.require_f32(name, aux)
        kernels.require(tuple(aux.shape) == (M, N) and M > 0,
                        f"{name}: aux shape")
        colsum = torch.empty(N, **f32)
        work = torch.empty(kernels.query("stswin_gemm_f32_colsum_work", M,
                                         N), **f32)
    code = ({None: 1 if out is not None else 0, "gelu_grad": 2, "dgelu": 3}
            [epi])
    T, H, W, ws = _grid(name, M, a_map, c_map)
    P = kernels.ptr
    kernels.launch("stswin_gemm_f32", a.device, P(a), P(wt), P(bias), P(c),
                   P(c2), P(aux), P(colsum), P(work), M, N, K, K, N,
                   {"none": 0, "erf": 1, "tanh": 2}[act], code,
                   int(a_map is not None), int(c_map is not None), T, H, W,
                   ws, 0 if a_map is None else a_map[4],
                   0 if c_map is None else c_map[4])
    linear_f32.launches += 1
    if epi == "gelu_grad":
        return c, c2
    if epi == "dgelu":
        return c, colsum
    return c


linear_f32.launches = 0


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
    kernels.require_bf16(name, "K6's fused pair, Pallas rows 7 and 9", n2,
                         dm, w1, w2_t)
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
    db1 = torch.empty(N, dtype=torch.float32, device=n2.device)
    colpart = torch.empty(((M + 127) // 128, N), dtype=torch.float32,
                          device=n2.device)
    P = kernels.ptr
    kernels.launch("stswin_gelu_bwd_sm90", n2.device, P(n2), P(dm), P(w1),
                   P(w2_t), P(b1), P(dpre), P(h), P(db1), P(colpart), M, N,
                   K, {"erf": 1, "tanh": 2}[act])
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
    multiples of 8; R, and the last 128 x 128 output tile, ragged."""
    if a.device.type == "cpu":
        return wgrad_sm90_ref(a, b, a_map, b_map)
    name = "wgrad_sm90"
    kernels.require_bf16(name, "the weight gradients of Pallas rows 6, 7 "
                         "and 9", a, b)
    kernels.require_on(a.device, name, a, b)
    kernels.require(a.dim() == 2 and b.dim() == 2
                    and a.shape[0] == b.shape[0],
                    f"{name}: a {tuple(a.shape)}, b {tuple(b.shape)}")
    R, M = a.shape
    N = b.shape[1]
    kernels.require(M % 8 == 0 and N % 8 == 0,
                    f"{name}: needs M and N multiples of 8 (M={M}, N={N})")
    T, H, W, ws = _grid(name, R, a_map, b_map)
    f32 = dict(dtype=torch.float32, device=a.device)
    out = torch.empty((M, N), **f32)
    work = torch.empty(kernels.query("stswin_wgrad_sm90_work", R, M, N),
                       **f32)
    P = kernels.ptr
    kernels.launch("stswin_wgrad_sm90", a.device, P(a), P(b), P(out),
                   P(work if work.numel() else None), R, M, N, M, N,
                   int(a_map is not None), int(b_map is not None), T,
                   H, W, ws, 0 if a_map is None else a_map[4],
                   0 if b_map is None else b_map[4])
    wgrad_sm90.launches += 1
    return out


wgrad_sm90.launches = 0


# `wgrad_f32`'s split of the rows (`csrc/fp32_train.cu`): the blocks the
# H100 holds at once (one an SM), the fewest rows a split, the most splits
WGRAD_WAVE, WGRAD_SPLIT_ROWS, WGRAD_SPLIT_MAX = 132, 2048, 32


def wgrad_splits(R: int, tiles: int) -> Tuple[int, int]:
    """(splits, rows a split) of `wgrad_f32`'s R rows for a launch of
    `tiles` 128 x 128 output tiles (the sum over its weight gradients): of
    1 .. min(32, R // 2048) splits the count whose blocks (tiles x splits,
    one an SM) fill their waves of 132 best, the fewest on a tie; each
    split `chunk` rows, a multiple of the 32-row k tile, the last ragged.
    The host's rule (`wgrad_splits` in the C source), repeated here for the
    tests that emulate the kernel's order of sums."""
    most = min(max(R // WGRAD_SPLIT_ROWS, 1), WGRAD_SPLIT_MAX)
    best, fill = 1, 0.0
    for s in range(1, most + 1):
        blocks = tiles * s
        f = blocks / (-(-blocks // WGRAD_WAVE) * WGRAD_WAVE)
        if f > fill + 1e-9:
            best, fill = s, f
    return best, -(-(-(-R // best)) // 32) * 32


def f32_colsum(x: torch.Tensor) -> torch.Tensor:
    """The fp32 column sums of x (M, N) in the order of the fp32 GEMM's
    "dgelu" epilogue (`csrc/fp32_forms.cu` `col_sum8`): in each 128-row
    tile (rows past M 0), each 16-row block of a consumer warp summed as
    a tree (rows g and g ^ 4, then along g's bit 1, bit 0, then rows g and
    g + 8), the tile's 8 blocks added in order, then the tiles' partials
    in order (`sum_parts`). K6's db1 in these bits."""
    M, N = x.shape
    t = -(-M // 128)
    v = torch.nn.functional.pad(x.float(), (0, 0, 0, t * 128 - M))
    v = v.reshape(t, 8, 2, 2, 2, 2, N)  # [tile, warp, h, g bit 2, 1, 0]
    v = v[:, :, :, 0] + v[:, :, :, 1]
    v = v[:, :, :, 0] + v[:, :, :, 1]
    v = v[:, :, :, 0] + v[:, :, :, 1]
    v = v[:, :, 0] + v[:, :, 1]  # (t, 8, N): each warp's 16 rows
    part = v[:, 0]
    for w in range(1, 8):
        part = part + v[:, w]
    out = part[0]
    for i in range(1, t):
        out = out + part[i]
    return out


def wgrad_f32(a, b, a_map=None, b_map=None):
    """The fp32 weight-gradient GEMM on a: (R, M), b: (R, N) fp32 rows,
    each read through its (T, H, W, ws, shift) row map or None; returns
    the (M, N) fp32 sum over r of a[a_rows(r)]^T b[b_rows(r)], 3xTF32 on
    wgmma with r ascending within each split of the rows (`wgrad_splits`;
    a 32-row k tile's three products from zero, added to fp32 sums) and
    the splits added in order. M and N multiples of 4; R is ragged."""
    if a.device.type == "cpu":
        return wgrad_sm90_ref(a, b, a_map, b_map)
    name = "wgrad_f32"
    kernels.require_f32(name, a, b)
    kernels.require_on(a.device, name, a, b)
    kernels.require(a.dim() == 2 and b.dim() == 2
                    and a.shape[0] == b.shape[0],
                    f"{name}: a {tuple(a.shape)}, b {tuple(b.shape)}")
    R, M = a.shape
    N = b.shape[1]
    kernels.require(M % 4 == 0 and N % 4 == 0,
                    f"{name}: needs M and N multiples of 4 (M={M}, N={N})")
    T, H, W, ws = _grid(name, R, a_map, b_map)
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    work = torch.empty(max(1, kernels.query("stswin_wgrad_f32_work", R, M,
                                            N)),
                       dtype=torch.float32, device=a.device)
    P = kernels.ptr
    kernels.launch("stswin_wgrad_f32", a.device, P(a), P(b), P(out),
                   P(work), R, M, N, M, N, int(a_map is not None),
                   int(b_map is not None), T, H, W, ws,
                   0 if a_map is None else a_map[4],
                   0 if b_map is None else b_map[4])
    wgrad_f32.launches += 1
    return out


wgrad_f32.launches = 0
