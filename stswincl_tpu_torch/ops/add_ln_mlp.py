"""K2 and K6: the swin block's post-attention tail,
LN1(s + MLP(LN2(s))) with s = x + y in fp32 (the reference's nonstandard
norm order), and its backward; and Pallas row 13, the same tail without
LN1: (s, MLP(LN(s))).

Counterparts in `stswincl_tpu/ops/pallas_add_ln_mlp.py`:
`fused_swin_block_epilogue` and `fused_swin_block_epilogue_shifted` (K2),
`_fused_epilogue_fwd_with_m` (K2 with the `m` output), and
`fused_epilogue_bwd` / `fused_epilogue_bwd_streamed` (K6), routed as
`_epi_fwd` / `_epi_bwd` and `_epis_fwd` / `_epis_bwd` route them.

`swin_block_epilogue` launches K2 (`csrc/epilogue.cu`) on a CUDA tensor and
runs the plain twin `swin_block_epilogue_ref` on a CPU tensor. When
autograd needs a gradient it goes through `EpilogueFn`: its backward
launches K6 on CUDA (`swin_block_epilogue_bwd`) and runs
`swin_block_epilogue_bwd_ref` on the CPU. With `shift` > 0, y is in the
SW-MSA shifted layout that `swin_block_attention(shift=...)` leaves, is
read back through the inverse cyclic shift, and its gradient returns in
that layout.

Two roundings of the MLP output m live here, as in the JAX package:
the serving forward adds the fp32 m to s unrounded (`:743`), while the
training backward (and the JAX reference `:877-891`) rounds m to x's
dtype first (`:216`, `:788-793`). `mlp_output_saved` picks, from the
shape, whether the training forward saves that rounded m (stage 2) or the
backward recomputes it (stage 1); `m_out=True` takes the first form at
every shape (row 16's rounding on the pair's kernels, see
`ops/swin_block.whole_swin_block_pair`).

`add_ln_mlp` (row 13, `fused_add_ln_mlp`, `pallas_add_ln_mlp.py:97`)
launches `stswin_add_ln_mlp` (`csrc/epilogue.cu`: K2's LN pass, then row
12's two products on the Hopper GEMM) on a CUDA tensor and runs the twin
`add_ln_mlp_ref` on a CPU tensor; its backward is autograd of the twin,
as JAX's `_bwd` (`:145-153`) is a VJP of `add_ln_mlp_ref`.

Weights use the torch Linear layout: w1 (4C, C), w2 (C, 4C), in any float
dtype (cast to x's dtype for the products; gradients in their own dtype).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from stswincl_tpu_torch import kernels
from stswincl_tpu_torch.ops.mlp import check_mlp_widths, gelu


def layer_norm_f32(s32: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Two-pass fp32 LayerNorm over the last axis (`_ln_math`)."""
    mu = s32.mean(dim=-1, keepdim=True)
    xc = s32 - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return (xc * torch.rsqrt(var + eps)) * scale.float() + bias.float()


def _mlp_f32(x, y, s2, b2, w1, b1, w2, bw2, gelu_exact, shift, eps):
    """s32 = x + unshift(y) and the fp32 MLP output of LN2(s32)."""
    if shift:
        y = torch.roll(y, (shift, shift), dims=(2, 3))
    s32 = x.float() + y.float()
    n2 = layer_norm_f32(s32, s2, b2, eps).to(x.dtype)
    h = gelu(F.linear(n2.float(), w1.float(), b1.float()), gelu_exact)
    return s32, F.linear(h.to(x.dtype).float(), w2.float(), bw2.float())


def swin_block_epilogue_ref(x, y, s2, b2, w1, b1, w2, bw2, s1, b1n,
                            gelu_exact: bool = True, shift: int = 0,
                            ws: Optional[int] = None, eps: float = 1e-5):
    """Plain twin of K2 as served (port of `swin_block_epilogue_ref` and
    its `_shifted_ref`; same signature as `swin_block_epilogue`, `ws`
    unused). The MLP output is added to s in fp32, unrounded, as the
    serving kernels do (`pallas_add_ln_mlp.py:743`)."""
    s32, m = _mlp_f32(x, y, s2, b2, w1, b1, w2, bw2, gelu_exact, shift, eps)
    return layer_norm_f32(s32 + m, s1, b1n, eps).to(x.dtype)


def swin_block_epilogue_with_m_ref(x, y, s2, b2, w1, b1, w2, bw2, s1, b1n,
                                   gelu_exact: bool = True, shift: int = 0,
                                   ws: Optional[int] = None,
                                   eps: float = 1e-5):
    """Plain twin of K2 with the `m` output (`_fused_epilogue_fwd_with_m`):
    m is rounded to x's dtype and the output normalises s + that m.
    Returns (out, m)."""
    s32, m = _mlp_f32(x, y, s2, b2, w1, b1, w2, bw2, gelu_exact, shift, eps)
    m = m.to(x.dtype)
    return layer_norm_f32(s32 + m.float(), s1, b1n, eps).to(x.dtype), m


def swin_block_epilogue_bwd_ref(x, y, s2, b2, w1, b1, w2, bw2, s1, b1n, g,
                                gelu_exact: bool = True, shift: int = 0,
                                ws: Optional[int] = None, eps: float = 1e-5):
    """Plain twin of K6: autograd of `swin_block_epilogue_with_m_ref`,
    the m-rounding both training backwards use (`:216`). Returns
    (dx, dy, ds2, db2, dw1, db1, dw2, dbw2, ds1, db1n), each in its
    input's dtype; dy in y's (shifted) layout."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_()
                  for t in (x, y, s2, b2, w1, b1, w2, bw2, s1, b1n)]
        out, _ = swin_block_epilogue_with_m_ref(*leaves, gelu_exact, shift,
                                                ws, eps)
        return torch.autograd.grad(out, leaves, g)


def mlp_output_saved(C: int, hidden: int, dtype: torch.dtype) -> bool:
    """Whether the training forward saves the rounded MLP output m for the
    backward (True) or the backward recomputes fc2 (False).

    The JAX routing, kept so both packages compute the same numbers:
    `_epilogue_bwd_applicable` (`pallas_add_ln_mlp.py:400`) sends shapes
    whose weights plus fp32 weight-gradient accumulators,
    C * hidden * (2 * itemsize + 8) bytes, fit 20 MiB to the recomputing
    backward (stage 1, C 512); `_epilogue_bwd_streamed_applicable`
    (`:682`) sends larger ones to the backward that takes m (stage 2,
    C 1024)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return C * hidden * (2 * itemsize + 8) > 20 * 1024 * 1024


def _geometry(name, x, y, w1, shift, ws):
    """(BT, H, W, C, hidden) of the kernels' row view of x."""
    C, hidden = x.shape[-1], w1.shape[0]
    kernels.require(y.shape == x.shape, f"{name}: y {tuple(y.shape)} vs x "
                    f"{tuple(x.shape)}")
    kernels.require(C % 128 == 0 and hidden % 128 == 0,
                    f"{name}: needs C and hidden multiples of 128 "
                    f"(C={C}, hidden={hidden})")
    if shift:
        kernels.require(x.dim() == 5 and ws is not None and 0 < shift < ws,
                        f"{name}: the shifted epilogue takes (B, T, H, W, C)"
                        " and 0 < shift < ws")
        B, T, H, W, _ = x.shape
        return B * T, H, W, C, hidden
    return 1, 1, x.numel() // C, C, hidden


def _check_params(name, x, w1, b1, w2, vectors, C, hidden):
    """x bf16 on CUDA; w1 (hidden, C), w2 (C, hidden) in x's dtype; b1
    (hidden,) and the C-sized `vectors` fp32."""
    kernels.require(x.is_cuda, f"{name}: no kernel for device {x.device}")
    kernels.require_bf16_cuda(name, x)
    kernels.require(w1.dtype == x.dtype and w2.dtype == x.dtype,
                    f"{name}: weights must be cast to {x.dtype}")
    kernels.require_f32(name, b1, *vectors)
    kernels.require_on(x.device, name, x, w1, b1, w2, *vectors)
    kernels.require(tuple(w1.shape) == (hidden, C)
                    and tuple(w2.shape) == (C, hidden)
                    and all(tuple(v.shape) == (C,) for v in vectors)
                    and tuple(b1.shape) == (hidden,),
                    f"{name}: parameter shapes do not match C={C}")


def _forward_kernel(x, y, s2, b2, w1, b1, w2, bw2, s1, b1n, gelu_exact,
                    shift, ws, eps, with_m):
    """Launch K2; return (out, m), m the rounded MLP output when `with_m`
    (else None). Weights already in x's dtype."""
    name = "swin_block_epilogue"
    BT, H, W, C, hidden = _geometry(name, x, y, w1, shift, ws)
    _check_params(name, x, w1, b1, w2, (s2, b2, bw2, s1, b1n), C, hidden)
    kernels.require_on(x.device, name, y)
    rows = BT * H * W
    dev = x.device
    s32 = torch.empty((rows, C), dtype=torch.float32, device=dev)
    n2 = torch.empty((rows, C), dtype=x.dtype, device=dev)
    hid = torch.empty((rows, hidden), dtype=x.dtype, device=dev)
    out = torch.empty_like(x)
    m = torch.empty_like(x) if with_m else None
    P = kernels.ptr
    kernels.launch("stswin_block_epilogue", dev, P(x), P(y), P(s2), P(b2),
                   P(w1), P(b1), P(w2), P(bw2), P(s1), P(b1n), P(s32),
                   P(n2), P(hid), P(out), P(m), BT, H, W, C, hidden, shift,
                   1 if gelu_exact else 2, float(eps))
    swin_block_epilogue.launches += 1
    return out, m


def swin_block_epilogue(x, y, s2, b2, w1, b1, w2, bw2, s1, b1n,
                        gelu_exact: bool = True, shift: int = 0,
                        ws: Optional[int] = None, eps: float = 1e-5,
                        m_out: Optional[bool] = None):
    """x, y: (..., C), or (B, T, H, W, C) when `shift` > 0 (then y is
    shifted and 0 < shift < ws). LayerNorm scale/bias and the MLP biases
    are fp32; returns x's shape and dtype. `m_out`: None routes as the JAX
    package does (serving adds the fp32 m; training rounds m where
    `mlp_output_saved`); True rounds m before the residual add at every
    shape, and a training forward saves it for K6."""
    args = (x, y, s2, b2, w1, b1, w2, bw2, s1, b1n, gelu_exact, shift, ws,
            eps)
    if kernels.needs_grad(x, y, s2, b2, w1, b1, w2, bw2, s1, b1n):
        return EpilogueFn.apply(*args, m_out)
    w1, w2 = w1.to(x.dtype), w2.to(x.dtype)
    args = (x, y, s2, b2, w1, b1, w2) + args[7:]
    if x.device.type == "cpu":
        if m_out:
            return swin_block_epilogue_with_m_ref(*args)[0]
        return swin_block_epilogue_ref(*args)
    return _forward_kernel(*args, with_m=bool(m_out))[0]


swin_block_epilogue.launches = 0


def swin_block_epilogue_bwd(x, y, g, m, s2, b2, w1, b1, w2, bw2, s1,
                            gelu_exact: bool = True, shift: int = 0,
                            ws: Optional[int] = None, eps: float = 1e-5):
    """K6: the gradients of the epilogue's output given its gradient g;
    `m` is the forward's rounded MLP output, or None to recompute it.
    Returns (dx, dy, ds2, db2, dw1, db1, dw2, dbw2, ds1, db1n): dx and dy
    in x's dtype (dy in y's shifted layout; the same tensor as dx when
    shift is 0), the rest fp32."""
    name = "swin_block_epilogue_bwd"
    BT, H, W, C, hidden = _geometry(name, x, y, w1, shift, ws)
    _check_params(name, x, w1, b1, w2, (s2, b2, bw2, s1), C, hidden)
    kernels.require(C in (128, 256, 512, 1024),
                    f"{name}: C must be 128, 256, 512 or 1024, got {C}")
    kernels.require(g.shape == x.shape and g.dtype == x.dtype
                    and (m is None or (m.shape == x.shape
                                       and m.dtype == x.dtype)),
                    f"{name}: g / m do not match x")
    kernels.require_on(x.device, name, y, g, m)
    rows = BT * H * W
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    bf = dict(dtype=x.dtype, device=dev)
    s32, do32, dn2 = (torch.empty((rows, C), **f32) for _ in range(3))
    n2, dm = (torch.empty((rows, C), **bf) for _ in range(2))
    m_scratch = torch.empty((rows, C), **bf) if m is None else None
    h, dpre = (torch.empty((rows, hidden), **bf) for _ in range(2))
    # m recomputed (row 7): fc1 runs once, ahead of m, and gelu' goes
    # through device memory in fp32 (measured faster than the fused pair,
    # which would run fc1 again); m saved (row 9): the fused pair keeps
    # gelu' in registers
    dgelu = torch.empty((rows, hidden), **f32) if m is None else None
    dx = torch.empty_like(x)
    dy = torch.empty_like(x) if shift else None
    dw1 = torch.empty((hidden, C), **f32)
    dw2 = torch.empty((C, hidden), **f32)
    db1 = torch.empty(hidden, **f32)
    dbw2, ds1, db1n, ds2, db2 = (torch.empty(C, **f32) for _ in range(5))
    w1_t, w2_t = w1.t().contiguous(), w2.t().contiguous()
    P = kernels.ptr
    kernels.launch("stswin_block_epilogue_bwd", dev, P(x), P(y), P(g), P(m),
                   P(s2), P(b2), P(w1), P(b1), P(w1_t), P(w2), P(bw2),
                   P(w2_t), P(s1), P(s32), P(n2), P(h), P(dgelu),
                   P(m_scratch), P(dm), P(do32), P(dpre), P(dn2), P(dx),
                   P(dy), P(dw1), P(db1), P(dw2), P(dbw2), P(ds1), P(db1n),
                   P(ds2), P(db2), BT, H, W, C, hidden, shift,
                   1 if gelu_exact else 2, float(eps))
    swin_block_epilogue_bwd.launches += 1
    return (dx, dx if dy is None else dy, ds2, db2, dw1, db1, dw2, dbw2, ds1,
            db1n)


swin_block_epilogue_bwd.launches = 0


class EpilogueFn(torch.autograd.Function):
    """K2 forward (with the `m` output where `mlp_output_saved`, or at
    every shape with `m_out`), K6 backward; the twins on the CPU. Weights
    arrive in any float dtype and are cast to x's dtype; their gradients
    return in their own dtype."""

    @staticmethod
    def forward(ctx, x, y, s2, b2, w1, b1, w2, bw2, s1, b1n, gelu_exact,
                shift, ws, eps, m_out=None):
        ctx.cfg = (gelu_exact, shift, ws, eps)
        params = (s2, b2, w1, b1, w2, bw2, s1, b1n)
        ctx.dtypes = tuple(t.dtype for t in params)
        w1c, w2c = w1.to(x.dtype), w2.to(x.dtype)
        args = (x, y, s2, b2, w1c, b1, w2c, bw2, s1, b1n, gelu_exact, shift,
                ws, eps)
        with_m = (mlp_output_saved(x.shape[-1], w1.shape[0], x.dtype)
                  if m_out is None else m_out)
        if x.device.type == "cpu":
            fwd = (swin_block_epilogue_with_m_ref if with_m
                   else swin_block_epilogue_ref)
            out = fwd(*args)
            out, m = out if with_m else (out, None)
        else:
            out, m = _forward_kernel(*args, with_m=with_m)
        ctx.save_for_backward(x, y, s2, b2, w1c, b1, w2c, bw2, s1, b1n, m)
        return out

    @staticmethod
    def backward(ctx, g):
        gelu_exact, shift, ws, eps = ctx.cfg
        x, y, s2, b2, w1, b1, w2, bw2, s1, b1n, m = ctx.saved_tensors
        g = g.contiguous()
        if g.device.type == "cpu":
            grads = swin_block_epilogue_bwd_ref(
                x, y, s2, b2, w1, b1, w2, bw2, s1, b1n, g, gelu_exact, shift,
                ws, eps)
        else:
            grads = swin_block_epilogue_bwd(x, y, g, m, s2, b2, w1, b1, w2,
                                            bw2, s1, gelu_exact, shift, ws,
                                            eps)
        dx, dy, *dparams = grads
        dparams = [d.to(t) for d, t in zip(dparams, ctx.dtypes)]
        return (dx, dy, *dparams, None, None, None, None, None)


def add_ln_mlp_ref(x, y, scale, bias, w1, b1, w2, b2,
                   gelu_exact: bool = True, eps: float = 1e-5):
    """Plain twin of row 13 (port of `add_ln_mlp_ref`): s = x + y in fp32,
    returned rounded to x's dtype, and m = MLP(LN(s)) with LN(s) and the
    GELU output rounded to x's dtype and m from the fp32 sum rounded once.
    The weights are cast to x's dtype, as `mlp_ref` casts them."""
    s32 = x.float() + y.float()
    n = layer_norm_f32(s32, scale, bias, eps).to(x.dtype)
    h = gelu(F.linear(n.float(), w1.to(x.dtype).float(), b1.float()),
             gelu_exact)
    m = F.linear(h.to(x.dtype).float(), w2.to(x.dtype).float(), b2.float())
    return s32.to(x.dtype), m.to(x.dtype)


def _add_ln_mlp_kernel(x, y, scale, bias, w1, b1, w2, b2, gelu_exact, eps):
    """Launch row 13 (weights already in x's dtype)."""
    name = "add_ln_mlp"
    C, hidden = x.shape[-1], w1.shape[0]
    kernels.require(y.shape == x.shape, f"{name}: y {tuple(y.shape)} vs x "
                    f"{tuple(x.shape)}")
    _check_params(name, x, w1, b1, w2, (scale, bias, b2), C, hidden)
    kernels.require_on(x.device, name, y)
    check_mlp_widths(name, C, hidden)
    x, y = x.contiguous(), y.contiguous()
    kernels.require(all(t.is_contiguous() and t.data_ptr() % 16 == 0
                        for t in (x, y, w1, w2)),
                    f"{name}: x, y and the weights must be contiguous and "
                    "16-byte aligned")
    rows = x.numel() // C
    dev = x.device
    s, m = torch.empty_like(x), torch.empty_like(x)
    if rows == 0:
        return s, m
    s32 = torch.empty((rows, C), dtype=torch.float32, device=dev)
    n = torch.empty((rows, C), dtype=x.dtype, device=dev)
    hid = torch.empty((rows, hidden), dtype=x.dtype, device=dev)
    P = kernels.ptr
    kernels.launch("stswin_add_ln_mlp", dev, P(x), P(y), P(scale), P(bias),
                   P(w1), P(b1), P(w2), P(b2), P(s32), P(n), P(hid), P(s),
                   P(m), rows, C, hidden, 1 if gelu_exact else 2, float(eps))
    add_ln_mlp.launches += 1
    return s, m


def _add_ln_mlp_forward(x, y, scale, bias, w1, b1, w2, b2, gelu_exact, eps):
    if x.device.type == "cpu":
        return add_ln_mlp_ref(x, y, scale, bias, w1, b1, w2, b2, gelu_exact,
                              eps)
    return _add_ln_mlp_kernel(x, y, scale, bias, w1.to(x.dtype), b1,
                              w2.to(x.dtype), b2, gelu_exact, eps)


def add_ln_mlp(x, y, scale, bias, w1, b1, w2, b2, gelu_exact: bool = True,
               eps: float = 1e-5):
    """Pallas row 13: (x + y, MLP(LayerNorm(x + y))) over the last axis.
    x, y: (..., C) in one dtype; scale, bias, b1, b2 fp32; w1 (hidden, C),
    w2 (C, hidden). Returns (s, m), each of x's shape and dtype."""
    args = (x, y, scale, bias, w1, b1, w2, b2, gelu_exact, eps)
    if kernels.needs_grad(x, y, scale, bias, w1, b1, w2, b2):
        return AddLnMlpFn.apply(*args)
    return _add_ln_mlp_forward(*args)


add_ln_mlp.launches = 0


class AddLnMlpFn(torch.autograd.Function):
    """Row 13: the kernel forward on CUDA (the twin on the CPU); backward:
    autograd of `add_ln_mlp_ref` on the saved inputs (JAX's `_bwd`)."""

    @staticmethod
    def forward(ctx, x, y, scale, bias, w1, b1, w2, b2, gelu_exact, eps):
        ctx.cfg = (gelu_exact, eps)
        ctx.save_for_backward(x, y, scale, bias, w1, b1, w2, b2)
        return _add_ln_mlp_forward(x, y, scale, bias, w1, b1, w2, b2,
                                   gelu_exact, eps)

    @staticmethod
    def backward(ctx, gs, gm):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            outs = add_ln_mlp_ref(*leaves, *ctx.cfg)
            grads = torch.autograd.grad(outs, leaves, (gs, gm))
        return (*grads, None, None)
