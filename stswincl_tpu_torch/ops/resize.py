"""Bilinear resizes of the eval protocol and of training (plain PyTorch).

Counterpart of `stswincl_tpu/ops/resize.py`: the interpolation matrices,
the composed model-upsample x eval-resize + argmax,
`resize_bilinear` (the heads' upsample, torch align_corners=False) and
`resize_bilinear_cf_matmul` (the training logits' upsample).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from stswincl_tpu_torch.kernels import use_kernels
from stswincl_tpu_torch.ops.upsample_argmax import (upsample_argmax,
                                                    upsample_argmax_ref)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Half-pixel bilinear resize of (B, H, W, C), computed in fp32 and
    cast back; only used to upsample (where it equals
    `jax.image.resize(method='bilinear')`)."""
    B, H, W, C = x.shape
    if (H, W) == (out_h, out_w):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(out_h, out_w),
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def resize_bilinear_cf_matmul(x_cf: torch.Tensor, out_h: int,
                              out_w: int) -> torch.Tensor:
    """Half-pixel bilinear resize of channels-first (..., C, H, W) maps as
    two interpolation-matrix products (`resize_bilinear_cf_matmul` of the
    JAX package), so forward and backward are matrix products; fp32
    inside, cast back to x's dtype."""
    *lead, H, W = x_cf.shape
    if (H, W) == (out_h, out_w):
        return x_cf
    mh, mw = _device_matrices(H, W, (out_h, out_w), (out_h, out_w), False,
                              False, x_cf.device)
    y = mh @ x_cf.float().reshape(-1, H, W)
    y = y @ mw.t()
    return y.reshape(*lead, out_h, out_w).to(x_cf.dtype)


def _interp_matrix(src: torch.Tensor, in_size: int) -> torch.Tensor:
    """(out, in) fp32 matrix that linearly interpolates at the fp32 source
    coordinates `src` (one per output row)."""
    lo = src.floor().to(torch.int64).clamp(0, in_size - 1)
    hi = (lo + 1).clamp(0, in_size - 1)
    w_hi = src - lo
    rows = torch.arange(src.shape[0])
    m = torch.zeros((src.shape[0], in_size), dtype=torch.float32)
    m.index_put_((rows, lo), 1.0 - w_hi, accumulate=True)
    m.index_put_((rows, hi), w_hi, accumulate=True)
    return m


def _half_pixel_matrix(in_size: int, out_size: int) -> torch.Tensor:
    """(out, in) fp32 bilinear matrix, half-pixel centers, edge-clamped."""
    src = (torch.arange(out_size, dtype=torch.float32) + 0.5) \
        * (in_size / out_size) - 0.5
    return _interp_matrix(src.clamp(0.0, in_size - 1), in_size)


def _align_corners_matrix(in_size: int, out_size: int) -> torch.Tensor:
    """(out, in) fp32 bilinear matrix with align_corners=True."""
    if out_size == 1:
        m = torch.zeros((1, in_size), dtype=torch.float32)
        m[0, 0] = 1.0
        return m
    src = torch.arange(out_size, dtype=torch.float32) \
        * ((in_size - 1) / (out_size - 1))
    return _interp_matrix(src, in_size)


def composed_matrices(h: int, w: int, mid_hw: tuple, out_hw: tuple,
                      align_mid: bool = False, align_out: bool = True):
    """(OH, h) and (OW, w) fp32 matrices of the model's upsample to
    `mid_hw` composed with the eval resize to `out_hw` (both separable
    linear maps, so M2 @ (M1 @ x) == (M2 @ M1) @ x)."""
    mat1 = _align_corners_matrix if align_mid else _half_pixel_matrix
    m1h, m1w = mat1(h, mid_hw[0]), mat1(w, mid_hw[1])
    if tuple(out_hw) == tuple(mid_hw):
        return m1h, m1w
    mat2 = _align_corners_matrix if align_out else _half_pixel_matrix
    return mat2(mid_hw[0], out_hw[0]) @ m1h, mat2(mid_hw[1], out_hw[1]) @ m1w


@functools.lru_cache(maxsize=8)
def _device_matrices(h, w, mid_hw, out_hw, align_mid, align_out, device):
    """`composed_matrices` on `device`, built once per shape (read only)."""
    mh, mw = composed_matrices(h, w, mid_hw, out_hw, align_mid, align_out)
    return mh.to(device), mw.to(device)


def composed_upsample_argmax_cf(lcf: torch.Tensor, mid_hw: tuple,
                                out_hw: tuple, align_mid: bool = False,
                                align_out: bool = True, exact: bool = False,
                                kernels: bool | None = None) -> torch.Tensor:
    """argmax over classes of the two chained bilinear upsamples of
    channels-first head-resolution logits (B, C, h, w) -> (B, OH, OW)
    int32. `kernels` (None: iff lcf is on CUDA) picks K4 or its twin."""
    _, _, h, w = lcf.shape
    mh, mw = _device_matrices(h, w, tuple(mid_hw), tuple(out_hw), align_mid,
                              align_out, lcf.device)
    fn = upsample_argmax if use_kernels(kernels, lcf) else upsample_argmax_ref
    return fn(lcf.float().contiguous(), mh, mw, exact)
