"""Windowing primitives for shifted-window space-time attention.

Counterpart of `stswincl_tpu/ops/window.py`. The two constant builders are
the same numpy code (that module imports JAX, so they are re-written here);
`cyclic_shift` is `torch.roll`.
"""

from __future__ import annotations

import numpy as np
import torch


def cyclic_shift(x: torch.Tensor, shift: int,
                 reverse: bool = False) -> torch.Tensor:
    """Cyclic shift over the two spatial axes of an NHWC tensor:
    `torch.roll(x, (-shift, -shift), dims=(1, 2))`; `reverse` undoes it."""
    if shift == 0:
        return x
    s = shift if reverse else -shift
    return torch.roll(x, (s, s), dims=(1, 2))


def partition_qkv(qkv: torch.Tensor, heads: int, ws: int) -> torch.Tensor:
    """Image-layout qkv (B, T, H, W, 3C) -> (3, B * nW, heads, T*ws*ws, hd)
    frame-joint windows, windows row-major and minor to the batch, tokens
    (t, i, j) within a window (the partition of `models/swin.py:270-275`
    in the JAX package). A view: callers that need q, k, v contiguous
    copy it."""
    B, T, H, W, C3 = qkv.shape
    nH, nW = H // ws, W // ws
    xw = qkv.reshape(B, T, nH, ws, nW, ws, C3).permute(0, 2, 4, 1, 3, 5, 6)
    xw = xw.reshape(B * nH * nW, T * ws * ws, 3, heads, C3 // (3 * heads))
    return xw.permute(2, 0, 3, 1, 4)


def reverse_windows(o: torch.Tensor, B: int, T: int, H: int, W: int,
                    ws: int) -> torch.Tensor:
    """(B * nW, heads, T*ws*ws, hd) window outputs -> the (B, T, H, W, C)
    image layout: the inverse of `partition_qkv` (JAX `:283-285`)."""
    C = o.shape[1] * o.shape[3]
    o = o.permute(0, 2, 1, 3).reshape(B, H // ws, W // ws, T, ws, ws, C)
    return o.permute(0, 3, 1, 4, 2, 5, 6).reshape(B, T, H, W, C)


def relative_position_index(win_h: int, win_w: int) -> np.ndarray:
    """(N, N) int32 index into the flat (2*win_h-1)*(2*win_w-1) bias table,
    N = win_h*win_w (reference `swin_512.py:89-99`)."""
    coords = np.stack(np.meshgrid(np.arange(win_h), np.arange(win_w),
                                  indexing="ij"))
    coords_flat = coords.reshape(2, -1)
    rel = coords_flat[:, :, None] - coords_flat[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += win_h - 1
    rel[:, :, 1] += win_w - 1
    rel[:, :, 0] *= 2 * win_w - 1
    return rel.sum(-1).astype(np.int32)


def shifted_window_attention_mask(H: int, W: int, window_size: int,
                                  shift_size: int) -> np.ndarray:
    """(nW, N, N) SW-MSA mask of 0 / -100 entries, windows row-major
    (reference `swin_512.py:171-194`)."""
    ws, ss = window_size, shift_size
    if ss == 0:
        raise ValueError("mask is only defined for shifted windows "
                         "(shift_size > 0)")
    img_mask = np.zeros((1, H, W, 1), dtype=np.float32)
    slices = (slice(0, -ws), slice(-ws, -ss), slice(-ss, None))
    cnt = 0
    for h in slices:
        for w in slices:
            img_mask[:, h, w, :] = cnt
            cnt += 1
    m = img_mask.reshape(1, H // ws, ws, W // ws, ws, 1)
    m = m.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, np.float32(-100.0), np.float32(0.0))
