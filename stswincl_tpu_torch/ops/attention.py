"""Joint space-time window attention (plain PyTorch).

Counterpart of `stswincl_tpu/ops/attention.py`. `attend_tiled` is the
shared softmax contract of every attention path in both packages: fp32
scores, the scale applied to the fp32 scores after the matmul, the tiled
relative bias added, the mask added only when there is one per window, and
the row sum applied as a multiply by its reciprocal.
"""

from __future__ import annotations

from typing import Optional

import torch


def attend_tiled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 bias_tiled: torch.Tensor, mask_tiled: Optional[torch.Tensor],
                 scale: float) -> torch.Tensor:
    """q, k, v: (Bw, heads, TN, hd); bias_tiled: (heads, TN, TN);
    mask_tiled: (nW, TN, TN) applied to consecutive groups of nW windows,
    or None / a single (1, TN, TN) entry for W-MSA (its zero add is
    skipped). Returns (Bw, heads, TN, hd) in v's dtype."""
    Bw, heads, TN, _ = q.shape
    scores = q.float() @ k.float().transpose(-1, -2)
    scores = scores * scale + bias_tiled.float()[None]
    if mask_tiled is not None and mask_tiled.shape[0] > 1:
        nW = mask_tiled.shape[0]
        scores = (scores.reshape(Bw // nW, nW, heads, TN, TN)
                  + mask_tiled.float()[None, :, None]).reshape(
                      Bw, heads, TN, TN)
    mx = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - mx)
    p = e * (1.0 / e.sum(dim=-1, keepdim=True))
    out = p.to(v.dtype).float() @ v.float()
    return out.to(v.dtype)


def space_time_window_attention(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, rel_bias: torch.Tensor,
                                mask: Optional[torch.Tensor],
                                scale: float) -> torch.Tensor:
    """Attention over joint space-time windows.

    q, k, v: (Bw, heads, T*N, head_dim), tokens ordered frame-major;
    rel_bias: (heads, N, N), tiled T x T; mask: optional (nW, N, N)
    SW-MSA mask, tiled T x T. Returns (Bw, heads, T*N, head_dim)."""
    N = rel_bias.shape[-1]
    T = q.shape[2] // N
    bias = rel_bias.float().repeat(1, T, T)
    m = None if mask is None else mask.float().repeat(1, T, T)
    return attend_tiled(q, k, v, bias, m, scale)
