"""Atrous Spatial Pyramid Pooling head on NHWC tensors.

Counterpart of `stswincl_tpu/models/aspp.py`: 1x1 + three dilated 3x3
branches (rates 6/12/18) + the global-average image-pool branch, each to
in/2 channels, concat -> 1x1 fuse -> 1x1 out conv.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from stswincl_tpu_torch.models.layers import Conv
from stswincl_tpu_torch.models.norm import BatchNorm


class ConvBNRelu(nn.Module):
    """Conv (with bias, as the reference ASPP) + BatchNorm + ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 1,
                 dilation: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = Conv(in_ch, out_ch, kernel, 1, dilation, bias=True)
        self.bn = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x, self.dtype)).to(self.dtype))


class ASPP(nn.Module):
    def __init__(self, in_channels: int = 1024, out_channels: int = 256,
                 mid_channels: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = mid_channels or in_channels // 2
        self.dtype = dtype
        self.branch_1x1 = ConvBNRelu(in_channels, mid, 1, dtype=dtype)
        self.branch_r6 = ConvBNRelu(in_channels, mid, 3, 6, dtype)
        self.branch_r12 = ConvBNRelu(in_channels, mid, 3, 12, dtype)
        self.branch_r18 = ConvBNRelu(in_channels, mid, 3, 18, dtype)
        self.branch_img = ConvBNRelu(in_channels, mid, 1, dtype=dtype)
        self.fuse = ConvBNRelu(5 * mid, mid, 1, dtype=dtype)
        self.out_conv = Conv(mid, out_channels, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = x.shape
        # the image-pool mean accumulates in fp32, as jnp.mean does
        img = x.float().mean(dim=(1, 2), keepdim=True).to(x.dtype)
        img = self.branch_img(img)
        img = img.expand(B, H, W, img.shape[-1])  # bilinear from 1x1
        out = torch.cat([self.branch_1x1(x), self.branch_r6(x),
                         self.branch_r12(x), self.branch_r18(x), img],
                        dim=-1)
        return self.out_conv(self.fuse(out), self.dtype)
