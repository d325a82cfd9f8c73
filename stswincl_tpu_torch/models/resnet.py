"""Dilated ResNet backbones on NHWC tensors.

Counterpart of `stswincl_tpu/models/resnet.py` (`ConvBN`, `BasicBlock`,
`BottleneckBlock`, `ResNet18OS8`, `ResNet50OS16`). ResNet18-OS8:
torchvision resnet18 stem + layer1/layer2, then two dilated stages
(dilation 2 and 4, stride 1), output stride 8. ResNet50-OS16: the stem and
layer1-3 of resnet50, then three rate-2 dilated bottlenecks up to 2048
channels, output stride 16 (the DeepLabV3+ baseline's `layers=50`). Both
stems are the plain 7x7/2 conv: the JAX package's space-to-depth stem is a
TPU route. The convolutions go to cuDNN in channels_last; BatchNorm runs in
fp32 and casts back.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from stswincl_tpu_torch.models.layers import Conv
from stswincl_tpu_torch.models.norm import BatchNorm


class ConvBN(nn.Module):
    """Conv (no bias) + BatchNorm, torch padding semantics."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 dilation: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = Conv(in_ch, out_ch, kernel, stride, dilation, bias=False)
        self.bn = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x, self.dtype)).to(self.dtype)


class BasicBlock(nn.Module):
    """Two 3x3 ConvBNs + a 1x1 projection shortcut when the shape
    changes."""

    def __init__(self, in_ch: int, channels: int, stride: int = 1,
                 dilation: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cb1 = ConvBN(in_ch, channels, 3, stride, dilation, dtype)
        self.cb2 = ConvBN(channels, channels, 3, 1, dilation, dtype)
        self.downsample = (ConvBN(in_ch, channels, 1, stride, 1, dtype)
                           if stride != 1 or in_ch != channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.cb2(F.relu(self.cb1(x)))
        sc = x if self.downsample is None else self.downsample(x)
        return F.relu(out + sc)


class BottleneckBlock(nn.Module):
    """1x1 reduce -> 3x3 (stride or dilation) -> 1x1 expand to
    4 * channels, with a 1x1 projection shortcut when the shape changes."""

    def __init__(self, in_ch: int, channels: int, stride: int = 1,
                 dilation: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        out_ch = 4 * channels
        self.cb1 = ConvBN(in_ch, channels, 1, dtype=dtype)
        self.cb2 = ConvBN(channels, channels, 3, stride, dilation, dtype)
        self.cb3 = ConvBN(channels, out_ch, 1, dtype=dtype)
        self.downsample = (ConvBN(in_ch, out_ch, 1, stride, 1, dtype)
                           if stride != 1 or in_ch != out_ch else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.cb3(F.relu(self.cb2(F.relu(self.cb1(x)))))
        sc = x if self.downsample is None else self.downsample(x)
        return F.relu(out + sc)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """torchvision stem maxpool (3x3, stride 2, padding 1) on NHWC."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1)
    return y.permute(0, 2, 3, 1)


class ResNet18OS8(nn.Module):
    """(N, H, W, 3) -> (N, H/8, W/8, 8*width)."""

    def __init__(self, width: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        w = width
        self.dtype = dtype
        self.stem = ConvBN(3, w, 7, 2, 1, dtype)
        self.layer1_0 = BasicBlock(w, w, dtype=dtype)
        self.layer1_1 = BasicBlock(w, w, dtype=dtype)
        self.layer2_0 = BasicBlock(w, 2 * w, stride=2, dtype=dtype)
        self.layer2_1 = BasicBlock(2 * w, 2 * w, dtype=dtype)
        self.layer4_0 = BasicBlock(2 * w, 4 * w, dilation=2, dtype=dtype)
        self.layer4_1 = BasicBlock(4 * w, 4 * w, dilation=2, dtype=dtype)
        self.layer5_0 = BasicBlock(4 * w, 8 * w, dilation=4, dtype=dtype)
        self.layer5_1 = BasicBlock(8 * w, 8 * w, dilation=4, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool_3x3_s2(F.relu(self.stem(x.to(self.dtype))))
        for blk in (self.layer1_0, self.layer1_1, self.layer2_0,
                    self.layer2_1, self.layer4_0, self.layer4_1,
                    self.layer5_0, self.layer5_1):
            x = blk(x)
        return x


class ResNet50OS16(nn.Module):
    """(N, H, W, 3) -> (N, H/16, W/16, 2048): layer1-3 of resnet50 (3, 4
    and 6 bottlenecks), then `layer5_{0,1,2}`, rate-2 dilated bottlenecks
    in place of the strided layer4."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stem = ConvBN(3, 64, 7, 2, 1, dtype)
        self.blocks = []
        in_ch = 64
        for name, n, channels, stride, dilation in (
                ("layer1", 3, 64, 1, 1), ("layer2", 4, 128, 2, 1),
                ("layer3", 6, 256, 2, 1), ("layer5", 3, 512, 1, 2)):
            for i in range(n):
                blk = BottleneckBlock(in_ch, channels,
                                      stride if i == 0 else 1, dilation,
                                      dtype)
                self.add_module(f"{name}_{i}", blk)
                self.blocks.append(blk)
                in_ch = 4 * channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool_3x3_s2(F.relu(self.stem(x.to(self.dtype))))
        for blk in self.blocks:
            x = blk(x)
        return x
