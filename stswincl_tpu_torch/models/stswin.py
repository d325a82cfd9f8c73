"""TswinPlus, the STswin segmentation network.

Counterpart of `stswincl_tpu/models/stswin.py` (`ProjectBNRelu`,
`Classifier`, `TswinPlus`):

  frames -> ResNet18-OS8 (all B*T frames in one batch)
         -> SwinTemporalStack (stage1 @ OS8, stage2 @ OS16)
         -> last-frame slices of resnet / stage1 / stage2
         -> ASPP(stage2_last), three 1x1 projections to 48 channels
         -> upsample to OS8, concat (48*3 + 256 = 400)
         -> classifier -> logits.

`backbone` and `head` split the forward where `StreamingSegmenter` caches
(the JAX package's `_Backbone` / `_Head`). `model.train()` switches every
BatchNorm to batch statistics (`models/norm.py`); the training loss reads
`forward(x, channels_first_logits=True)`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from stswincl_tpu_torch.models.aspp import ASPP
from stswincl_tpu_torch.models.layers import Conv
from stswincl_tpu_torch.models.norm import BatchNorm
from stswincl_tpu_torch.models.resnet import ResNet18OS8
from stswincl_tpu_torch.models.swin import SwinTemporalStack
from stswincl_tpu_torch.ops.resize import (resize_bilinear,
                                           resize_bilinear_cf_matmul)


class ProjectBNRelu(nn.Module):
    """1x1 conv (no bias) + BN + ReLU projection to 48 channels."""

    def __init__(self, in_ch: int, features: int = 48,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = Conv(in_ch, features, 1, bias=False)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x, self.dtype)).to(self.dtype))


class Classifier(nn.Module):
    """conv3x3 (no bias) + BN + ReLU -> conv1x1 (num_classes)."""

    def __init__(self, in_ch: int, num_classes: int, hidden: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv(in_ch, hidden, 3, bias=False)
        self.bn = BatchNorm(hidden)
        self.conv2 = Conv(hidden, num_classes, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn(self.conv1(x, self.dtype)).to(self.dtype))
        return self.conv2(x, self.dtype)


class TswinPlus(nn.Module):
    """Input (B, 4, H, W, 3) clip, NHWC frames; output (B, H, W, classes)
    fp32 logits of the last frame, or with `head_res_logits` the raw
    (B, classes, H/8, W/8) fp32 logits, or with `channels_first_logits`
    (the training loss's layout) (B, classes, H, W) fp32 logits upsampled
    by two interpolation-matrix products.

    Parameters stay fp32; the model computes in `dtype` (bf16 to serve).
    `input_hw` fixes the feature resolution the swin windows are built for
    (the JAX stack reads it from its input). `kernels` (None: iff the
    input is on CUDA) chooses the CUDA kernels or their plain twins."""

    def __init__(self, num_classes: int, swin_dim: int = 512,
                 num_heads: int = 4, gelu_exact: bool = True,
                 final_pair_only: bool = True,
                 swin_depths: Tuple[int, int] = (3, 3),
                 dtype: torch.dtype = torch.float32,
                 input_hw: Tuple[int, int] = (512, 640),
                 kernels: Optional[bool] = None):
        super().__init__()
        self.num_classes, self.swin_dim = num_classes, swin_dim
        self.dtype, self.kernels = dtype, kernels
        self.input_hw = tuple(input_hw)
        h8, w8 = input_hw[0] // 8, input_hw[1] // 8
        self.resnet = ResNet18OS8(width=swin_dim // 8, dtype=dtype)
        self.swin = SwinTemporalStack(
            swin_dim, (h8, w8), num_heads, gelu_exact, final_pair_only,
            swin_depths, dtype, kernels)
        self.aspp = ASPP(2 * swin_dim, 256, dtype=dtype)
        self.project1 = ProjectBNRelu(swin_dim, dtype=dtype)
        self.project2 = ProjectBNRelu(swin_dim, dtype=dtype)
        self.project3 = ProjectBNRelu(2 * swin_dim, dtype=dtype)
        self.classifier = Classifier(48 * 3 + 256, num_classes, dtype=dtype)

    def backbone(self, frames: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) frames -> (N, H/8, W/8, swin_dim) features."""
        return self.resnet(frames)

    def head(self, feats: torch.Tensor,
             layer0_cached: Optional[torch.Tensor] = None,
             layer0_only: bool = False):
        """(B, 4, h8, w8, C) feature clip -> (B, classes, h8, w8) fp32
        logits; with `layer0_cached` also the fresh layer-0 group output,
        with `layer0_only` just the layer-0 output of one group."""
        if layer0_only:
            return self.swin(feats, layer0_only=True)
        B, T, h8, w8, _ = feats.shape
        res_last = feats[:, -1]
        if layer0_cached is not None:
            stage1, stage2, g_new = self.swin(feats,
                                              layer0_cached=layer0_cached)
        else:
            stage1, stage2 = self.swin(feats)
        s1_last, s2_last = stage1[:, -1], stage2[:, -1]
        aspp_up = resize_bilinear(self.aspp(s2_last), h8, w8)
        p1 = self.project1(res_last)
        p2 = self.project2(s1_last)
        p3 = resize_bilinear(self.project3(s2_last), h8, w8)
        logits = self.classifier(torch.cat([p1, p2, p3, aspp_up], dim=-1))
        lcf = logits.float().permute(0, 3, 1, 2).contiguous()
        if layer0_cached is not None:
            return lcf, g_new
        return lcf

    def forward(self, x: torch.Tensor, head_res_logits: bool = False,
                channels_first_logits: bool = False) -> torch.Tensor:
        B, T, H, W, C = x.shape
        feats = self.backbone(x.reshape(B * T, H, W, C))
        lcf = self.head(feats.reshape(B, T, *feats.shape[1:]))
        if head_res_logits:
            return lcf
        if channels_first_logits:
            return resize_bilinear_cf_matmul(lcf, H, W)
        return resize_bilinear(lcf.permute(0, 2, 3, 1), H, W)
