"""Contrastive encoder and projection heads of the inter-video stage.

Counterpart of `stswincl_tpu/models/pixpro.py` (`:36-116`), after the
reference's `PixPro` (`pixcontrast_18/contrast/models/PixPro_swin_v5.py:
29-256`): the TswinPlus trunk (ResNet, swin stack, ASPP and the three
projections, no classifier) followed by a 1x1-conv MLP projector
(400 -> 512 -> 256) and an L2 norm. One module holds one set of weights;
the train step (`train/train_contrast.py`) keeps a query copy and an EMA
key copy of it.

Parameter names follow the JAX tree: `segmentor.<trunk>`,
`projector.linear1/bn1/linear2` and, with `with_instance`,
`projector_instance.*` and `predictor.*`, so `ckpt.load_from_jax` maps a
JAX `ContrastEncoder` tree one to one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from stswincl_tpu_torch.models.layers import Conv
from stswincl_tpu_torch.models.norm import BatchNorm
from stswincl_tpu_torch.models.stswin import TswinPlus


class MLP2d(nn.Module):
    """1x1 conv -> BatchNorm -> ReLU -> 1x1 conv on NHWC maps
    (`PixPro_swin_v5.py:29-46`); convs in `dtype`, the BatchNorm in fp32,
    the output in `dtype`."""

    def __init__(self, in_dim: int, inner_dim: int = 512, out_dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.linear1 = Conv(in_dim, inner_dim, 1, bias=True)
        self.bn1 = BatchNorm(inner_dim)
        self.linear2 = Conv(inner_dim, out_dim, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.linear1(x, self.dtype)).to(self.dtype))
        return self.linear2(x, self.dtype)


def ProjHead(in_dim: int = 400, dtype: torch.dtype = torch.float32) -> MLP2d:
    """Proj_Head: MLP2d(400 -> 512 -> 256) (`PixPro_swin_v5.py:131-132`)."""
    return MLP2d(in_dim, 512, 256, dtype)


def PredHead(in_dim: int = 256, dtype: torch.dtype = torch.float32) -> MLP2d:
    """Pred_Head: MLP2d(256 -> 4096 -> 256) (`PixPro_swin_v5.py:134-135`)."""
    return MLP2d(in_dim, 4096, 256, dtype)


class ContrastEncoder(nn.Module):
    """Clip (B, 4, H, W, 3) -> (B, H/8, W/8, 256) fp32 L2-normalised pixel
    embeddings (the norm guarded at 1e-12, as F.normalize).

    `with_instance` adds the reference's instance-level branch
    (`PixPro_swin_v5.py:243-256`): a global average pool of the 400-channel
    map, an instance projector and a predictor; the forward then returns
    (pixel embeddings, instance projection (B, 256), instance prediction
    (B, 256)), both fp32. `num_classes` is kept for the stage hand-offs; the
    trunk holds no classifier (see `TswinPlus(classifier=False)`).
    `input_hw`, `kernels` and `attn_impl` are the trunk's
    (`models/stswin.TswinPlus`)."""

    def __init__(self, num_classes: int, swin_dim: int = 512,
                 num_heads: int = 4, with_instance: bool = False,
                 swin_depths: Tuple[int, int] = (3, 3),
                 dtype: torch.dtype = torch.float32,
                 input_hw: Tuple[int, int] = (256, 448),
                 kernels: Optional[bool] = None, attn_impl: str = "auto"):
        super().__init__()
        self.num_classes, self.with_instance = num_classes, with_instance
        self.dtype = dtype
        self.segmentor = TswinPlus(num_classes, swin_dim=swin_dim,
                                   num_heads=num_heads,
                                   swin_depths=swin_depths, dtype=dtype,
                                   input_hw=input_hw, kernels=kernels,
                                   attn_impl=attn_impl, classifier=False)
        self.projector = ProjHead(dtype=dtype)
        if with_instance:
            self.projector_instance = ProjHead(dtype=dtype)
            self.predictor = PredHead(dtype=dtype)

    def forward(self, x: torch.Tensor):
        features = self.segmentor(x, return_features=True)
        proj = self.projector(features).float()
        pix = proj / proj.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        if not self.with_instance:
            return pix
        pooled = features.float().mean(dim=(1, 2), keepdim=True).to(self.dtype)
        ins_proj = self.projector_instance(pooled)
        ins_pred = self.predictor(ins_proj)
        return pix, ins_proj[:, 0, 0].float(), ins_pred[:, 0, 0].float()
