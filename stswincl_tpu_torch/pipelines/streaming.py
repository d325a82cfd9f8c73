"""Streaming video inference with a backbone feature cache.

Counterpart of `stswincl_tpu/pipelines/streaming.py`. Consecutive clips
share 3 of their 4 frames, so each new frame costs ONE backbone pass plus
the swin/head stack, instead of four backbone passes. Half of swin layer 0
rides a cache as well: its (0, 1) group in the current clip is the (2, 3)
group computed two steps earlier, so each step computes only the fresh
(2, 3) group and keeps a two-deep ring of group outputs (`g_a`, `g_b`).

    seg = StreamingSegmenter(model, out_hw=(1024, 1280))
    cache, pred = seg.init_and_predict(first_clip)   # (B, 4, H, W, 3)
    for frame in stream:                             # (B, H, W, 3)
        cache, pred = seg.predict_next(cache, frame)

Predictions are (B, OH, OW) int32: the model's bilinear upsample to the
input resolution composed with the eval resize to `out_hw`, then argmax.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from stswincl_tpu_torch.models.stswin import TswinPlus
from stswincl_tpu_torch.ops.resize import composed_upsample_argmax_cf


class StreamingSegmenter:
    def __init__(self, model: TswinPlus,
                 out_hw: Optional[Tuple[int, int]] = None,
                 align_out: bool = True):
        """align_out: align_corners of the eval resize to `out_hw`: True
        for EndoVis (`seg18/test.py:155`), False for CaDIS."""
        self.model = model
        self.out_hw = out_hw
        self.align_out = align_out
        # an fp32 model gets the fp32 resize+argmax, a bf16 one the bf16
        # products, as in the JAX package's eval step
        self.exact = model.dtype == torch.float32

    def _predict(self, lcf: torch.Tensor) -> torch.Tensor:
        mid = (lcf.shape[2] * 8, lcf.shape[3] * 8)
        return composed_upsample_argmax_cf(
            lcf, mid, self.out_hw or mid, align_out=self.align_out,
            exact=self.exact, kernels=self.model.kernels)

    def _features(self, clip: torch.Tensor) -> torch.Tensor:
        B, T, H, W, C = clip.shape
        feats = self.model.backbone(clip.reshape(B * T, H, W, C))
        return feats.reshape(B, T, *feats.shape[1:])

    @torch.inference_mode()
    def init_cache(self, clip: torch.Tensor):
        """Warm the cache with a full (B, 4, H, W, 3) clip:
        (feats, g_a, g_b). g_a is layer 0 on frames (1, 2), the (0, 1)
        group of the next clip; g_b on frames (2, 3), of the clip after."""
        feats = self._features(clip)
        g_a = self.model.head(feats[:, 1:3], layer0_only=True)
        g_b = self.model.head(feats[:, 2:4], layer0_only=True)
        return feats, g_a, g_b

    @torch.inference_mode()
    def init_and_predict(self, clip: torch.Tensor):
        """Warm the cache AND segment the clip's last frame, sharing the
        backbone pass. Returns (cache, prediction)."""
        cache = self.init_cache(clip)
        return cache, self._predict(self.model.head(cache[0]))

    @torch.inference_mode()
    def predict_next(self, cache, frame: torch.Tensor):
        """Advance the stream by one (B, H, W, 3) frame; returns
        (new_cache, prediction)."""
        feats, g_a, g_b = cache
        new_feat = self.model.backbone(frame)
        feats = torch.cat([feats[:, 1:], new_feat[:, None]], dim=1)
        lcf, g_new = self.model.head(feats, layer0_cached=g_a)
        return (feats, g_b, g_new), self._predict(lcf)
