"""Six-view contrastive clip sampler of the inter-video stage (stage 2).

The port's copy of `stswincl_tpu/data/contrastive.py` (numpy and PIL),
after `pixcontrast_18/contrast/data/dataset.py:30-206` and its CaDIS twin.
For an anchor (video, frame) it assembles SIX 4-frame clips at 480x270
source resolution:

  view 0/1: two independent random-resized-crop views of the current clip
            [frame-3 .. frame] (label: the anchor frame's mask);
  view 2:   the adjacent clip one frame back [frame-4 .. frame-1]
            (label: frame-1's mask);
  view 3-5: one clip from each of 3 OTHER randomly chosen videos
            (labels: their last frames' masks);

each with its own random resized crop (scale (0.09, 0.49)) and horizontal
flip to 256x448, frames oldest first, ImageNet (EndoVis) or CenterNet
(CaDIS) normalisation, the reference's fallbacks for early frames
(`dataset.py:83-139`), and optionally RandAugment after each crop. Every
draw comes from the caller's generator, in the JAX package's order, so
both packages give the same sample bit for bit (`tests/test_torch_data.py`,
`tests/test_torch_rand_augment.py`).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from stswincl_tpu_torch.data.cadis import (MEAN as CENTERNET_MEAN,
                                           STD as CENTERNET_STD,
                                           TRAIN_VIDEOS, remap_experiment)
from stswincl_tpu_torch.data.rand_augment import (ClipRandAugment,
                                                  rand_augment_transform)
from stswincl_tpu_torch.data.transforms import resized_crop_clip

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def anchor_clip_indices(frame: int, t: int = 4) -> List[int]:
    """[frame-3, frame-2, frame-1, frame] with the reference's future-frame
    fallback: when frame < 4 the clip becomes descending future frames with
    the anchor moved one past the newest (`dataset.py:83-98`)."""
    if t > frame:
        ind = list(range(frame + t - 1, frame - 1, -1))
        prevs = ind[:t - 1]
        anchor = prevs[0] + 1
        return list(reversed(prevs)) + [anchor]
    return [frame - 3, frame - 2, frame - 1, frame]


def neg_clip_indices(frame: int, t: int = 4) -> List[int]:
    """Negative-clip indexing (`dataset.py:100-139`): 3 previous frames
    with the same style of fallback, anchor last."""
    ttt = t - 1
    if ttt > frame:
        ind = list(range(frame + ttt - 1, frame - 1, -1))
        prevs = ind[:ttt]
        anchor = prevs[0] + 1
        return list(reversed(prevs)) + [anchor]
    return [frame - 3, frame - 2, frame - 1, frame]


class ContrastiveClipDataset:
    """`get(index, rng)` -> {"clips" (6, 4, H, W, 3) float32, "labels"
    (6, H, W) int32, "coords" (6, 4) float32, "path" (seq, frame)}.

    `rand_augment` (a RandAugment config string, e.g. "rand-m9-mstd0.5";
    off by default, as the reference ships the menu unwired) augments each
    view after its crop with one op sequence replayed on its four frames
    (`ClipRandAugment`), drawn from the sample's generator at the same
    point as the JAX package draws it. Geometric ops warp the view's label
    with the same affine (nearest); label pixels warped in from outside
    the frame become `LABEL_FILL` (255), which the class-sum loss drops."""

    def __init__(
        self,
        root: str,
        dataset: str = "endovis18",  # or "cadis"
        tag: str = "1",
        crop_hw: Tuple[int, int] = (256, 448),
        src_wh: Tuple[int, int] = (480, 270),
        sequences: Optional[Sequence[int]] = None,
        frames_per_seq: Optional[Dict[int, int]] = None,
        crop_scale: Tuple[float, float] = (0.09, 0.49),
        rand_augment: Optional[str] = None,
    ):
        self.clip_augment = (ClipRandAugment(rand_augment_transform(
            rand_augment)) if rand_augment else None)
        self.root = root
        self.dataset = dataset
        self.tag = tag
        self.crop_h, self.crop_w = crop_hw
        self.src_w, self.src_h = src_wh
        self.crop_scale = crop_scale
        self._cadis_cache: Dict[int, List[str]] = {}

        if dataset == "endovis18":
            self.sequences = tuple(sequences) if sequences else (
                1, 2, 3, 4, 5, 6, 7, 9, 10, 11, 12, 13, 14, 15, 16)
            self.frames = frames_per_seq or {s: 149 for s in self.sequences}
            self.normalize = (IMAGENET_MEAN, IMAGENET_STD)
        else:
            self.sequences = tuple(sequences) if sequences else TRAIN_VIDEOS
            if frames_per_seq:
                self.frames = frames_per_seq
            else:
                # per-video frame counts from disk (the reference hard-codes
                # a table, dataset_cata.py:13-14)
                self.frames = {s: len(self.paths_cadis(s))
                               for s in self.sequences}
                self.sequences = tuple(s for s in self.sequences
                                       if self.frames[s] > 0)
            self.normalize = (CENTERNET_MEAN, CENTERNET_STD)

        self.samples = [(s, i) for i in range(max(self.frames.values()))
                        for s in self.sequences if i < self.frames[s]]

    def __len__(self):
        return len(self.samples)

    def _img_path(self, seq, frame):
        if self.dataset == "endovis18":
            return os.path.join(self.root, "Processed_train", f"seq_{seq}",
                                "left_frames", f"frame{frame:03d}.png")
        return self.paths_cadis(seq)[frame]

    def _label_path(self, seq, frame):
        if self.dataset == "endovis18":
            return os.path.join(self.root, "Processed_train", f"seq_{seq}",
                                "labels", f"grayframe{frame:03d}.png")
        return self.paths_cadis(seq)[frame].replace("Images", "Labels")

    def paths_cadis(self, seq):
        if seq not in self._cadis_cache:
            self._cadis_cache[seq] = sorted(glob.glob(os.path.join(
                self.root, f"Video{seq:02d}", "Images", "*.png")))
        return self._cadis_cache[seq]

    def _load_frame(self, seq, frame) -> Image.Image:
        im = Image.open(self._img_path(seq, frame)).convert("RGB")
        return im.resize((self.src_w, self.src_h), Image.BILINEAR)

    def _load_label(self, seq, frame) -> Image.Image:
        m = Image.open(self._label_path(seq, frame)).convert("L")
        if self.dataset == "cadis":
            m = Image.fromarray(remap_experiment(np.asarray(m), self.tag))
        return m.resize((self.src_w, self.src_h), Image.NEAREST)

    def _view(self, imgs, label, rng):
        clip, lab, coord = resized_crop_clip(
            imgs, label, self.crop_h, self.crop_w, rng, scale=self.crop_scale)
        if self.clip_augment is not None:
            clip, lab = self.clip_augment(rng, clip.astype(np.uint8),
                                          label=lab)
        mean, std = self.normalize
        clip = (clip.astype(np.float32) / 255.0 - mean) / std
        return clip, lab.astype(np.int32), coord

    def get(self, index: int, rng: np.random.Generator) -> Dict:
        seq, frame = self.samples[index]
        idxs = anchor_clip_indices(frame)  # oldest .. anchor

        cur_imgs = [self._load_frame(seq, i) for i in idxs]
        cur_label = self._load_label(seq, idxs[-1])
        adj_imgs = [self._load_frame(seq, i - 1) for i in idxs]
        adj_label = self._load_label(seq, idxs[-1] - 1)

        # three clips from three OTHER videos (`dataset.py:21-28`)
        others = [s for s in self.sequences if s != seq]
        neg_seqs = list(rng.choice(others, size=3, replace=False))

        views = [self._view(cur_imgs, cur_label, rng),
                 self._view(cur_imgs, cur_label, rng),
                 self._view(adj_imgs, adj_label, rng)]
        for ns in neg_seqs:
            nf = int(rng.integers(0, self.frames[int(ns)]))
            nidx = neg_clip_indices(nf)
            n_imgs = [self._load_frame(int(ns), i) for i in nidx]
            n_label = self._load_label(int(ns), nidx[-1])
            views.append(self._view(n_imgs, n_label, rng))

        clips, labels, coords = zip(*views)
        return {
            "clips": np.stack(clips),     # (6, 4, H, W, 3) float32
            "labels": np.stack(labels),   # (6, H, W) int32
            "coords": np.stack(coords),   # (6, 4) float32
            "path": (seq, frame),
        }
