"""CaDIS v2 cataract-surgery segmentation: the tables and `CadisDataset`.

The port's copy of `stswincl_tpu/data/cadis.py` (numpy and PIL only; the
port imports nothing of the JAX package, `tests/test_torch_package.py`
holds the tables equal), after `segcata/dataset/CATA_new_512.py:56-244`:

  * video splits train / val / test = 19 / 3 / 3 videos;
  * clips of `t` frames with `step` spacing, future-frame fallback;
  * the ignore label (255) becomes `class_num - 1` at train time
    (`CATA_new_512.py:237`) and stays >= the scored classes otherwise;
  * train augmentation: a shared scale / pad / crop, then flips, gaussian
    noise and rotation; normalisation with the CenterNet mean / std.

The three granularity "experiments" (`segcata/utils/cadis_visualization.py:
160-318`, public CATARACTS-challenge tables): tag 1 -> 8 classes (every
instrument merged), tag 2 -> 17 classes + ignore, tag 3 -> 25 classes +
ignore; merged rare classes map to 255.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from stswincl_tpu_torch.data import transforms as T

MEAN = np.array([0.40789654, 0.44719302, 0.47026115], dtype=np.float32)
STD = np.array([0.28863828, 0.27408164, 0.27809835], dtype=np.float32)

TRAIN_VIDEOS = (1, 3, 4, 6, 8, 9, 10, 11, 13, 14, 15, 17, 18, 19, 20, 21, 23,
                24, 25)
VAL_VIDEOS = (5, 7, 16)
TEST_VIDEOS = (2, 12, 22)
VIDEO_SPLITS = {"train": TRAIN_VIDEOS, "val": VAL_VIDEOS, "test": TEST_VIDEOS}

# class count per experiment tag INCLUDING the ignore class
CADIS_CLASS_NUM = {"1": 9, "2": 18, "3": 26}

_EXP1 = {i: [i] for i in range(7)}
_EXP1[7] = list(range(7, 36))

_EXP2 = {i: [i] for i in range(7)}
_EXP2.update({
    7: [7, 8, 10, 27, 20, 32],
    8: [9, 22],
    9: [11, 33],
    10: [12, 28],
    11: [13, 21],
    12: [14, 24],
    13: [15, 18],
    14: [16, 23],
    15: [17],
    16: [19],
    255: [25, 26, 29, 30, 31, 34, 35],
})

_EXP3 = {i: [i] for i in range(25)}
_EXP3[255] = list(range(25, 36))

_REMAPPINGS = {"1": _EXP1, "2": _EXP2, "3": _EXP3}


def _remap_lut(tag: str) -> np.ndarray:
    """(36,) uint8 table: raw CaDIS class -> the experiment's class."""
    lut = np.full(36, 255, dtype=np.uint8)
    for target, sources in _REMAPPINGS[tag].items():
        for s in sources:
            lut[s] = target
    return lut


def remap_experiment(mask: np.ndarray, tag: str) -> np.ndarray:
    """Remap a raw 36-class CaDIS mask to the experiment's class set;
    merged rare classes map to 255 (ignore)."""
    return _remap_lut(tag)[np.clip(mask, 0, 35)]


class CadisDataset:
    def __init__(
        self,
        root: str,
        split: str = "train",
        tag: str = "2",
        t: int = 4,
        step: int = 1,
        crop_hw: Tuple[int, int] = (512, 640),
        base_hw: Tuple[int, int] = (540, 672),
        videos: Optional[Sequence[int]] = None,
        augment: bool = True,
    ):
        if split not in VIDEO_SPLITS or tag not in CADIS_CLASS_NUM:
            raise ValueError(f"split {split!r} / tag {tag!r}: one of "
                             f"{tuple(VIDEO_SPLITS)} / "
                             f"{tuple(CADIS_CLASS_NUM)}")
        self.root = root
        self.split = split
        self.tag = tag
        self.t = t
        self.step = step
        self.crop_h, self.crop_w = crop_hw
        self.base_h, self.base_w = base_hw
        self.class_num = CADIS_CLASS_NUM[tag]
        self.augment = augment and split == "train"

        vids = tuple(videos) if videos is not None else VIDEO_SPLITS[split]
        self.paths: Dict[int, List[str]] = {}
        self.samples: List[Tuple[int, int]] = []
        for vid in vids:
            li = sorted(glob.glob(
                os.path.join(root, f"Video{vid:02d}", "Images", "*.png")))
            self.paths[vid] = li
            self.samples += [(vid, i) for i in range(len(li))]

    def __len__(self):
        return len(self.samples)

    def _clip_paths(self, vid: int, frame: int) -> List[str]:
        """The clip's frames, `step` apart (`CATA_new_512.py:192-195`)."""
        t, step = self.t, self.step
        if frame > t:
            idxs = range(frame - (t - 1) * step, frame + 1, step)
        else:
            idxs = range(frame + (t - 1) * step, frame - 1, -step)
        return [self.paths[vid][i] for i in idxs]

    def _load_mask(self, img_path: str) -> Image.Image:
        mask_path = img_path.replace("Images", "Labels")
        mask = np.asarray(Image.open(mask_path).convert("L"))
        m = Image.fromarray(remap_experiment(mask, self.tag))
        if self.split == "train":
            m = m.resize((self.base_w, self.base_h), Image.NEAREST)
        return m

    def _load_img(self, p: str) -> Image.Image:
        img = Image.open(p).convert("RGB")
        size = ((self.base_w, self.base_h) if self.split == "train"
                else (self.crop_w, self.crop_h))
        return img.resize(size, Image.BILINEAR)

    def sliding_from(self, prev_path, path) -> bool:
        """True when `path`'s clip is `prev_path`'s clip advanced by one
        slot (clips stride by `step`), so a streaming feature cache built
        on the previous clip stays valid. Frames at or below `t` take the
        reversed fallback and never slide."""
        vid, f = path
        pvid, pf = prev_path
        return vid == pvid and f == pf + self.step and pf > self.t

    def get(self, index: int,
            rng: Optional[np.random.Generator] = None) -> Dict:
        vid, frame = self.samples[index]
        paths = self._clip_paths(vid, frame)
        imgs = [self._load_img(p) for p in paths]
        mask = self._load_mask(paths[-1])

        if self.split == "train":
            if rng is None:
                raise ValueError("a train sample needs rng")
            frames_np, label = T.random_scale_pad_crop(
                imgs, mask, self.base_w, self.crop_h, self.crop_w, rng)
            clip = np.stack(frames_np).astype(np.uint8)
            if self.augment:
                clip, label = T.vertical_flip(clip, label, rng)
                clip, label = T.horizontal_flip(clip, label, rng)
                clip = T.gaussian_noise(clip, rng)
                clip, label = T.rotate(clip, label, rng)
        else:
            clip = np.stack([np.asarray(im) for im in imgs])
            label = np.asarray(mask)

        image = clip.astype(np.float32) / 255.0
        image = (image - MEAN) / STD

        label = label.astype(np.int32)
        if self.split == "train":
            # at train time the ignore label becomes the last class id,
            # which the OHEM ignore_index also excludes
            label = np.where(label == 255, self.class_num - 1, label)

        return {"path": (vid, frame), "image": image, "label": label}
