"""EndoVis2018 robotic scene segmentation dataset.

The port's copy of `stswincl_tpu/data/endovis18.py` (numpy and PIL only),
after `seg18/dataset/Endovis2018_new.py:21-182`:

  * train split: sequences {1..7, 9..16} x 149 frames, images and
    grayscale label maps pre-resized to 512x640 under
    `Processed_train/seq_N/`;
  * test split: seq 1 (250 frames) + seq 2-4 (249), images pre-resized
    under `Processed_test/`, labels decoded from the original-resolution
    RGB maps under `test/seq_N/labels/` through the `labels.json` colour
    table (scoring happens at 1024x1280);
  * clips of `t` frames ending at the target frame, future frames in
    reversed order when `frame < t`;
  * train augmentation: a shared random scale / pad / crop to 512x640,
    then a clip-consistent vertical flip, brightness / contrast and
    rotation;
  * normalisation: / 255 only.

Samples are channel-last numpy clips with integer label maps.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from stswincl_tpu_torch.data import transforms as T

TRAIN_SEQUENCES = (1, 2, 3, 4, 5, 6, 7, 9, 10, 11, 12, 13, 14, 15, 16)
TRAIN_FRAMES = 149
TEST_FRAMES = {1: 250, 2: 249, 3: 249, 4: 249}


def clip_frame_indices(frame: int, t: int) -> List[int]:
    """Indices of the `t`-frame clip ending at `frame`; future frames,
    reversed, when the video has not run `t` frames yet
    (`Endovis2018_new.py:119-124`)."""
    if t > frame:
        return list(range(frame + t - 1, frame - 1, -1))
    return list(range(frame - t + 1, frame + 1))


class EndovisDataset:
    def __init__(
        self,
        root: str,
        split: str = "train",
        t: int = 4,
        crop_hw: Tuple[int, int] = (512, 640),
        base_hw: Tuple[int, int] = (540, 672),
        sequences: Optional[Sequence[int]] = None,
        frames_per_seq: Optional[Dict[int, int]] = None,
        num_classes: int = 12,
        rate: int = 1,
        augment: bool = True,
    ):
        if split not in ("train", "test"):
            raise ValueError(f"split {split!r}: 'train' or 'test'")
        self.rate = rate
        self.root = root
        self.split = split
        self.t = t
        self.crop_h, self.crop_w = crop_hw
        self.base_h, self.base_w = base_hw
        self.num_classes = num_classes
        self.augment = augment and split == "train"

        if split == "train":
            seqs = tuple(sequences) if sequences is not None \
                else TRAIN_SEQUENCES
            counts = frames_per_seq or {s: TRAIN_FRAMES for s in seqs}
            self.samples = [(s, i) for i in range(max(counts.values()))
                            for s in seqs if i < counts[s]]
        else:
            seqs = tuple(sequences) if sequences is not None else (1, 2, 3, 4)
            counts = frames_per_seq or {s: TEST_FRAMES[s] for s in seqs}
            self.samples = [(s, i) for s in seqs for i in range(counts[s])]

        label_json = os.path.join(root, "train", "labels.json")
        if os.path.exists(label_json):
            with open(label_json) as f:
                lb = json.load(f)
            self.color_table = np.array([item["color"] for item in lb],
                                        dtype=np.int32)[:num_classes]
        else:
            self.color_table = None

    def __len__(self):
        return len(self.samples)

    # the path scheme (`Endovis2018_new.py:110-115`)
    def _img_path(self, seq, frame):
        sub = "Processed_test" if self.split == "test" else "Processed_train"
        return os.path.join(self.root, sub, f"seq_{seq}", "left_frames",
                            f"frame{frame:03d}.png")

    def _label_path(self, seq, frame):
        if self.split == "test":
            return os.path.join(self.root, "test", f"seq_{seq}", "labels",
                                f"frame{frame:03d}.png")
        return os.path.join(self.root, "Processed_train", f"seq_{seq}",
                            "labels", f"grayframe{frame:03d}.png")

    def decode_color_label(self, rgb: np.ndarray) -> np.ndarray:
        """RGB(A) label map -> class-id map through the labels.json table
        (`Endovis2018_new.py:132-135`)."""
        if self.color_table is None:
            raise FileNotFoundError(
                f"{os.path.join(self.root, 'train', 'labels.json')} not found")
        mask = np.zeros(rgb.shape[:2], dtype=np.int32)
        for cid, color in enumerate(self.color_table):
            mask[(rgb[:, :, :3] == color).sum(axis=-1) == 3] = cid
        return mask

    def sliding_from(self, prev_path, path) -> bool:
        """True when `path`'s clip is `prev_path`'s clip advanced by one
        frame (the ascending [f-t+1..f] form on both sides), so a streaming
        feature cache built on the previous clip stays valid. Frames below
        `t` take the reversed future-frame fallback and never slide."""
        seq, f = path
        pseq, pf = prev_path
        return seq == pseq and f == pf + 1 and pf >= self.t

    def get(self, index: int,
            rng: Optional[np.random.Generator] = None) -> Dict:
        """Load one sample; `rng` drives all randomness (required for an
        augmented train sample)."""
        seq, frame = self.samples[index]
        idxs = clip_frame_indices(frame, self.t)
        imgs = [Image.open(self._img_path(seq, i)) for i in idxs]
        imgs = [im.resize((self.crop_w, self.crop_h), Image.BILINEAR)
                for im in imgs]

        if self.split == "test":
            clip = np.stack([np.asarray(im.convert("RGB")) for im in imgs])
            rgb = np.asarray(Image.open(self._label_path(seq, frame)))
            label = self.decode_color_label(rgb)
        else:
            mask = Image.open(self._label_path(seq, frame)).convert("L")
            mask = mask.resize((self.crop_w, self.crop_h), Image.NEAREST)
            if self.augment:
                if rng is None:
                    raise ValueError("an augmented train sample needs rng")
                frames_np, label = T.random_scale_pad_crop(
                    [im.convert("RGB") for im in imgs], mask,
                    self.base_w, self.crop_h, self.crop_w, rng)
                clip = np.stack(frames_np).astype(np.uint8)
                clip, label = T.vertical_flip(clip, label, rng)
                clip = T.brightness_contrast(clip, rng)
                clip, label = T.rotate(clip, label, rng)
            else:
                clip = np.stack([np.asarray(im.convert("RGB"))
                                 for im in imgs])
                label = np.asarray(mask)

        image = clip.astype(np.float32) / 255.0
        label = np.asarray(label)
        if self.rate > 1:  # optional label subsampling (`:97`)
            label = label[::self.rate, ::self.rate]
        label = label.astype(np.int32)
        if self.num_classes == 11:
            # the 11-class variant drops class 9, absent from the test
            # split (`Endovis2018_new.py:100-103`)
            label = np.where(label == 9, 0, label)
            label = np.where(label > 9, label - 1, label)
        return {
            "path": (seq, frame),
            "image": image,  # (t, H, W, 3) float32 in [0, 1]
            "label": label,  # (H, W) train / (1024, 1280) test
        }
