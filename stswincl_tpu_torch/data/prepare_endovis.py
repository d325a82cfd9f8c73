"""Offline EndoVis2018 preprocessing: the raw release -> the layout the
datasets read.

The port's own copy of `stswincl_tpu/data/prepare_endovis.py`, after the
reference's offline helpers (`seg18/dataset/Endovis2018_new.py:188-241`).
It converts the raw 1024x1280 EndoVis release (`<src>/<split>/seq_N/
left_frames/frameNNN.png`, RGB labels in `labels/`, the colour table in
`<src>/train/labels.json`) into `Processed_train` / `Processed_test`:

  * images: bilinear resize to 512x640;
  * labels (train split only): RGB colour maps decoded to class-id
    grayscale PNGs (`grayframeNNN.png`) through the `labels.json` colour
    table, then 2x nearest subsampling (the reference's `[::2, ::2]`).

Usage:
  python -m stswincl_tpu_torch.data.prepare_endovis --src /raw/ead2018 \
      --dst /data/ead2018 --split train
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
from PIL import Image


def decode_color_label(rgb: np.ndarray, color_table: np.ndarray) -> np.ndarray:
    mask = np.zeros(rgb.shape[:2], dtype=np.uint8)
    for cid, color in enumerate(color_table):
        mask[(rgb[:, :, :3] == color).sum(axis=-1) == 3] = cid
    return mask


def prepare_sequence(seq_dir: str, dst_dir: str, color_table: np.ndarray,
                     make_gray_labels: bool = True):
    img_src = os.path.join(seq_dir, "left_frames")
    lbl_src = os.path.join(seq_dir, "labels")
    img_dst = os.path.join(dst_dir, "left_frames")
    lbl_dst = os.path.join(dst_dir, "labels")
    os.makedirs(img_dst, exist_ok=True)
    os.makedirs(lbl_dst, exist_ok=True)

    for name in sorted(os.listdir(img_src)):
        if not name.startswith("frame"):
            continue
        im = Image.open(os.path.join(img_src, name)).convert("RGB")
        im.resize((640, 512), Image.BILINEAR).save(os.path.join(img_dst, name))

        lbl_path = os.path.join(lbl_src, name)
        if not os.path.exists(lbl_path):
            continue
        rgb = np.asarray(Image.open(lbl_path))
        if make_gray_labels:
            ids = decode_color_label(rgb, color_table)
            ids = ids[::2, ::2]  # reference subsamples labels 2x nearest
            Image.fromarray(ids).save(
                os.path.join(lbl_dst, "gray" + name))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True, help="raw EndoVis root")
    ap.add_argument("--dst", required=True, help="processed output root")
    ap.add_argument("--split", choices=["train", "test"], default="train")
    args = ap.parse_args(argv)

    with open(os.path.join(args.src, "train", "labels.json")) as f:
        color_table = np.array([it["color"] for it in json.load(f)])

    sub = "Processed_train" if args.split == "train" else "Processed_test"
    src_root = os.path.join(args.src, args.split)
    for name in sorted(os.listdir(src_root)):
        if not name.startswith("seq_"):
            continue
        prepare_sequence(
            os.path.join(src_root, name),
            os.path.join(args.dst, sub, name),
            color_table,
            make_gray_labels=(args.split == "train"),
        )
        print("done", name)


if __name__ == "__main__":
    main()
