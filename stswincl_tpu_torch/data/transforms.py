"""Host-side clip augmentations, numpy / PIL / cv2, explicitly seeded.

The port's copy of `stswincl_tpu/data/transforms.py` (numpy and PIL, cv2
where it imports): the same functions, arguments and draws, so that a
seeded `numpy.random.Generator` gives the same crops, flips and photometric
factors in both packages (`tests/test_torch_data.py` holds them equal).
Every random decision comes from the generator the caller hands in, seeded
per (epoch, sample) by the loader.

Menus:
  * a shared random long-edge scale in [0.5, 2]x base, a bottom / right
    zero pad and one random crop shared by every frame of a clip and its
    mask (`seg18/dataset/Endovis2018_new.py:145-182`);
  * vertical flip, brightness / contrast and rotation applied alike to the
    whole clip (`Endovis2018_new.py:68-84`);
  * CaDIS: horizontal / vertical flips, gaussian noise (var 1e-3) and
    rotation (`CATA_new_512.py:169-185`);
  * the contrastive stage's per-view random resized crop (scale (0.09,
    0.49), ratio (3/4, 4/3)) and horizontal flip with the crop's
    normalised coordinates (`contrast/data/transform_coord.py:139-232`).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None


# ---------------- shared clip-consistent geometry ----------------

def random_scale_pad_crop(
    imgs: List[Image.Image],
    mask: Image.Image,
    base_w: int,
    crop_h: int,
    crop_w: int,
    rng: np.random.Generator,
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Random long-edge rescale to [0.5, 2]*base_w, bottom/right zero pad to
    crop size, then one shared random crop for every frame + mask."""
    w, h = imgs[0].size
    long_size = int(rng.integers(int(base_w * 0.5), int(base_w * 2.0) + 1))
    if h > w:
        oh = long_size
        ow = int(1.0 * w * long_size / h + 0.5)
        short = ow
    else:
        ow = long_size
        oh = int(1.0 * h * long_size / w + 0.5)
        short = oh
    imgs = [im.resize((ow, oh), Image.BILINEAR) for im in imgs]
    mask = mask.resize((ow, oh), Image.NEAREST)

    if short < crop_w:
        padh = crop_h - oh if oh < crop_h else 0
        padw = crop_w - ow if ow < crop_w else 0
        imgs = [_pad_br(im, padw, padh, 0) for im in imgs]
        mask = _pad_br(mask, padw, padh, 0)

    w, h = imgs[0].size
    x1 = int(rng.integers(0, w - crop_w + 1))
    y1 = int(rng.integers(0, h - crop_h + 1))
    out = [np.array(im.crop((x1, y1, x1 + crop_w, y1 + crop_h))) for im in imgs]
    mask = np.array(mask.crop((x1, y1, x1 + crop_w, y1 + crop_h)))
    return out, mask


def _pad_br(im: Image.Image, padw: int, padh: int, fill) -> Image.Image:
    """Bottom/right padding, ImageOps.expand(border=(0,0,padw,padh))."""
    if padw == 0 and padh == 0:
        return im
    w, h = im.size
    out = Image.new(im.mode, (w + padw, h + padh), fill)
    out.paste(im, (0, 0))
    return out


# ---------------- photometric / geometric clip augs ----------------

def vertical_flip(images: np.ndarray, mask: np.ndarray, rng, p=0.5):
    """(T,H,W,C) images + (H,W) mask, flipped along H together."""
    if rng.random() < p:
        return images[:, ::-1].copy(), mask[::-1].copy()
    return images, mask


def horizontal_flip(images: np.ndarray, mask: np.ndarray, rng, p=0.5):
    if rng.random() < p:
        return images[:, :, ::-1].copy(), mask[:, ::-1].copy()
    return images, mask


def brightness_contrast(images: np.ndarray, rng, p=0.5, limit=0.2):
    """albumentations RandomBrightnessContrast semantics (brightness_by_max):
    img * (1 + alpha) + beta * 255, uint8-clipped; same factors for every
    frame of the clip."""
    if rng.random() >= p:
        return images
    alpha = 1.0 + rng.uniform(-limit, limit)
    beta = rng.uniform(-limit, limit)
    out = images.astype(np.float32) * alpha + beta * 255.0
    return np.clip(out, 0, 255).astype(np.uint8)


def rotate(images: np.ndarray, mask: np.ndarray, rng, p=0.5, limit=90):
    """Random rotation, reflect-101 border, bilinear for images / nearest for
    the mask; one angle shared by all frames (albumentations A.Rotate())."""
    if cv2 is None or rng.random() >= p:
        return images, mask
    angle = float(rng.uniform(-limit, limit))
    h, w = mask.shape[:2]
    m = cv2.getRotationMatrix2D((w / 2 - 0.5, h / 2 - 0.5), angle, 1.0)
    imgs = np.stack([
        cv2.warpAffine(im, m, (w, h), flags=cv2.INTER_LINEAR,
                       borderMode=cv2.BORDER_REFLECT_101)
        for im in images
    ])
    mask = cv2.warpAffine(mask, m, (w, h), flags=cv2.INTER_NEAREST,
                          borderMode=cv2.BORDER_REFLECT_101)
    return imgs, mask


def gaussian_noise(images: np.ndarray, rng, p=0.5, var=0.001):
    """skimage random_noise(mode='gaussian', var=1e-3, clip=True) equivalent
    per frame (`CATA_new_512.py:179-183`)."""
    if rng.random() >= p:
        return images
    x = images.astype(np.float32) / 255.0
    x = x + rng.normal(0.0, math.sqrt(var), size=x.shape)
    return (np.clip(x, 0.0, 1.0) * 255.0).astype(np.uint8)


# ---------------- contrastive per-view crop (coord-tracked) ----------------

def random_resized_crop_params(
    width: int, height: int, rng,
    scale=(0.09, 0.49), ratio=(3.0 / 4.0, 4.0 / 3.0),
) -> Tuple[int, int, int, int]:
    """(i, j, h, w) crop rect, torchvision RandomResizedCrop sampling."""
    area = height * width
    for _ in range(10):
        target_area = rng.uniform(*scale) * area
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(rng.uniform(*log_ratio))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            i = int(rng.integers(0, height - h + 1))
            j = int(rng.integers(0, width - w + 1))
            return i, j, h, w
    in_ratio = width / height
    if in_ratio < min(ratio):
        w = width
        h = int(round(w / min(ratio)))
    elif in_ratio > max(ratio):
        h = height
        w = int(round(h * max(ratio)))
    else:
        w, h = width, height
    return (height - h) // 2, (width - w) // 2, h, w


def resized_crop_clip(
    imgs: List[Image.Image],
    label: Image.Image,
    out_h: int,
    out_w: int,
    rng: np.random.Generator,
    hflip_p: float = 0.5,
    scale=(0.09, 0.49),
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One random resized crop + optional horizontal flip applied to every
    frame of a clip and its label; returns (clip (T,H,W,3) uint8, label
    (H,W) uint8, coord (4,) normalized crop rect with flip-swapped x's) —
    `transform_coord.py:51-70,81-107,210-224` semantics."""
    width, height = imgs[0].size
    i, j, h, w = random_resized_crop_params(width, height, rng, scale=scale)
    coord = np.array([
        j / (width - 1), i / (height - 1),
        (j + w - 1) / (width - 1), (i + h - 1) / (height - 1),
    ], dtype=np.float32)

    def rc(im, interp):
        return np.array(
            im.crop((j, i, j + w, i + h)).resize((out_w, out_h), interp))

    clip = np.stack([rc(im, Image.BILINEAR) for im in imgs])
    lab = rc(label, Image.NEAREST)

    if rng.random() < hflip_p:
        clip = clip[:, :, ::-1].copy()
        lab = lab[:, ::-1].copy()
        coord = coord[[2, 1, 0, 3]].copy()
    return clip, lab, coord
