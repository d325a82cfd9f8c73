"""RandAugment on numpy images, every draw from the caller's generator.

The port's own copy of `stswincl_tpu/data/rand_augment.py` (numpy only),
after the reference's vendored timm RandAugment
(`pixcontrast_18/contrast/data/rand_augment.py`) and its clip wrapper
(`contrast/data/augs.py:16-32`):

  * every random decision draws from an explicit `numpy.random.Generator`
    passed by the caller (no global `random` / `np.random` state), in the
    JAX package's order, so both packages augment a sample bit for bit;
  * ops are pure functions on HWC uint8 arrays; the pointwise ops keep
    PIL's integer semantics, the geometric ops an inverse-warp bilinear
    resample with PIL's affine conventions and grey fill;
  * `ClipRandAugment` replays ONE sampled op sequence on every frame of a
    clip (`per_frame=True`: independent draws per frame, the reference's
    `MapTransform`), and warps a label map with the same affines
    (nearest, `LABEL_FILL`);
  * `RandAugmentOp` holds only the op's name and looks `OPS` up when it is
    called, so a dataset holding it pickles into spawned loader workers.

Op menu, level -> argument mappings, probabilities and the
`rand-m{N}-n{M}-mstd{S}[-w{I}]` config grammar follow the reference
(`rand_augment.py:166-257,390-448`).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

MAX_LEVEL = 10.0
FILL = 128


# ---------------------------------------------------------------------------
# pointwise ops (PIL-exact integer semantics)
# ---------------------------------------------------------------------------

def _gray(img: np.ndarray) -> np.ndarray:
    """PIL convert('L') on RGB: fixed-point ITU-R 601-2 with rounding
    ((19595R + 38470G + 7471B + 0x8000) >> 16)."""
    r = img[..., 0].astype(np.uint32)
    g = img[..., 1].astype(np.uint32)
    b = img[..., 2].astype(np.uint32)
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def _blend(degenerate: np.ndarray, img: np.ndarray, factor: float) -> np.ndarray:
    """PIL Image.blend(degenerate, img, factor): float32 lerp, truncated."""
    out = degenerate.astype(np.float32) + np.float32(factor) * (
        img.astype(np.float32) - degenerate.astype(np.float32))
    return np.clip(out, 0, 255).astype(np.uint8)


def invert(img: np.ndarray) -> np.ndarray:
    return (255 - img.astype(np.int16)).astype(np.uint8)


def identity(img: np.ndarray) -> np.ndarray:
    return img


def solarize(img: np.ndarray, thresh: int) -> np.ndarray:
    """ImageOps.solarize: invert pixels >= thresh."""
    return np.where(img >= thresh, 255 - img.astype(np.int16), img).astype(np.uint8)


def solarize_add(img: np.ndarray, add: int, thresh: int = 128) -> np.ndarray:
    """reference `solarize_add` LUT (`rand_augment.py:129-141`)."""
    i = np.arange(256)
    lut = np.where(i < thresh, np.minimum(255, i + add), i).astype(np.uint8)
    return lut[img]


def posterize(img: np.ndarray, bits_to_keep: int) -> np.ndarray:
    if bits_to_keep >= 8:
        return img
    if bits_to_keep <= 0:
        return np.zeros_like(img)
    mask = ~(2 ** (8 - bits_to_keep) - 1) & 0xFF
    return (img & mask).astype(np.uint8)


def auto_contrast(img: np.ndarray) -> np.ndarray:
    """ImageOps.autocontrast(cutoff=0): per-channel linear stretch."""
    out = np.empty_like(img)
    for c in range(img.shape[-1]):
        ch = img[..., c]
        lo, hi = int(ch.min()), int(ch.max())
        if hi <= lo:
            out[..., c] = ch
        else:
            # PIL builds an integer LUT: scale = 255/(hi-lo), offset = -lo*scale,
            # lut[i] = round-half-up via int(i*scale + offset + 0.5) semantics —
            # PIL uses int(ix) after float math; replicate with floor
            scale = 255.0 / (hi - lo)
            i = np.arange(256, dtype=np.float64)
            lut = np.clip((i - lo) * scale, 0, 255).astype(np.uint8)
            out[..., c] = lut[ch]
    return out


def equalize(img: np.ndarray) -> np.ndarray:
    """ImageOps.equalize: per-channel histogram equalization, PIL's
    step/offset integer algorithm."""
    out = np.empty_like(img)
    for c in range(img.shape[-1]):
        ch = img[..., c]
        h = np.bincount(ch.reshape(-1), minlength=256)
        nonzero = h[h != 0]
        if len(nonzero) <= 1:
            out[..., c] = ch
            continue
        step = (int(h.sum()) - int(nonzero[-1])) // 255
        if not step:
            out[..., c] = ch
            continue
        n = step // 2
        lut = np.empty(256, dtype=np.int64)
        for i in range(256):
            lut[i] = n // step
            n += int(h[i])
        out[..., c] = np.clip(lut, 0, 255).astype(np.uint8)[ch]
    return out


def contrast(img: np.ndarray, factor: float) -> np.ndarray:
    """ImageEnhance.Contrast: blend with the mean-gray constant image."""
    mean = int(_gray(img).mean() + 0.5)
    return _blend(np.full_like(img, mean), img, factor)


def color(img: np.ndarray, factor: float) -> np.ndarray:
    """ImageEnhance.Color: blend with the grayscale image."""
    g = _gray(img)
    return _blend(np.stack([g] * img.shape[-1], axis=-1), img, factor)


def brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return _blend(np.zeros_like(img), img, factor)


def sharpness(img: np.ndarray, factor: float) -> np.ndarray:
    """ImageEnhance.Sharpness: blend with the SMOOTH-filtered image.
    PIL's 3x3 filter leaves the one-pixel border unchanged."""
    k = np.array([[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]]) / 13.0
    f = img.astype(np.float64)
    sm = f.copy()
    acc = np.zeros_like(f[1:-1, 1:-1])
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            acc += k[dy + 1, dx + 1] * f[1 + dy:f.shape[0] - 1 + dy,
                                         1 + dx:f.shape[1] - 1 + dx]
    sm[1:-1, 1:-1] = np.clip(np.round(acc), 0, 255)
    return _blend(sm.astype(np.uint8), img, factor)


# ---------------------------------------------------------------------------
# geometric ops (inverse-warp affine, bilinear, grey fill)
# ---------------------------------------------------------------------------

def _affine(img: np.ndarray, coeffs: Tuple[float, ...]) -> np.ndarray:
    """PIL `im.transform(size, AFFINE, coeffs)` semantics: for output pixel
    (x, y), sample input at (a*x + b*y + c, d*x + e*y + f); bilinear with
    constant grey fill outside."""
    a, b, c, d, e, f = coeffs
    H, W = img.shape[:2]
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    # PIL samples at pixel centers: coordinates get +0.5 then the affine,
    # then -0.5 back into array index space
    sx = a * (xs + 0.5) + b * (ys + 0.5) + c - 0.5
    sy = d * (xs + 0.5) + e * (ys + 0.5) + f - 0.5

    x0 = np.floor(sx)
    y0 = np.floor(sy)
    wx = sx - x0
    wy = sy - y0
    out = np.zeros(img.shape, np.float64)
    wsum = np.zeros((H, W), np.float64)
    for oy, wgt_y in ((0, 1.0 - wy), (1, wy)):
        for ox, wgt_x in ((0, 1.0 - wx), (1, wx)):
            xi = x0 + ox
            yi = y0 + oy
            valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            xi_c = np.clip(xi, 0, W - 1).astype(np.int64)
            yi_c = np.clip(yi, 0, H - 1).astype(np.int64)
            w = wgt_x * wgt_y * valid
            out += w[..., None] * img[yi_c, xi_c].astype(np.float64)
            wsum += w
    out = out + (1.0 - wsum)[..., None] * float(FILL)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def shear_x(img: np.ndarray, factor: float) -> np.ndarray:
    return _affine(img, (1, factor, 0, 0, 1, 0))


def shear_y(img: np.ndarray, factor: float) -> np.ndarray:
    return _affine(img, (1, 0, 0, factor, 1, 0))


def translate_x_rel(img: np.ndarray, pct: float) -> np.ndarray:
    return _affine(img, (1, 0, pct * img.shape[1], 0, 1, 0))


def translate_y_rel(img: np.ndarray, pct: float) -> np.ndarray:
    return _affine(img, (1, 0, 0, 0, 1, pct * img.shape[0]))


def translate_x_abs(img: np.ndarray, pixels: float) -> np.ndarray:
    return _affine(img, (1, 0, pixels, 0, 1, 0))


def translate_y_abs(img: np.ndarray, pixels: float) -> np.ndarray:
    return _affine(img, (1, 0, 0, 0, 1, pixels))


def rotate(img: np.ndarray, degrees: float) -> np.ndarray:
    """PIL Image.rotate(degrees): counter-clockwise about the center,
    expand=False."""
    return _affine(img, _rotate_coeffs(img.shape, degrees))


def _rotate_coeffs(shape, degrees: float) -> Tuple[float, ...]:
    H, W = shape[:2]
    # screen coords have y down: a visually counter-clockwise rotation is a
    # clockwise one mathematically, so the inverse map uses -angle
    angle = np.deg2rad(-degrees)
    cos, sin = np.cos(angle), np.sin(angle)
    cx, cy = W / 2.0, H / 2.0
    a, b = cos, sin
    d, e = -sin, cos
    c = cx - a * cx - b * cy
    f = cy - d * cx - e * cy
    return (a, b, c, d, e, f)


# ---------------------------------------------------------------------------
# label-map warps paired with the geometric ops
# ---------------------------------------------------------------------------

LABEL_FILL = 255  # out-of-range for every class count -> dropped by one-hot


def _affine_nearest(label: np.ndarray, coeffs: Tuple[float, ...],
                    fill: int = LABEL_FILL) -> np.ndarray:
    """Nearest-neighbor inverse warp with the SAME affine convention as
    `_affine`, for integer label maps; out-of-frame pixels become `fill`."""
    a, b, c, d, e, f = coeffs
    H, W = label.shape[:2]
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    sx = a * (xs + 0.5) + b * (ys + 0.5) + c - 0.5
    sy = d * (xs + 0.5) + e * (ys + 0.5) + f - 0.5
    xi = np.rint(sx).astype(np.int64)
    yi = np.rint(sy).astype(np.int64)
    valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    out = np.full(label.shape, fill, dtype=label.dtype)
    out[valid] = label[np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)][valid]
    return out


# geometric op name -> fn(shape, *args) producing the shared affine coeffs;
# any op listed here warps the label map alongside the image when the caller
# provides one (the fix for the pairing-oracle misalignment the photometric
# ops never had)
GEOMETRIC_COEFFS: Dict[str, Callable] = {
    "Rotate": _rotate_coeffs,
    "ShearX": lambda shape, factor: (1, factor, 0, 0, 1, 0),
    "ShearY": lambda shape, factor: (1, 0, 0, factor, 1, 0),
    "TranslateX": lambda shape, pixels: (1, 0, pixels, 0, 1, 0),
    "TranslateY": lambda shape, pixels: (1, 0, 0, 0, 1, pixels),
    "TranslateXRel": lambda shape, pct: (1, 0, pct * shape[1], 0, 1, 0),
    "TranslateYRel": lambda shape, pct: (1, 0, 0, 0, 1, pct * shape[0]),
}


# ---------------------------------------------------------------------------
# level -> argument mappings (reference `rand_augment.py:166-257`)
# ---------------------------------------------------------------------------

def _negate(rng: np.random.Generator, v: float) -> float:
    return -v if rng.random() > 0.5 else v


def _enhance_arg(level, rng, hp):
    return ((level / MAX_LEVEL) * 1.8 + 0.1,)


def _rotate_arg(level, rng, hp):
    return (_negate(rng, (level / MAX_LEVEL) * 30.0),)


def _shear_arg(level, rng, hp):
    return (_negate(rng, (level / MAX_LEVEL) * 0.3),)


def _translate_rel_arg(level, rng, hp):
    return (_negate(rng, (level / MAX_LEVEL) * 0.45),)


def _translate_abs_arg(level, rng, hp):
    return (_negate(rng, (level / MAX_LEVEL) * float(hp.get("translate_const", 250))),)


def _posterize_tpu_arg(level, rng, hp):
    return (int((level / MAX_LEVEL) * 4),)


def _posterize_original_arg(level, rng, hp):
    return (int((level / MAX_LEVEL) * 4) + 4,)


def _posterize_research_arg(level, rng, hp):
    return (4 - int((level / MAX_LEVEL) * 4),)


def _solarize_arg(level, rng, hp):
    return (int((level / MAX_LEVEL) * 256),)


def _solarize_add_arg(level, rng, hp):
    return (int((level / MAX_LEVEL) * 110),)


OPS: Dict[str, Tuple[Callable, Optional[Callable]]] = {
    "AutoContrast": (lambda img, *a: auto_contrast(img), None),
    "Equalize": (lambda img, *a: equalize(img), None),
    "Invert": (lambda img, *a: invert(img), None),
    "Identity": (lambda img, *a: identity(img), None),
    "Rotate": (rotate, _rotate_arg),
    "PosterizeOriginal": (posterize, _posterize_original_arg),
    "PosterizeResearch": (posterize, _posterize_research_arg),
    "PosterizeTpu": (posterize, _posterize_tpu_arg),
    "Solarize": (solarize, _solarize_arg),
    "SolarizeAdd": (solarize_add, _solarize_add_arg),
    "Color": (color, _enhance_arg),
    "Contrast": (contrast, _enhance_arg),
    "Brightness": (brightness, _enhance_arg),
    "Sharpness": (sharpness, _enhance_arg),
    "ShearX": (shear_x, _shear_arg),
    "ShearY": (shear_y, _shear_arg),
    "TranslateX": (translate_x_abs, _translate_abs_arg),
    "TranslateY": (translate_y_abs, _translate_abs_arg),
    "TranslateXRel": (translate_x_rel, _translate_rel_arg),
    "TranslateYRel": (translate_y_rel, _translate_rel_arg),
}

RAND_TRANSFORMS = [
    "AutoContrast", "Equalize", "Invert", "Rotate", "PosterizeTpu",
    "Solarize", "SolarizeAdd", "Color", "Contrast", "Brightness",
    "Sharpness", "ShearX", "ShearY", "TranslateXRel", "TranslateYRel",
]

RAND_TRANSFORMS_CMC = [
    "AutoContrast", "Identity", "Rotate", "Sharpness",
    "ShearX", "ShearY", "TranslateXRel", "TranslateYRel",
]

# reference `_RAND_CHOICE_WEIGHTS_0` (`rand_augment.py:346-363`)
RAND_CHOICE_WEIGHTS_0 = {
    "Rotate": 0.3, "ShearX": 0.2, "ShearY": 0.2,
    "TranslateXRel": 0.1, "TranslateYRel": 0.1,
    "Color": 0.025, "Sharpness": 0.025, "AutoContrast": 0.025,
    "Solarize": 0.005, "SolarizeAdd": 0.005, "Contrast": 0.005,
    "Brightness": 0.005, "Equalize": 0.005,
    "PosterizeTpu": 0.0, "Invert": 0.0,
}


@dataclass
class RandAugmentOp:
    """One op of the menu with its selection probability and magnitude
    (reference `AutoAugmentOp`, `rand_augment.py:281-310`)."""

    name: str
    prob: float = 0.5
    magnitude: float = 10.0
    magnitude_std: float = 0.0
    hparams: dict = field(default_factory=dict)

    def __call__(self, rng: np.random.Generator, img: np.ndarray,
                 label: Optional[np.ndarray] = None):
        """Apply to `img`; when `label` is given, geometric ops warp it with
        the same sampled affine (nearest, LABEL_FILL) and (img, label) is
        returned — keeping a label-as-pairing-oracle aligned with the pixels."""
        fn, level_fn = OPS[self.name]
        if rng.random() > self.prob:
            return img if label is None else (img, label)
        magnitude = self.magnitude
        if self.magnitude_std > 0:
            magnitude = rng.normal(magnitude, self.magnitude_std)
        magnitude = min(MAX_LEVEL, max(0.0, magnitude))
        args = level_fn(magnitude, rng, self.hparams) if level_fn else ()
        out = fn(img, *args)
        if label is None:
            return out
        if self.name in GEOMETRIC_COEFFS:
            label = _affine_nearest(
                label, GEOMETRIC_COEFFS[self.name](img.shape, *args))
        return out, label


@dataclass
class RandAugment:
    """Sample `num_layers` ops (weighted when weights given, then without
    replacement — reference `RandAugment.__call__`, `rand_augment.py:
    390-403`) and apply them in order.

    Call with (rng, img): HWC uint8 in, HWC uint8 out.
    """

    ops: Sequence[RandAugmentOp]
    num_layers: int = 2
    choice_weights: Optional[np.ndarray] = None

    def sample_ops(self, rng: np.random.Generator) -> List[RandAugmentOp]:
        idx = rng.choice(
            len(self.ops), self.num_layers,
            replace=self.choice_weights is None, p=self.choice_weights)
        return [self.ops[i] for i in idx]

    def __call__(self, rng: np.random.Generator, img: np.ndarray,
                 label: Optional[np.ndarray] = None):
        if label is None:
            for op in self.sample_ops(rng):
                img = op(rng, img)
            return img
        for op in self.sample_ops(rng):
            img, label = op(rng, img, label)
        return img, label


@dataclass
class ClipRandAugment:
    """RandAugment over a clip (T, H, W, C).

    `per_frame=False` (default): one op-sequence AND one set of op draws is
    sampled, then replayed identically on every frame (geometric and
    photometric consistency across time — the right default for the
    clip-contrastive pipeline). `per_frame=True` reproduces the reference
    `MapTransform` semantics (`augs.py:16-32`): independent draws per frame.

    When `label` is given (clip-consistent mode only), geometric ops warp it
    with the exact replayed affines so a label-based pairing oracle stays
    pixel-aligned with the augmented clip; out-of-frame label pixels become
    LABEL_FILL (=255, outside every class range, dropped by one-hot).
    """

    augment: RandAugment
    per_frame: bool = False

    def __call__(self, rng: np.random.Generator, clip: np.ndarray,
                 label: Optional[np.ndarray] = None):
        if self.per_frame:
            if label is not None:
                raise ValueError(
                    "per_frame=True draws independent geometry per frame; "
                    "no single warped label exists — use per_frame=False")
            return np.stack([self.augment(rng, f) for f in clip])
        seed = rng.integers(0, 2 ** 63 - 1)
        if label is None:
            return np.stack(
                [self.augment(np.random.default_rng(seed), f) for f in clip])
        # the replayed draws warp every frame identically, so the label is
        # warped once (with the first frame) and skipped for the rest
        f0, out_label = self.augment(np.random.default_rng(seed), clip[0],
                                     label)
        frames = [f0] + [self.augment(np.random.default_rng(seed), f)
                         for f in clip[1:]]
        return np.stack(frames), out_label


def rand_augment_ops(magnitude=10.0, magnitude_std=0.0, hparams=None,
                     transforms=None, prob=0.5):
    hparams = dict(hparams or {})
    return [RandAugmentOp(name, prob=prob, magnitude=magnitude,
                          magnitude_std=magnitude_std, hparams=hparams)
            for name in (transforms or RAND_TRANSFORMS)]


def rand_augment_transform(config_str: str, hparams=None,
                           use_cmc: bool = False) -> RandAugment:
    """Parse the timm config grammar (reference `rand_augment.py:405-448`):
    'rand-m9-n3-mstd0.5[-w0]' -> RandAugment."""
    magnitude, num_layers, weight_idx, magnitude_std = MAX_LEVEL, 2, None, 0.0
    config = config_str.split("-")
    if config[0] != "rand":
        raise ValueError(f"unsupported config: {config_str!r}")
    for c in config[1:]:
        cs = re.split(r"(\d.*)", c)
        if len(cs) < 2:
            continue
        key, val = cs[:2]
        if key == "mstd":
            magnitude_std = float(val)
        elif key == "m":
            magnitude = float(int(val))
        elif key == "n":
            num_layers = int(val)
        elif key == "w":
            weight_idx = int(val)
        else:
            raise ValueError(f"unknown RandAugment section {c!r}")
    transforms = RAND_TRANSFORMS_CMC if use_cmc else RAND_TRANSFORMS
    ops = rand_augment_ops(magnitude=magnitude, magnitude_std=magnitude_std,
                           hparams=hparams, transforms=transforms)
    weights = None
    if weight_idx is not None:
        if weight_idx != 0:
            raise ValueError("only weight set 0 exists")
        w = np.array([RAND_CHOICE_WEIGHTS_0[k] for k in transforms])
        weights = w / w.sum()
    return RandAugment(ops, num_layers, choice_weights=weights)
