"""Qualitative visualization: class-id masks -> RGB images. The port's
copy of `stswincl_tpu/eval/visualization.py` (numpy and PIL only).

Parity with the reference's viz paths: EndoVis `label2rgb` prediction dumps
(`seg18/test.py:44-57,162-169`, colors from the dataset's `labels.json`
table rather than the baked `cmap.npy` asset) and the CaDIS colormap +
remapped-colormap machinery (`segcata/utils/cadis_visualization.py:17-113`;
the 36-entry palette is the public CATARACTS-paper colormap). The
matplotlib figure plotting of the reference is replaced by plain RGB PNG
dumps (no display dependency).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
from PIL import Image

from stswincl_tpu_torch.data.cadis import _REMAPPINGS

# CATARACTS/CaDIS paper palette (`cadis_visualization.py:17-60`)
CADIS_COLORMAP = np.asarray([
    [0, 137, 255], [255, 165, 0], [255, 156, 201], [99, 0, 255],
    [255, 0, 0], [255, 0, 165], [255, 255, 255], [141, 141, 141],
    [255, 218, 0], [173, 156, 255], [73, 73, 73], [250, 213, 255],
    [255, 156, 156], [99, 255, 0], [157, 225, 255], [255, 89, 124],
    [173, 255, 156], [255, 60, 0], [40, 0, 255], [170, 124, 0],
    [188, 255, 0], [0, 207, 255], [0, 255, 207], [188, 0, 255],
    [243, 0, 255], [0, 203, 108], [252, 255, 0], [93, 182, 177],
    [0, 81, 203], [211, 183, 120], [231, 203, 0], [0, 124, 255],
    [10, 91, 44], [2, 0, 60], [0, 144, 2], [133, 59, 59],
], dtype=np.uint8)

# EndoVis18 challenge class colors (`seg18/test.py:44-57`; public challenge
# constants) — background, shaft, clasper, wrist, kidney-parenchyma,
# covered-kidney, thread, clamps, needle, suction, small-intestine, US probe
ENDOVIS_COLORMAP = np.asarray([
    [0, 0, 0], [0, 255, 0], [0, 255, 255], [125, 255, 12],
    [255, 55, 0], [24, 55, 125], [187, 155, 25], [0, 255, 125],
    [255, 255, 125], [123, 15, 175], [124, 155, 5], [12, 255, 141],
], dtype=np.uint8)


def label_to_rgb(mask: np.ndarray, colormap: np.ndarray) -> np.ndarray:
    """(H, W) int mask -> (H, W, 3) uint8 via a (C, 3) color table."""
    out = np.zeros(mask.shape + (3,), dtype=np.uint8)
    valid = (mask >= 0) & (mask < len(colormap))
    out[valid] = np.asarray(colormap, dtype=np.uint8)[mask[valid]]
    return out


def remapped_cadis_colormap(tag: str) -> Dict[int, np.ndarray]:
    """Per-remapped-class colors: each merged class takes its first source
    class's color, ignore is black (`cadis_visualization.py:86-100`)."""
    out = {}
    for target, sources in _REMAPPINGS[tag].items():
        if target == 255:
            out[target] = np.zeros(3, dtype=np.uint8)
        else:
            out[target] = CADIS_COLORMAP[sources[0]]
    return out


def cadis_mask_to_rgb(mask: np.ndarray, tag: str) -> np.ndarray:
    cmap = remapped_cadis_colormap(tag)
    out = np.zeros(mask.shape + (3,), dtype=np.uint8)
    for cid, color in cmap.items():
        out[mask == cid] = color
    return out


def save_prediction(path: str, mask: np.ndarray,
                    colormap: Optional[np.ndarray] = None,
                    cadis_tag: Optional[str] = None):
    """Dump one prediction as an RGB PNG (the reference's per-frame
    visualization dump, `test.py:162-169` / `cata_test.py:137-154`)."""
    if cadis_tag is not None:
        rgb = cadis_mask_to_rgb(mask, cadis_tag)
    else:
        if colormap is None:
            raise ValueError("save_prediction: a colormap or a cadis_tag")
        rgb = label_to_rgb(mask, colormap)
    Image.fromarray(rgb).save(path)
