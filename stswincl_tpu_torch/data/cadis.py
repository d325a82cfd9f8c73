"""CaDIS tables: the video splits, class counts, normalisation and the
experiment remapping of `stswincl_tpu/data/cadis.py` (`:31-80`), copied so
that the port imports nothing of the JAX package
(`tests/test_torch_package.py` holds the copies equal). `CadisDataset` is
not ported yet (ROADMAP Queue 1).

The three granularity "experiments" (`segcata/utils/cadis_visualization.py:
160-318`, public CATARACTS-challenge tables): tag 1 -> 8 classes (every
instrument merged), tag 2 -> 17 classes + ignore, tag 3 -> 25 classes +
ignore; merged rare classes map to 255.
"""

from __future__ import annotations

import numpy as np

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
