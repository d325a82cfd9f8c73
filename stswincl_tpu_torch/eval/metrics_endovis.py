"""EndoVis2018 evaluation metrics: the port's copy of
`stswincl_tpu/eval/metrics_endovis.py` (numpy only).

Protocol parity with `seg18/utils/EndoMetric.py:8-32` and the
aggregation loop in `seg18/test.py:140-207`: per frame, Dice/Jaccard are
computed for every class PRESENT in the ground truth except background (id
0); the frame score is the mean over those classes; frame scores are averaged
over the whole split, per sequence, and accumulated per class.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def dice_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    inter = float(np.logical_and(y_true, y_pred).sum())
    return (2 * inter + 1e-15) / (float(y_true.sum()) + float(y_pred.sum()) + 1e-15)


def jaccard_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    inter = float(np.logical_and(y_true, y_pred).sum())
    union = float(y_true.sum()) + float(y_pred.sum()) - inter
    return (inter + 1e-15) / (union + 1e-15)


def per_class_dice(y_true: np.ndarray, y_pred: np.ndarray) -> List[Tuple[int, float]]:
    """[(class_id, dice)] for every non-background class present in y_true."""
    out = []
    for cid in np.unique(y_true):
        if cid == 0:
            continue
        out.append((int(cid), dice_score(y_true == cid, y_pred == cid)))
    return out


def per_class_jaccard(y_true: np.ndarray, y_pred: np.ndarray) -> List[Tuple[int, float]]:
    out = []
    for cid in np.unique(y_true):
        if cid == 0:
            continue
        out.append((int(cid), jaccard_score(y_true == cid, y_pred == cid)))
    return out


class EndovisEvaluator:
    """Streaming evaluator reproducing `test.py`'s aggregation."""

    def __init__(self, num_classes: int = 12, num_sequences: int = 4):
        self.num_classes = num_classes
        self.num_sequences = num_sequences
        self.frame_dice_sum = 0.0
        self.frame_iou_sum = 0.0
        self.count = 0
        self.seq_dice = np.zeros(num_sequences)
        self.seq_iou = np.zeros(num_sequences)
        self.seq_count = np.zeros(num_sequences)
        self.class_dice = np.zeros(num_classes)
        self.class_iou = np.zeros(num_classes)
        self.class_count = np.zeros(num_classes)

    def update(self, y_true: np.ndarray, y_pred: np.ndarray, sequence_id: int):
        """Add one frame. `sequence_id` is 1-based (seq 1..4)."""
        dice = per_class_dice(y_true, y_pred)
        iou = per_class_jaccard(y_true, y_pred)
        for (cid, d), (_, j) in zip(dice, iou):
            self.class_dice[cid] += d
            self.class_iou[cid] += j
            self.class_count[cid] += 1
        frame_dice = float(np.mean([d for _, d in dice])) if dice else np.nan
        frame_iou = float(np.mean([j for _, j in iou])) if iou else np.nan
        self.frame_dice_sum += frame_dice
        self.frame_iou_sum += frame_iou
        self.count += 1
        s = sequence_id - 1
        self.seq_dice[s] += frame_dice
        self.seq_iou[s] += frame_iou
        self.seq_count[s] += 1

    def summary(self) -> Dict[str, object]:
        with np.errstate(invalid="ignore", divide="ignore"):
            return {
                "dice": self.frame_dice_sum / max(self.count, 1),
                "iou": self.frame_iou_sum / max(self.count, 1),
                "dice_per_seq": (self.seq_dice / np.maximum(self.seq_count, 1)).tolist(),
                "iou_per_seq": (self.seq_iou / np.maximum(self.seq_count, 1)).tolist(),
                "dice_per_class": np.divide(
                    self.class_dice, np.maximum(self.class_count, 1)).tolist(),
                "iou_per_class": np.divide(
                    self.class_iou, np.maximum(self.class_count, 1)).tolist(),
                "frames": self.count,
            }
