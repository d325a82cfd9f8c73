"""CaDIS / CATARACTS-challenge segmentation metrics: the port's copy of
`stswincl_tpu/eval/metrics_cadis.py` (numpy only).

Protocol parity with `segcata/utils/cata_metrics.py:8-146`:
split-level confusion matrix over all frames; pixels whose ground-truth OR
predicted label falls outside [0, num_classes) are excluded (the ignore
label is remapped to >= num_classes upstream); PA, per-class PA, mIoU and
per-class IoU are derived from the matrix with NaN-mean over absent classes.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


class ConfusionMatrix:
    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.matrix = np.zeros((num_classes, num_classes), dtype=np.int64)

    def reset(self):
        self.matrix[:] = 0

    def update(self, gt_mask: np.ndarray, pred_mask: np.ndarray):
        if gt_mask.shape != pred_mask.shape:
            raise ValueError(f"label {gt_mask.shape} vs prediction "
                             f"{pred_mask.shape}")
        n = self.num_classes
        valid = (gt_mask >= 0) & (gt_mask < n) & (pred_mask >= 0) & (pred_mask < n)
        label = n * gt_mask[valid].astype(np.int64) + pred_mask[valid].astype(np.int64)
        self.matrix += np.bincount(label, minlength=n * n).reshape(n, n)


def pixel_accuracy(cm: np.ndarray) -> float:
    return float(np.diag(cm).sum() / cm.sum())


def pixel_accuracy_per_class(cm: np.ndarray) -> Tuple[float, np.ndarray]:
    with np.errstate(invalid="ignore", divide="ignore"):
        acc_c = np.diag(cm) / cm.sum(axis=1)
    return float(np.nanmean(acc_c)), acc_c


def mean_iou(cm: np.ndarray) -> Tuple[float, np.ndarray]:
    with np.errstate(invalid="ignore", divide="ignore"):
        iou_c = np.diag(cm) / (cm.sum(axis=1) + cm.sum(axis=0) - np.diag(cm))
    return float(np.nanmean(iou_c)), iou_c


def segmentation_metrics(
    gt_masks: List[np.ndarray], pred_masks: List[np.ndarray], num_classes: int
):
    """(pa, pac, pac_per_class, miou, miou_per_class) — reference
    `segmentation_metrics` (`cata_metrics.py:105-125`)."""
    if len(gt_masks) != len(pred_masks):
        raise ValueError(f"{len(gt_masks)} labels, {len(pred_masks)} "
                         "predictions")
    cm = ConfusionMatrix(num_classes)
    for gt, pred in zip(gt_masks, pred_masks):
        cm.update(gt, pred)
    pa = pixel_accuracy(cm.matrix)
    pac, pac_c = pixel_accuracy_per_class(cm.matrix)
    miou, miou_c = mean_iou(cm.matrix)
    return pa, pac, pac_c, miou, miou_c
