"""Evaluation of the port: the EndoVis18 metrics (`metrics_endovis`), the
CaDIS metrics (`metrics_cadis`) and the prediction dumps
(`visualization`), numpy copies of `stswincl_tpu/eval/`."""

from stswincl_tpu_torch.eval.metrics_cadis import (ConfusionMatrix,
                                                   mean_iou, pixel_accuracy,
                                                   pixel_accuracy_per_class,
                                                   segmentation_metrics)
from stswincl_tpu_torch.eval.metrics_endovis import (EndovisEvaluator,
                                                     dice_score,
                                                     jaccard_score,
                                                     per_class_dice,
                                                     per_class_jaccard)

__all__ = ["ConfusionMatrix", "EndovisEvaluator", "dice_score",
           "jaccard_score", "mean_iou", "per_class_dice", "per_class_jaccard",
           "pixel_accuracy", "pixel_accuracy_per_class",
           "segmentation_metrics"]
