"""Specificity (counterpart of ``metrics_tpu/classification/specificity.py``),
in the stat-scores compute group of Precision and Recall."""
from __future__ import annotations

from torch import Tensor

from metrics_tpu_torch.classification.precision_recall import _PrecisionRecallBase
from metrics_tpu_torch.ops.classification.specificity import _specificity_compute


class Specificity(_PrecisionRecallBase):
    """TN / (TN + FP).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Specificity
        >>> preds = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> specificity = Specificity(average="macro", num_classes=3, device="cpu")
        >>> specificity.update(preds, target)
        >>> round(float(specificity.compute()), 4)
        0.6111
    """

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._get_final_stats()
        return _specificity_compute(tp, fp, tn, fn, self.average, self.mdmc_reduce)
