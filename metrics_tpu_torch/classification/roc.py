"""ROC (counterpart of ``metrics_tpu/classification/roc.py``): list or,
with ``buffer_capacity=N``, captured ``CatBuffer`` states; eager curves."""
from __future__ import annotations

from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.ops.classification.precision_recall_curve import Curve
from metrics_tpu_torch.ops.classification.roc import _roc_compute, _roc_update
from metrics_tpu_torch.utils.data import append_cat, dim_zero_cat


class ROC(Metric):
    """Receiver operating characteristic curve.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ROC
        >>> preds = torch.tensor([0.0, 0.1, 0.8, 0.4])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> roc = ROC(pos_label=1, device="cpu")
        >>> roc.update(preds, target)
        >>> fpr, tpr, thresholds = roc.compute()
        >>> [round(float(x), 4) for x in fpr]
        [0.0, 0.0, 0.5, 0.5, 1.0]
        >>> [round(float(x), 4) for x in tpr]
        [0.0, 0.5, 0.5, 1.0, 1.0]
        >>> [round(float(t), 4) for t in thresholds]
        [1.8, 0.8, 0.4, 0.1, 0.0]
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update: bool = False
    _ckpt_aux_attrs = ("num_classes", "pos_label")

    def __init__(self, num_classes: Optional[int] = None, pos_label: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.pos_label = pos_label
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        preds, target, num_classes, pos_label = _roc_update(preds, target, self.num_classes, self.pos_label)
        self.preds = append_cat(self.preds, preds)
        self.target = append_cat(self.target, target)
        self.num_classes = num_classes
        self.pos_label = pos_label

    def compute(self) -> Curve:
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _roc_compute(preds, target, self.num_classes, self.pos_label)
