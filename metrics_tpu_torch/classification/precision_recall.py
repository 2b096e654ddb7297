"""Precision and Recall modules (counterpart of
``metrics_tpu/classification/precision_recall.py``). Both share the
StatScores compute group."""
from __future__ import annotations

from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.classification.stat_scores import StatScores
from metrics_tpu_torch.ops.classification.precision_recall import (
    _precision_compute,
    _recall_compute,
)
from metrics_tpu_torch.utils.checks import _check_arg_choice


class _PrecisionRecallBase(StatScores):
    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False

    def __init__(
        self,
        num_classes: Optional[int] = None,
        threshold: float = 0.5,
        average: Optional[str] = "micro",
        mdmc_average: Optional[str] = None,
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        multiclass: Optional[bool] = None,
        **kwargs: Any,
    ) -> None:
        _check_arg_choice(average, "average", ("micro", "macro", "weighted", "samples", "none", None))
        super().__init__(
            reduce="macro" if average in ("weighted", "none", None) else average,
            mdmc_reduce=mdmc_average,
            threshold=threshold,
            top_k=top_k,
            num_classes=num_classes,
            multiclass=multiclass,
            ignore_index=ignore_index,
            **kwargs,
        )
        self.average = average


class Precision(_PrecisionRecallBase):
    """TP / (TP + FP).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Precision
        >>> preds = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> precision = Precision(average="macro", num_classes=3, device="cpu")
        >>> precision.update(preds, target)
        >>> round(float(precision.compute()), 4)
        0.1667
    """

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._get_final_stats()
        return _precision_compute(tp, fp, fn, self.average, self.mdmc_reduce)

    def compute_sharded_state(self, state, group) -> Tensor:
        # only the macro layout shards (micro is scalar, samplewise is lists)
        return _precision_compute(state["tp"], state["fp"], state["fn"], self.average, self.mdmc_reduce, group)


class Recall(_PrecisionRecallBase):
    """TP / (TP + FN).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Recall
        >>> preds = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> recall = Recall(average="macro", num_classes=3, device="cpu")
        >>> recall.update(preds, target)
        >>> round(float(recall.compute()), 4)
        0.3333
    """

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._get_final_stats()
        return _recall_compute(tp, fp, fn, self.average, self.mdmc_reduce)

    def compute_sharded_state(self, state, group) -> Tensor:
        return _recall_compute(state["tp"], state["fp"], state["fn"], self.average, self.mdmc_reduce, group)
