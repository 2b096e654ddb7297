"""Specificity, TN / (TN + FP), on the stat-scores engine (counterpart of
``metrics_tpu/ops/classification/specificity.py``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.ops.classification.stat_scores import _reduce_stat_scores, _stat_scores_update
from metrics_tpu_torch.utils.checks import _check_avg_args
from metrics_tpu_torch.utils.enums import AverageMethod, MDMCAverageMethod


def _specificity_compute(
    tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor, average: Optional[str], mdmc_average: Optional[str]
) -> Tensor:
    numerator = tn
    denominator = tn + fp
    if average == AverageMethod.NONE and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        absent = (tp + fn + fp) == 0
        numerator = torch.where(absent, -1, numerator)
        denominator = torch.where(absent, -1, denominator)
    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != AverageMethod.WEIGHTED else denominator,
        average=average,
        mdmc_average=mdmc_average,
    )


def specificity(
    preds: Tensor,
    target: Tensor,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> Tensor:
    """Specificity = TN / (TN + FP).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.classification import specificity
        >>> preds = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> round(float(specificity(preds, target, average='macro', num_classes=3)), 4)
        0.6111
    """
    _check_avg_args(average, mdmc_average, num_classes, ignore_index)
    reduce = "macro" if average in ("weighted", "none", None) else average
    tp, fp, tn, fn = _stat_scores_update(
        preds, target, reduce=reduce, mdmc_reduce=mdmc_average, threshold=threshold,
        num_classes=num_classes, top_k=top_k, multiclass=multiclass, ignore_index=ignore_index,
    )
    return _specificity_compute(tp, fp, tn, fn, average, mdmc_average)
