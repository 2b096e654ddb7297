"""Precision and recall (counterpart of
``metrics_tpu/ops/classification/precision_recall.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

from torch import Tensor

from metrics_tpu_torch.ops.classification._ratio import mask_absent_and_reduce
from metrics_tpu_torch.ops.classification.stat_scores import _stat_scores_update
from metrics_tpu_torch.utils.checks import _check_avg_args


def _precision_compute(
    tp: Tensor, fp: Tensor, fn: Tensor, average: Optional[str], mdmc_average: Optional[str], group=None
) -> Tensor:
    return mask_absent_and_reduce(
        tp, tp + fp, tp, fp, fn, average, mdmc_average,
        weights=None if average != "weighted" else tp + fn, group=group,
    )


def _recall_compute(
    tp: Tensor, fp: Tensor, fn: Tensor, average: Optional[str], mdmc_average: Optional[str], group=None
) -> Tensor:
    return mask_absent_and_reduce(
        tp, tp + fn, tp, fp, fn, average, mdmc_average,
        weights=None if average != "weighted" else tp + fn, group=group,
    )


def _pr_update(preds, target, average, mdmc_average, ignore_index, num_classes, threshold, top_k, multiclass):
    _check_avg_args(average, mdmc_average, num_classes, ignore_index)
    reduce = "macro" if average in ("weighted", "none", None) else average
    return _stat_scores_update(
        preds, target, reduce=reduce, mdmc_reduce=mdmc_average, threshold=threshold,
        num_classes=num_classes, top_k=top_k, multiclass=multiclass, ignore_index=ignore_index,
    )


def precision(
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
    """Precision = TP / (TP + FP).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import precision
        >>> preds = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> round(float(precision(preds, target, average='macro', num_classes=3)), 4)
        0.1667
    """
    tp, fp, tn, fn = _pr_update(preds, target, average, mdmc_average, ignore_index, num_classes, threshold, top_k, multiclass)
    return _precision_compute(tp, fp, fn, average, mdmc_average)


def recall(
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
    """Recall = TP / (TP + FN).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import recall
        >>> preds = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> round(float(recall(preds, target, average='macro', num_classes=3)), 4)
        0.3333
    """
    tp, fp, tn, fn = _pr_update(preds, target, average, mdmc_average, ignore_index, num_classes, threshold, top_k, multiclass)
    return _recall_compute(tp, fp, fn, average, mdmc_average)


def precision_recall(
    preds: Tensor,
    target: Tensor,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> Tuple[Tensor, Tensor]:
    """Both from one stat-scores pass."""
    tp, fp, tn, fn = _pr_update(preds, target, average, mdmc_average, ignore_index, num_classes, threshold, top_k, multiclass)
    return (
        _precision_compute(tp, fp, fn, average, mdmc_average),
        _recall_compute(tp, fp, fn, average, mdmc_average),
    )
