"""Accuracy, including subset accuracy and top-k (counterpart of
``metrics_tpu/ops/classification/accuracy.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.ops.classification.stat_scores import _reduce_stat_scores, _stat_scores_update
from metrics_tpu_torch.utils.checks import (
    _check_avg_args,
    _check_classification_inputs,
    _check_positive_int,
    _input_format_classification,
    _input_squeeze,
)
from metrics_tpu_torch.utils.enums import AverageMethod, DataType, MDMCAverageMethod


def _check_subset_validity(mode: DataType) -> bool:
    return mode in (DataType.MULTILABEL, DataType.MULTIDIM_MULTICLASS)


def _mode(
    preds: Tensor,
    target: Tensor,
    threshold: float,
    top_k: Optional[int],
    num_classes: Optional[int],
    multiclass: Optional[bool],
    ignore_index: Optional[int] = None,
) -> DataType:
    """Classify the input case."""
    return _check_classification_inputs(
        preds, target, threshold=threshold, top_k=top_k,
        num_classes=num_classes, multiclass=multiclass, ignore_index=ignore_index,
    )


def _accuracy_update(
    preds: Tensor,
    target: Tensor,
    reduce: Optional[str],
    mdmc_reduce: Optional[str],
    threshold: float,
    num_classes: Optional[int],
    top_k: Optional[int],
    multiclass: Optional[bool],
    ignore_index: Optional[int],
    mode: DataType,
    sample_mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    if mode == DataType.MULTILABEL and top_k:
        raise ValueError("The `top_k` parameter is not supported for multi-label accuracy.")
    preds, target = _input_squeeze(preds, target)
    return _stat_scores_update(
        preds, target, reduce=reduce, mdmc_reduce=mdmc_reduce, threshold=threshold,
        num_classes=num_classes, top_k=top_k, multiclass=multiclass,
        ignore_index=ignore_index, mode=mode, sample_mask=sample_mask,
    )


def _accuracy_compute(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
    mode: DataType,
) -> Tensor:
    simple_average = (AverageMethod.MICRO, AverageMethod.SAMPLES)
    if (mode == DataType.BINARY and average in simple_average) or mode == DataType.MULTILABEL:
        numerator = tp + tn
        denominator = tp + tn + fp + fn
    else:
        numerator = tp
        denominator = tp + fn

    if mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        if average in (AverageMethod.MACRO, AverageMethod.NONE, None):
            # absent classes (no tp/fp/fn) are excluded via the -1 sentinel
            absent = (tp + fp + fn) == 0
            numerator = torch.where(absent, -1, numerator)
            denominator = torch.where(absent, -1, denominator)

    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != AverageMethod.WEIGHTED else tp + fn,
        average=average,
        mdmc_average=mdmc_average,
    )


def _subset_accuracy_update(
    preds: Tensor,
    target: Tensor,
    threshold: float,
    top_k: Optional[int],
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    sample_mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Exact-match (subset) accuracy counts, int32.

    ``sample_mask`` (optional ``(N,)``) removes masked rows from both counts.
    """
    preds, target = _input_squeeze(preds, target)
    preds, target, mode = _input_format_classification(
        preds, target, threshold=threshold, top_k=top_k, ignore_index=ignore_index, num_classes=num_classes
    )
    if mode == DataType.MULTILABEL and top_k:
        raise ValueError("The `top_k` parameter is not supported for multi-label accuracy.")

    w = None if sample_mask is None else sample_mask.reshape(-1).to(torch.int32)
    i32 = torch.int32
    if mode == DataType.MULTILABEL:
        row_correct = (preds == target).all(dim=1).to(i32)
        correct = (row_correct if w is None else row_correct * w).sum(dtype=i32)
        total = torch.tensor(target.shape[0], dtype=i32, device=preds.device) if w is None else w.sum(dtype=i32)
    elif mode == DataType.MULTICLASS:
        hits = preds * target
        correct = (hits if w is None else hits * w[:, None]).sum(dtype=i32)
        total = (target if w is None else target * w[:, None]).sum(dtype=i32)
    elif mode == DataType.MULTIDIM_MULTICLASS:
        sample_correct = ((preds * target).sum(dim=(1, 2), dtype=i32) == target.shape[2]).to(i32)
        correct = (sample_correct if w is None else sample_correct * w).sum(dtype=i32)
        total = torch.tensor(target.shape[0], dtype=i32, device=preds.device) if w is None else w.sum(dtype=i32)
    else:
        correct = torch.tensor(0, dtype=i32, device=preds.device)
        total = torch.tensor(0, dtype=i32, device=preds.device)
    return correct, total


def _subset_accuracy_compute(correct: Tensor, total: Tensor) -> Tensor:
    return correct.to(torch.float32) / total


def accuracy(
    preds: Tensor,
    target: Tensor,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = "global",
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    subset_accuracy: bool = False,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> Tensor:
    """Accuracy over any classification input type.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import accuracy
        >>> round(float(accuracy(torch.tensor([0, 2, 1, 3]), torch.tensor([0, 1, 2, 3]))), 4)
        0.5
    """
    _check_avg_args(average, mdmc_average, num_classes, ignore_index)
    if top_k is not None:
        _check_positive_int(top_k, "top_k")

    preds, target = _input_squeeze(preds, target)
    mode = _mode(preds, target, threshold, top_k, num_classes, multiclass, ignore_index)
    reduce = "macro" if average in ("weighted", "none", None) else average

    if subset_accuracy and _check_subset_validity(mode):
        correct, total = _subset_accuracy_update(preds, target, threshold, top_k, ignore_index)
        return _subset_accuracy_compute(correct, total)
    tp, fp, tn, fn = _accuracy_update(
        preds, target, reduce, mdmc_average, threshold, num_classes, top_k, multiclass, ignore_index, mode
    )
    return _accuracy_compute(tp, fp, tn, fn, average, mdmc_average, mode)
