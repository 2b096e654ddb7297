"""Average precision, the area under the PR curve by step interpolation
(counterpart of ``metrics_tpu/ops/classification/average_precision.py``).

Per-class curves may come as a list of 1-D tensors (the exact curves) or as
one ``(C, K)`` tensor (the binned curves); the tensor form integrates every
class in one batched expression instead of a Python loop of tiny launches per
class. The macro average keeps the JAX package's NaN check, a host read.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.ops.classification.precision_recall_curve import (
    _precision_recall_curve_compute,
    _precision_recall_curve_update,
)
from metrics_tpu_torch.utils.data import bincount
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _average_precision_update(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
) -> Tuple[Tensor, Tensor, int, Optional[int]]:
    preds, target, num_classes, pos_label = _precision_recall_curve_update(preds, target, num_classes, pos_label)
    if average == "micro":
        if preds.ndim == target.ndim:
            preds = preds.reshape(-1)
            target = target.reshape(-1)
            num_classes = 1
        else:
            raise ValueError("Cannot use `micro` average with multi-class input")
    return preds, target, num_classes, pos_label


def _average_precision_compute(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    sample_weights: Optional[Sequence] = None,
) -> Union[List[Tensor], Tensor]:
    precision, recall, _ = _precision_recall_curve_compute(preds, target, num_classes, pos_label)
    if average == "weighted":
        if preds.ndim == target.ndim and target.ndim > 1:
            weights = target.sum(dim=0).to(torch.float32)
        else:
            weights = bincount(target, minlength=num_classes).to(torch.float32)
        weights = weights / weights.sum()
    else:
        weights = None
    return _average_precision_compute_with_precision_recall(precision, recall, num_classes, average, weights)


def _average_precision_compute_with_precision_recall(
    precision: Union[Tensor, List[Tensor]],
    recall: Union[Tensor, List[Tensor]],
    num_classes: int,
    average: Optional[str] = "macro",
    weights: Optional[Tensor] = None,
) -> Union[List[Tensor], Tensor]:
    """AP = -sum(dRecall * precision), per class along the last axis."""
    if num_classes == 1:
        return -((recall[1:] - recall[:-1]) * precision[:-1]).sum()

    if isinstance(precision, Tensor):
        res_t = -((recall[:, 1:] - recall[:, :-1]) * precision[:, :-1]).sum(dim=1)
    else:
        res_t = torch.stack([-((r[1:] - r[:-1]) * p[:-1]).sum() for p, r in zip(precision, recall)])

    if average == "macro":
        nan = torch.isnan(res_t)
        if bool(nan.any()):
            rank_zero_warn(
                "Average precision score for one or more classes was `nan`. Ignoring these classes in macro-average",
                UserWarning,
            )
        return res_t[~nan].mean()
    if average == "weighted":
        res_t = res_t * weights
        return res_t[~torch.isnan(res_t)].sum()
    if average in (None, "none", "micro"):
        return list(res_t)
    raise ValueError(f"Expected argument `average` to be one of ['macro', 'weighted', 'micro', None] but got {average}")


def average_precision(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    sample_weights: Optional[Sequence] = None,
) -> Union[List[Tensor], Tensor]:
    """Average precision score.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.classification.average_precision import average_precision
        >>> preds = torch.tensor([0.0, 0.1, 0.8, 0.4])
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> round(float(average_precision(preds, target, pos_label=1)), 4)
        1.0
    """
    preds, target, num_classes, pos_label = _average_precision_update(preds, target, num_classes, pos_label, average)
    return _average_precision_compute(preds, target, num_classes, pos_label, average, sample_weights)
