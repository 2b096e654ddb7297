"""Receiver operating characteristic (counterpart of
``metrics_tpu/ops/classification/roc.py``). Exact curves, eager like the
precision-recall curve they share ``_binary_clf_curve`` with; the check for
an empty side of the curve reads one value back per class.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.ops.classification.precision_recall_curve import (
    Curve,
    _binary_clf_curve,
    _precision_recall_curve_update,
)
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _roc_update(
    preds: Tensor, target: Tensor, num_classes: Optional[int] = None, pos_label: Optional[int] = None
) -> Tuple[Tensor, Tensor, int, Optional[int]]:
    return _precision_recall_curve_update(preds, target, num_classes, pos_label)


def _roc_compute_single_class(
    preds: Tensor,
    target: Tensor,
    pos_label: int,
    sample_weights: Optional[Sequence] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    fps, tps, thresholds = _binary_clf_curve(preds, target, sample_weights, pos_label)
    # curve starts at (0, 0)
    tps = torch.cat([torch.zeros(1, dtype=tps.dtype, device=tps.device), tps])
    fps = torch.cat([torch.zeros(1, dtype=fps.dtype, device=fps.device), fps])
    thresholds = torch.cat([thresholds[0][None] + 1, thresholds])

    if fps[-1] <= 0:
        rank_zero_warn(
            "No negative samples in targets, false positive value should be meaningless."
            " Returning zero tensor in false positive score",
            UserWarning,
        )
        fpr = torch.zeros_like(thresholds)
    else:
        fpr = fps / fps[-1]

    if tps[-1] <= 0:
        rank_zero_warn(
            "No positive samples in targets, true positive value should be meaningless."
            " Returning zero tensor in true positive score",
            UserWarning,
        )
        tpr = torch.zeros_like(thresholds)
    else:
        tpr = tps / tps[-1]
    return fpr, tpr, thresholds


def _roc_compute_multi_class(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    sample_weights: Optional[Sequence] = None,
) -> Tuple[List[Tensor], List[Tensor], List[Tensor]]:
    fpr, tpr, thresholds = [], [], []
    for cls in range(num_classes):
        if preds.shape == target.shape:
            target_cls = target[:, cls]
            pos_label = 1
        else:
            target_cls = target
            pos_label = cls
        res = roc(preds=preds[:, cls], target=target_cls, num_classes=1, pos_label=pos_label, sample_weights=sample_weights)
        fpr.append(res[0])
        tpr.append(res[1])
        thresholds.append(res[2])
    return fpr, tpr, thresholds


def _roc_compute(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
) -> Curve:
    if num_classes == 1 and preds.ndim == 1:
        if pos_label is None:
            pos_label = 1
        return _roc_compute_single_class(preds, target, pos_label, sample_weights)
    return _roc_compute_multi_class(preds, target, num_classes, sample_weights)


def roc(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
) -> Curve:
    """fpr/tpr/threshold curves.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.classification.roc import roc
        >>> preds = torch.tensor([0.0, 0.1, 0.8, 0.4])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> fpr, tpr, thresholds = roc(preds, target, pos_label=1)
        >>> [round(float(x), 4) for x in fpr]
        [0.0, 0.0, 0.5, 0.5, 1.0]
        >>> [round(float(x), 4) for x in tpr]
        [0.0, 0.5, 0.5, 1.0, 1.0]
    """
    preds, target, num_classes, pos_label = _roc_update(preds, target, num_classes, pos_label)
    return _roc_compute(preds, target, num_classes, pos_label, sample_weights)
