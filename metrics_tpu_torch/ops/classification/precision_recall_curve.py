"""Precision-recall curve (counterpart of
``metrics_tpu/ops/classification/precision_recall_curve.py``).

Exact curves have one point per distinct score, a data-dependent length, so
the curve math is eager: it reads each class's last full-recall index back
to the host. The inputs' canonical form (``_precision_recall_curve_update``)
depends on shapes only, so a buffered update is captured.

The sort is a stable ascending argsort of ``-preds``, as in the JAX package:
``descending=True`` would order tied scores, and ``-0.0`` against ``0.0``,
otherwise. The cumulative sums are float32, as there, so counts below 2^24
are exact and every curve point is one IEEE division of exact integers.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.utils.prints import rank_zero_warn

Curve = Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]


def _binary_clf_curve(
    preds: Tensor,
    target: Tensor,
    sample_weights: Optional[Sequence] = None,
    pos_label: int = 1,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Cumulative fps/tps at each distinct score threshold (descending)."""
    if sample_weights is not None and not isinstance(sample_weights, Tensor):
        sample_weights = torch.as_tensor(sample_weights, dtype=torch.float32, device=preds.device)

    if preds.ndim > target.ndim:
        preds = preds[:, 0]
    desc_score_indices = torch.argsort(-preds, stable=True)

    preds = preds[desc_score_indices]
    target = target[desc_score_indices]

    weight = sample_weights[desc_score_indices] if sample_weights is not None else 1.0

    distinct_value_indices = torch.nonzero(preds[1:] - preds[:-1]).reshape(-1)
    threshold_idxs = torch.cat([distinct_value_indices, distinct_value_indices.new_full((1,), target.shape[0] - 1)])
    target = (target == pos_label).to(torch.int32)
    tps = torch.cumsum(target * weight, dim=0)[threshold_idxs]

    if sample_weights is not None:
        fps = torch.cumsum((1 - target) * weight, dim=0)[threshold_idxs]
    else:
        fps = 1 + threshold_idxs - tps
    return fps, tps, preds[threshold_idxs]


def _precision_recall_curve_update(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
) -> Tuple[Tensor, Tensor, int, Optional[int]]:
    """Canonicalize curve inputs (shapes only: capturable)."""
    if preds.ndim == target.ndim:
        if pos_label is None:
            pos_label = 1
        if num_classes is not None and num_classes != 1:
            # multilabel
            if num_classes != preds.shape[1]:
                raise ValueError(
                    f"Argument `num_classes` was set to {num_classes} in metric `precision_recall_curve`"
                    f" but detected {preds.shape[1]} number of classes from predictions"
                )
            preds = preds.transpose(0, 1).reshape(num_classes, -1).T
            target = target.transpose(0, 1).reshape(num_classes, -1).T
        else:
            preds = preds.reshape(-1)
            target = target.reshape(-1)
            num_classes = 1
    elif preds.ndim == target.ndim + 1:
        if pos_label is not None:
            rank_zero_warn(
                f"Argument `pos_label` should be `None` when running multiclass precision recall curve. Got {pos_label}"
            )
        if num_classes != preds.shape[1]:
            raise ValueError(
                f"Argument `num_classes` was set to {num_classes} in metric `precision_recall_curve`"
                f" but detected {preds.shape[1]} number of classes from predictions"
            )
        preds = preds.transpose(0, 1).reshape(num_classes, -1).T
        target = target.reshape(-1)
    else:
        raise ValueError("preds and target must have same number of dimensions, or one additional dimension for preds")
    return preds, target, num_classes, pos_label


def _precision_recall_curve_compute_single_class(
    preds: Tensor,
    target: Tensor,
    pos_label: int,
    sample_weights: Optional[Sequence] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Reversed outputs (recall decreasing) with the final (1, 0) point."""
    fps, tps, thresholds = _binary_clf_curve(preds, target, sample_weights, pos_label)
    precision = tps / (tps + fps)
    recall = tps / tps[-1]

    # stop when full recall attained; reverse so recall is decreasing
    last_ind = int(torch.nonzero(tps == tps[-1])[0][0])
    sl = slice(0, last_ind + 1)
    precision = torch.cat([precision[sl].flip(0), torch.ones(1, dtype=precision.dtype, device=precision.device)])
    recall = torch.cat([recall[sl].flip(0), torch.zeros(1, dtype=recall.dtype, device=recall.device)])
    thresholds = thresholds[sl].flip(0)
    return precision, recall, thresholds


def _precision_recall_curve_compute_multi_class(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    sample_weights: Optional[Sequence] = None,
) -> Tuple[List[Tensor], List[Tensor], List[Tensor]]:
    """Per-class one-vs-rest curves."""
    precision, recall, thresholds = [], [], []
    for cls in range(num_classes):
        res = precision_recall_curve(preds[:, cls], target, num_classes=1, pos_label=cls, sample_weights=sample_weights)
        precision.append(res[0])
        recall.append(res[1])
        thresholds.append(res[2])
    return precision, recall, thresholds


def _precision_recall_curve_compute(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
) -> Curve:
    if num_classes == 1:
        if pos_label is None:
            pos_label = 1
        return _precision_recall_curve_compute_single_class(preds, target, pos_label, sample_weights)
    return _precision_recall_curve_compute_multi_class(preds, target, num_classes, sample_weights)


def precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
) -> Curve:
    """Precision-recall pairs at all distinct thresholds.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.classification.precision_recall_curve import precision_recall_curve
        >>> preds = torch.tensor([0.0, 0.1, 0.8, 0.4])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> precision, recall, thresholds = precision_recall_curve(preds, target, pos_label=1)
        >>> [round(float(p), 4) for p in precision]
        [0.6667, 0.5, 1.0, 1.0]
        >>> [round(float(r), 4) for r in recall]
        [1.0, 0.5, 0.5, 0.0]
    """
    preds, target, num_classes, pos_label = _precision_recall_curve_update(preds, target, num_classes, pos_label)
    return _precision_recall_curve_compute(preds, target, num_classes, pos_label, sample_weights)
