"""Dice score, 2 TP / (2 TP + FP + FN), on the stat-scores engine
(counterpart of ``metrics_tpu/ops/classification/dice.py``)."""
from __future__ import annotations

import math
from typing import Optional

from torch import Tensor

from metrics_tpu_torch.ops.classification._ratio import mask_absent_and_reduce
from metrics_tpu_torch.ops.classification.stat_scores import _stat_scores_update
from metrics_tpu_torch.utils.checks import _check_avg_args
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _dice_compute(
    tp: Tensor,
    fp: Tensor,
    fn: Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
    zero_division: int = 0,
) -> Tensor:
    return mask_absent_and_reduce(
        2 * tp, 2 * tp + fp + fn, tp, fp, fn, average, mdmc_average,
        weights=None if average != "weighted" else tp + fn,
        zero_division=zero_division,
    )


def dice(
    preds: Tensor,
    target: Tensor,
    zero_division: int = 0,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = "global",
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> Tensor:
    """Dice = 2 TP / (2 TP + FP + FN).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.classification import dice
        >>> round(float(dice(torch.tensor([2, 0, 2, 1]), torch.tensor([1, 1, 2, 0]), average='micro')), 4)
        0.25
    """
    _check_avg_args(average, mdmc_average, num_classes, ignore_index)
    reduce = "macro" if average in ("weighted", "none", None) else average
    tp, fp, tn, fn = _stat_scores_update(
        preds, target, reduce=reduce, mdmc_reduce=mdmc_average, threshold=threshold,
        num_classes=num_classes, top_k=top_k, multiclass=multiclass, ignore_index=ignore_index,
    )
    return _dice_compute(tp, fp, fn, average, mdmc_average, zero_division)


def dice_score(
    preds: Tensor,
    target: Tensor,
    bg: bool = False,
    nan_score: float = 0.0,
    no_fg_score: float = 0.0,
    reduction: str = "elementwise_mean",
) -> Tensor:
    """Deprecated macro Dice over ``(N, C)`` scores, kept for the public API;
    a non-default ``no_fg_score`` or ``reduction`` falls back to its default
    with a warning.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.classification import dice_score
        >>> preds = torch.tensor([[0.1, 0.9], [0.8, 0.2]])
        >>> round(float(dice_score(preds, torch.tensor([1, 0]))), 4)
        1.0
    """
    rank_zero_warn(
        "The `dice_score` function was deprecated in v0.9 and will be removed in v0.10. Use `dice` function instead.",
        DeprecationWarning,
    )
    num_classes = preds.shape[1]
    if no_fg_score != 0.0:
        rank_zero_warn("Deprecated parameter. Switched to default `no_fg_score` = 0.0.")
    if reduction != "elementwise_mean":
        rank_zero_warn("Deprecated parameter. Switched to default `reduction` = elementwise_mean.")
    zero_division = math.floor(nan_score)
    if zero_division != nan_score:
        rank_zero_warn(f"Deprecated parameter. `nan_score` converted to integer {zero_division}.")
    return dice(
        preds,
        target,
        ignore_index=None if bg else 0,
        average="macro",
        num_classes=num_classes,
        zero_division=zero_division,
    )
