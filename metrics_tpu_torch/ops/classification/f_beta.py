"""F-beta and F1 scores (counterpart of ``metrics_tpu/ops/classification/f_beta.py``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.ops.classification.stat_scores import _reduce_stat_scores, _stat_scores_update
from metrics_tpu_torch.utils.checks import _check_avg_args
from metrics_tpu_torch.utils.compute import safe_divide
from metrics_tpu_torch.utils.enums import AverageMethod, MDMCAverageMethod


def _fbeta_compute(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    beta: float,
    ignore_index: Optional[int],
    average: Optional[str],
    mdmc_average: Optional[str],
) -> Tensor:
    """F-beta from stat scores; absent and ignored classes get -1 sentinels."""
    if average == AverageMethod.MICRO and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        mask = tp >= 0
        msum = lambda x: torch.where(mask, x, 0).sum(dtype=torch.int32).to(torch.float32)
        precision = safe_divide(msum(tp), msum(tp) + msum(fp))
        recall = safe_divide(msum(tp), msum(tp) + msum(fn))
    else:
        precision = safe_divide(tp.to(torch.float32), (tp + fp).to(torch.float32))
        recall = safe_divide(tp.to(torch.float32), (tp + fn).to(torch.float32))

    num = (1 + beta**2) * precision * recall
    denom = beta**2 * precision + recall
    denom = torch.where(denom == 0.0, 1.0, denom)

    if average not in (AverageMethod.MICRO, AverageMethod.SAMPLES):
        # absent classes (and the ignored class, already -1-marked in tp/fp/fn
        # for macro reduce) get the -1 sentinel
        if average == AverageMethod.NONE and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
            absent = ((tp + fn + fp) == 0) | ((tp + fp + fn) == -3)
            num = torch.where(absent, -1.0, num)
            denom = torch.where(absent, -1.0, denom)
        if ignore_index is not None:
            num, denom = num.clone(), denom.clone()
            if mdmc_average == MDMCAverageMethod.SAMPLEWISE:
                num[..., ignore_index] = -1.0
                denom[..., ignore_index] = -1.0
            else:
                num[ignore_index, ...] = -1.0
                denom[ignore_index, ...] = -1.0

    if average == AverageMethod.MACRO and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        cond = ((tp + fp + fn) == 0) | ((tp + fp + fn) == -3)
        num = torch.where(cond, -1.0, num)
        denom = torch.where(cond, -1.0, denom)

    return _reduce_stat_scores(
        numerator=num,
        denominator=denom,
        weights=None if average != AverageMethod.WEIGHTED else tp + fn,
        average=average,
        mdmc_average=mdmc_average,
    )


def fbeta_score(
    preds: Tensor,
    target: Tensor,
    beta: float = 1.0,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> Tensor:
    """F-beta over any classification input.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import fbeta_score
        >>> preds = torch.tensor([0, 2, 1, 0, 0, 1])
        >>> target = torch.tensor([0, 1, 2, 0, 1, 2])
        >>> round(float(fbeta_score(preds, target, num_classes=3, beta=0.5)), 4)
        0.3333
    """
    _check_avg_args(average, mdmc_average, num_classes, ignore_index)
    reduce = "macro" if average in ("weighted", "none", None) else average
    tp, fp, tn, fn = _stat_scores_update(
        preds, target, reduce=reduce, mdmc_reduce=mdmc_average, threshold=threshold,
        num_classes=num_classes, top_k=top_k, multiclass=multiclass, ignore_index=ignore_index,
    )
    return _fbeta_compute(tp, fp, tn, fn, beta, ignore_index, average, mdmc_average)


def f1_score(
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
    """F1 = F-beta with beta=1."""
    return fbeta_score(preds, target, 1.0, average, mdmc_average, ignore_index, num_classes, threshold, top_k, multiclass)
