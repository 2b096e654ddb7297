"""Shared ratio-score reduction used by precision/recall (counterpart of
``metrics_tpu/ops/classification/_ratio.py``): absent classes get the ``-1``
sentinel of ``_reduce_stat_scores`` instead of a boolean filter."""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.ops.classification.stat_scores import _reduce_stat_scores
from metrics_tpu_torch.utils.enums import AverageMethod, MDMCAverageMethod


def mask_absent_and_reduce(
    numerator: Tensor,
    denominator: Tensor,
    tp: Tensor,
    fp: Tensor,
    fn: Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
    weights: Optional[Tensor] = None,
    zero_division: int = 0,
) -> Tensor:
    """Apply the absent-class sentinel then reduce."""
    if mdmc_average != MDMCAverageMethod.SAMPLEWISE and average in (
        AverageMethod.MACRO,
        AverageMethod.NONE,
        None,
    ):
        absent = (tp + fp + fn) == 0
        numerator = torch.where(absent, -1, numerator)
        denominator = torch.where(absent, -1, denominator)
    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=weights,
        average=average,
        mdmc_average=mdmc_average,
        zero_division=zero_division,
    )
