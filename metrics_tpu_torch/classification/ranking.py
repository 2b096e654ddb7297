"""Multilabel ranking modules: CoverageError, LabelRankingAveragePrecision
and LabelRankingLoss (counterpart of ``metrics_tpu/classification/ranking.py``).

Each keeps a float32 ``measure``, an int32 ``total`` and a float32
``sample_weight`` sum; a compute with weights reads that sum on the host
(``ops/classification/ranking.py``), so it runs eager.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.ops.classification.ranking import (
    _coverage_error_compute,
    _coverage_error_update,
    _label_ranking_average_precision_compute,
    _label_ranking_average_precision_update,
    _label_ranking_loss_compute,
    _label_ranking_loss_update,
)


class _RankingBase(Metric):
    is_differentiable = False
    full_state_update: bool = False
    _ckpt_aux_attrs = ("_has_weight",)
    _update_fn: Callable
    _compute_fn: Callable

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("measure", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("sample_weight", torch.tensor(0.0), dist_reduce_fx="sum")
        self._has_weight = False

    def update(self, preds: Tensor, target: Tensor, sample_weight: Optional[Tensor] = None) -> None:  # type: ignore[override]
        measure, total, weight = type(self)._update_fn(preds, target, sample_weight)
        self.measure = self.measure + measure
        self.total = self.total + total
        if weight is not None:
            self.sample_weight = self.sample_weight + weight
            self._has_weight = True

    def compute(self) -> Tensor:
        return type(self)._compute_fn(self.measure, self.total, self.sample_weight if self._has_weight else None)


class CoverageError(_RankingBase):
    """How far down the ranking one must go to cover all true labels.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import CoverageError
        >>> preds = torch.tensor([[0.75, 0.05, 0.35, 0.75, 0.05], [0.05, 0.75, 0.35, 0.05, 0.75]])
        >>> target = torch.tensor([[1, 0, 0, 0, 1], [0, 1, 0, 1, 0]])
        >>> metric = CoverageError(device="cpu")
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()), 4)
        5.0
    """

    higher_is_better = False
    _update_fn = _coverage_error_update
    _compute_fn = _coverage_error_compute


class LabelRankingAveragePrecision(_RankingBase):
    """Mean share of the labels ranked at or above each true label that are true.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import LabelRankingAveragePrecision
        >>> preds = torch.tensor([[0.75, 0.05, 0.35, 0.75, 0.05], [0.05, 0.75, 0.35, 0.05, 0.75]])
        >>> target = torch.tensor([[1, 0, 0, 0, 1], [0, 1, 0, 1, 0]])
        >>> metric = LabelRankingAveragePrecision(device="cpu")
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()), 4)
        0.45
    """

    higher_is_better = True
    _update_fn = _label_ranking_average_precision_update
    _compute_fn = _label_ranking_average_precision_compute


class LabelRankingLoss(_RankingBase):
    """Share of wrongly ordered label pairs, averaged over samples.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import LabelRankingLoss
        >>> preds = torch.tensor([[0.75, 0.05, 0.35, 0.75, 0.05], [0.05, 0.75, 0.35, 0.05, 0.75]])
        >>> target = torch.tensor([[1, 0, 0, 0, 1], [0, 1, 0, 1, 0]])
        >>> metric = LabelRankingLoss(device="cpu")
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()), 4)
        0.5
    """

    higher_is_better = False
    _update_fn = _label_ranking_loss_update
    _compute_fn = _label_ranking_loss_compute
