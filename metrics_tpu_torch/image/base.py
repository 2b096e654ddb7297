"""Shared base for the list-state image metrics (counterpart of
``metrics_tpu/image/base.py``): ``preds``/``target`` batches kept in ``cat``
states (``CatBuffer``s under ``buffer_capacity=``), the math at compute."""
from __future__ import annotations

from typing import Any

from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.utils.data import append_cat, dim_zero_cat


class _ImagePairMetric(Metric):
    """Accumulates (preds, target) image batches in ``cat`` states."""

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def _append(self, preds: Tensor, target: Tensor) -> None:
        self.preds = append_cat(self.preds, preds)
        self.target = append_cat(self.target, target)

    def _cat_states(self):
        return dim_zero_cat(self.preds), dim_zero_cat(self.target)
