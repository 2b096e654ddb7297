"""Shared base of the mean-of-batch audio metrics (counterpart of
``metrics_tpu/audio/base.py``): a float32 ``sum_metric`` and an int32
``total``, both summed across ranks; compute is their ratio."""
from __future__ import annotations

from typing import Any

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric


class _MeanAudioMetric(Metric):
    """Accumulates per-sample metric values into (sum, count) states."""

    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_metric", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def _accumulate(self, values: Tensor) -> None:
        self.sum_metric = self.sum_metric + values.sum().to(self.sum_metric.dtype)
        self.total = self.total + values.numel()

    def compute(self) -> Tensor:
        return self.sum_metric / self.total
