"""HammingDistance (counterpart of ``metrics_tpu/classification/hamming.py``)."""
from __future__ import annotations

from typing import Any

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.ops.classification.hamming import _hamming_distance_compute, _hamming_distance_update


class HammingDistance(Metric):
    """Share of wrong labels.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import HammingDistance
        >>> target = torch.tensor([[0, 1], [1, 1]])
        >>> preds = torch.tensor([[0, 1], [0, 1]])
        >>> hamming = HammingDistance(device="cpu")
        >>> hamming.update(preds, target)
        >>> round(float(hamming.compute()), 4)
        0.25
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update: bool = False

    def __init__(self, threshold: float = 0.5, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.threshold = threshold
        self.add_state("correct", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        correct, total = _hamming_distance_update(preds, target, self.threshold)
        self.correct = self.correct + correct
        self.total = self.total + total

    def compute(self) -> Tensor:
        return _hamming_distance_compute(self.correct, self.total)
