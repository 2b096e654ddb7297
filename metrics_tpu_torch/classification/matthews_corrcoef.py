"""MatthewsCorrCoef (counterpart of ``metrics_tpu/classification/matthews_corrcoef.py``)."""
from __future__ import annotations

from typing import Any

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.ops.classification.matthews_corrcoef import (
    _matthews_corrcoef_compute,
    _matthews_corrcoef_update,
)


class MatthewsCorrCoef(Metric):
    """Matthews correlation coefficient.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MatthewsCorrCoef
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> matthews = MatthewsCorrCoef(num_classes=2, device="cpu")
        >>> matthews.update(preds, target)
        >>> round(float(matthews.compute()), 4)
        0.5774
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False

    def __init__(self, num_classes: int, threshold: float = 0.5, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.threshold = threshold
        self.add_state(
            "confmat", default=torch.zeros((num_classes, num_classes), dtype=torch.int32), dist_reduce_fx="sum",
            shard_axis=0,
        )

    def _update_signature(self):
        return ("confmat", self.num_classes, self.threshold, False)

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        confmat = _matthews_corrcoef_update(preds, target, self.num_classes, self.threshold)
        self.confmat = self.confmat + confmat

    def compute(self) -> Tensor:
        return _matthews_corrcoef_compute(self.confmat)

    def compute_sharded_state(self, state, group) -> Tensor:
        return _matthews_corrcoef_compute(state["confmat"], group)
