"""CohenKappa (counterpart of ``metrics_tpu/classification/cohen_kappa.py``)."""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.ops.classification.cohen_kappa import _cohen_kappa_compute, _cohen_kappa_update


class CohenKappa(Metric):
    """Cohen's kappa, unweighted or with linear or quadratic weights.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import CohenKappa
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> kappa = CohenKappa(num_classes=2, device="cpu")
        >>> kappa.update(preds, target)
        >>> round(float(kappa.compute()), 4)
        0.5
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False

    def __init__(
        self,
        num_classes: int,
        weights: Optional[str] = None,
        threshold: float = 0.5,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.weights = weights
        self.threshold = threshold

        allowed_weights = ("linear", "quadratic", "none", None)
        if self.weights not in allowed_weights:
            raise ValueError(f"Argument weights needs to one of the following: {allowed_weights}")

        self.add_state("confmat", default=torch.zeros((num_classes, num_classes), dtype=torch.int32), dist_reduce_fx="sum")

    def _update_signature(self):
        return ("confmat", self.num_classes, self.threshold, False)

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        confmat = _cohen_kappa_update(preds, target, self.num_classes, self.threshold)
        self.confmat = self.confmat + confmat

    def compute(self) -> Tensor:
        return _cohen_kappa_compute(self.confmat, None if self.weights == "none" else self.weights)
