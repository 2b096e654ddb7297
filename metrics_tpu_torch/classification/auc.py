"""AUC (counterpart of ``metrics_tpu/classification/auc.py``): the
trapezoidal area under the (x, y) pairs of every update."""
from __future__ import annotations

from typing import Any

from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.ops.classification.auc import _auc_compute, _auc_update
from metrics_tpu_torch.utils.data import append_cat, dim_zero_cat


class AUC(Metric):
    """Trapezoidal area under (x, y) pairs.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import AUC
        >>> auc = AUC(reorder=True, device="cpu")
        >>> auc.update(torch.tensor([0, 1, 2, 3]), torch.tensor([0, 1, 2, 2]))
        >>> round(float(auc.compute()), 4)
        4.0
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update: bool = False

    def __init__(self, reorder: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.reorder = reorder
        self.add_state("x", default=[], dist_reduce_fx="cat")
        self.add_state("y", default=[], dist_reduce_fx="cat")

    def update(self, x: Tensor, y: Tensor) -> None:  # type: ignore[override]
        x, y = _auc_update(x, y)
        self.x = append_cat(self.x, x)
        self.y = append_cat(self.y, y)

    def compute(self) -> Tensor:
        x = dim_zero_cat(self.x)
        y = dim_zero_cat(self.y)
        return _auc_compute(x, y, reorder=self.reorder)
