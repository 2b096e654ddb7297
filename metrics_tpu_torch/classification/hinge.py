"""HingeLoss (counterpart of ``metrics_tpu/classification/hinge.py``)."""
from __future__ import annotations

from typing import Any, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.ops.classification.hinge import MulticlassMode, _hinge_compute, _hinge_update


class HingeLoss(Metric):
    """Mean hinge loss over binary decision values or multiclass scores.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import HingeLoss
        >>> preds = torch.tensor([-2.2, 2.4, 0.1])
        >>> target = torch.tensor([0, 1, 1])
        >>> hinge = HingeLoss(device="cpu")
        >>> hinge.update(preds, target)
        >>> round(float(hinge.compute()), 4)
        0.3
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update: bool = False

    def __init__(
        self,
        squared: bool = False,
        multiclass_mode: Optional[Union[str, MulticlassMode]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.add_state("measure", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

        if multiclass_mode not in (None, MulticlassMode.CRAMMER_SINGER, MulticlassMode.ONE_VS_ALL):
            raise ValueError(
                "The `multiclass_mode` should be either None / 'crammer-singer' / MulticlassMode.CRAMMER_SINGER"
                f"(default) or 'one-vs-all' / MulticlassMode.ONE_VS_ALL, got {multiclass_mode}."
            )
        self.squared = squared
        self.multiclass_mode = multiclass_mode

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        measure, total = _hinge_update(preds, target, squared=self.squared, multiclass_mode=self.multiclass_mode)
        self.measure = measure + self.measure
        self.total = total + self.total

    def compute(self) -> Tensor:
        return _hinge_compute(self.measure, self.total)
