"""AveragePrecision (counterpart of ``metrics_tpu/classification/avg_precision.py``):
the step-interpolated area under the exact PR curve."""
from __future__ import annotations

from typing import Any, List, Optional, Union

from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.ops.classification.average_precision import _average_precision_compute, _average_precision_update
from metrics_tpu_torch.utils.checks import _check_arg_choice
from metrics_tpu_torch.utils.data import append_cat, dim_zero_cat


class AveragePrecision(Metric):
    """Average precision over the exact PR curve.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import AveragePrecision
        >>> preds = torch.tensor([0.0, 0.1, 0.8, 0.4])
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> average_precision = AveragePrecision(pos_label=1, device="cpu")
        >>> average_precision.update(preds, target)
        >>> round(float(average_precision.compute()), 4)
        1.0
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update: bool = False
    _ckpt_aux_attrs = ("num_classes", "pos_label")

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
        average: Optional[str] = "macro",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.pos_label = pos_label
        _check_arg_choice(average, "average", ("micro", "macro", "weighted", "none", None))
        self.average = average

        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        preds, target, num_classes, pos_label = _average_precision_update(
            preds, target, self.num_classes, self.pos_label, self.average
        )
        self.preds = append_cat(self.preds, preds)
        self.target = append_cat(self.target, target)
        self.num_classes = num_classes
        self.pos_label = pos_label

    def compute(self) -> Union[Tensor, List[Tensor]]:
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _average_precision_compute(preds, target, self.num_classes, self.pos_label, self.average)
