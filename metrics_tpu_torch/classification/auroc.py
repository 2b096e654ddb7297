"""AUROC (counterpart of ``metrics_tpu/classification/auroc.py``).

The exact route only: ``cat`` states (lists, or captured ``CatBuffer``
states with ``buffer_capacity=N``) and an eager compute. The bounded
``approx="sketch"`` route needs the quantile sketches, which are not ported
yet (ROADMAP item A16), and raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.ops.classification.auroc import _auroc_compute, _auroc_update
from metrics_tpu_torch.utils.checks import _check_arg_choice
from metrics_tpu_torch.utils.data import append_cat, dim_zero_cat
from metrics_tpu_torch.utils.enums import DataType


class AUROC(Metric):
    """Area under the ROC curve.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import AUROC
        >>> preds = torch.tensor([0.13, 0.26, 0.08, 0.19, 0.34])
        >>> target = torch.tensor([0, 0, 1, 1, 1])
        >>> auroc = AUROC(pos_label=1, device="cpu")
        >>> auroc.update(preds, target)
        >>> round(float(auroc.compute()), 4)
        0.5
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
        average: Optional[str] = "macro",
        max_fpr: Optional[float] = None,
        approx: Optional[str] = None,
        num_buckets: int = 2048,
        relative_accuracy: float = 0.01,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.pos_label = pos_label
        self.average = average
        self.max_fpr = max_fpr
        _check_arg_choice(approx, "approx", (None, "sketch"))
        self.approx = approx
        if approx == "sketch":
            raise NotImplementedError(
                "AUROC(approx='sketch') needs QuantileSketch, which is not ported to metrics_tpu_torch yet "
                "(ROADMAP item A16); use the exact route (approx=None), with `buffer_capacity` for a captured update"
            )

        _check_arg_choice(self.average, "average", (None, "macro", "weighted", "micro"))
        if self.max_fpr is not None:
            if not isinstance(max_fpr, float) or not 0 < max_fpr <= 1:
                raise ValueError(f"`max_fpr` should be a float in range (0, 1], got: {max_fpr}")

        self.mode: Optional[DataType] = None
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        preds, target, mode = _auroc_update(preds, target)
        self.preds = append_cat(self.preds, preds)
        self.target = append_cat(self.target, target)
        if self.mode and self.mode != mode:
            raise ValueError(
                "The mode of data (binary, multi-label, multi-class) should be constant, but changed"
                f" between batches from {self.mode} to {mode}"
            )
        self.mode = mode

    def compute(self) -> Tensor:
        if not self.mode:
            raise RuntimeError("You have to have determined mode.")
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _auroc_compute(preds, target, self.mode, self.num_classes, self.pos_label, self.average, self.max_fpr)
