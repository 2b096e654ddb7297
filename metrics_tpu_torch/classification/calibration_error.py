"""CalibrationError (counterpart of ``metrics_tpu/classification/calibration_error.py``).

Its states are each sample's top-1 confidence and correctness, (N,) float32,
so a buffered update is captured; ``bin_boundaries`` is the JAX package's
``jnp.linspace`` grid bit for bit, and moves with :meth:`Metric.to`.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.ops.classification.calibration_error import _ce_compute, _ce_update
from metrics_tpu_torch.utils.data import append_cat, dim_zero_cat, linspace_thresholds


class CalibrationError(Metric):
    """Top-1 calibration error over binned confidences.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import CalibrationError
        >>> preds = torch.tensor([0.25, 0.35, 0.75, 0.95])
        >>> target = torch.tensor([0, 0, 1, 1])
        >>> metric = CalibrationError(n_bins=3, device="cpu")
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()), 4)
        0.225
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update: bool = False

    DISTANCES = {"l1", "l2", "max"}

    def __init__(self, n_bins: int = 15, norm: str = "l1", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if norm not in self.DISTANCES:
            raise ValueError(f"Norm {norm} is not supported. Please select from l1, l2, or max. ")
        if not isinstance(n_bins, int) or n_bins <= 0:
            raise ValueError(f"Expected argument `n_bins` to be a positive integer but got {n_bins}")
        self.n_bins = n_bins
        self.norm = norm
        self.bin_boundaries = linspace_thresholds(n_bins + 1).to(self.device)

        self.add_state("confidences", [], dist_reduce_fx="cat")
        self.add_state("accuracies", [], dist_reduce_fx="cat")

    def _move_attributes(self, device: torch.device) -> None:
        self.bin_boundaries = self.bin_boundaries.to(device)

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        confidences, accuracies = _ce_update(preds, target)
        self.confidences = append_cat(self.confidences, confidences)
        self.accuracies = append_cat(self.accuracies, accuracies)

    def compute(self) -> Tensor:
        confidences = dim_zero_cat(self.confidences)
        accuracies = dim_zero_cat(self.accuracies)
        return _ce_compute(confidences, accuracies, self.bin_boundaries, norm=self.norm)
