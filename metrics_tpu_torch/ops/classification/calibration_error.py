"""Top-label calibration error: ECE, MCE and RMSCE (counterpart of
``metrics_tpu/ops/classification/calibration_error.py``).

``_ce_update`` takes each sample's top-1 confidence and its correctness with
no read from the device: the logits check is a ``torch.where`` on
``any(preds outside [0, 1])``, so eager and captured updates agree. The
binning in ``_ce_compute`` sums with :func:`~metrics_tpu_torch.utils.data.bincount`,
deterministic on the card.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _input_format_classification
from metrics_tpu_torch.utils.data import bincount, linspace_thresholds
from metrics_tpu_torch.utils.enums import DataType


def _binning_bucketize(confidences: Tensor, accuracies: Tensor, bin_boundaries: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    n_bins = bin_boundaries.shape[0] - 1
    indices = (torch.searchsorted(bin_boundaries, confidences, right=False) - 1).clamp(0, n_bins - 1)
    count_bin = bincount(indices, minlength=n_bins).to(confidences.dtype)
    conf_bin = bincount(indices, minlength=n_bins, weights=confidences)
    acc_bin = bincount(indices, minlength=n_bins, weights=accuracies)
    safe = torch.where(count_bin == 0, 1.0, count_bin)
    conf_bin = torch.where(count_bin == 0, 0.0, conf_bin / safe)
    acc_bin = torch.where(count_bin == 0, 0.0, acc_bin / safe)
    prop_bin = count_bin / count_bin.sum()
    return acc_bin, conf_bin, prop_bin


def _ce_compute(
    confidences: Tensor,
    accuracies: Tensor,
    bin_boundaries: Tensor,
    norm: str = "l1",
    debias: bool = False,
) -> Tensor:
    if norm not in {"l1", "l2", "max"}:
        raise ValueError(f"Norm {norm} is not supported. Please select from l1, l2, or max. ")

    acc_bin, conf_bin, prop_bin = _binning_bucketize(confidences, accuracies, bin_boundaries)

    if norm == "l1":
        return ((acc_bin - conf_bin).abs() * prop_bin).sum()
    if norm == "max":
        return (acc_bin - conf_bin).abs().amax()
    # l2
    ce = ((acc_bin - conf_bin) ** 2 * prop_bin).sum()
    if debias:
        debias_bins = (acc_bin * (acc_bin - 1) * prop_bin) / (prop_bin * accuracies.shape[0] - 1)
        ce = ce + torch.nan_to_num(debias_bins).sum()
    return torch.where(ce > 0, torch.sqrt(torch.where(ce > 0, ce, 1.0)), 0.0)


def _normalize_if_logits(preds: Tensor, normalizer: Callable[[Tensor], Tensor]) -> Tensor:
    """Apply ``normalizer`` when any value falls outside [0, 1]: a select on
    the device, never a Python branch."""
    out_of_range = ((preds < 0) | (preds > 1)).any()
    return torch.where(out_of_range, normalizer(preds), preds)


def _ce_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Top-1 confidences and their correctness, float32."""
    _, _, mode = _input_format_classification(preds, target)

    if mode == DataType.BINARY:
        preds = _normalize_if_logits(preds, torch.sigmoid)
        confidences, accuracies = preds, target
    elif mode == DataType.MULTICLASS:
        preds = _normalize_if_logits(preds, lambda p: torch.softmax(p, dim=1))
        confidences = preds.amax(dim=1)
        predictions = torch.argmax(preds, dim=1)  # ties to the first index, as jnp.argmax
        accuracies = predictions == target
    elif mode == DataType.MULTIDIM_MULTICLASS:
        flat = preds.transpose(1, -1).reshape(-1, preds.shape[1])
        confidences = flat.amax(dim=1)
        predictions = torch.argmax(flat, dim=1)
        accuracies = predictions == target.reshape(-1)
    else:
        raise ValueError(f"Calibration error is not well-defined for data with size {preds.shape} and targets {target.shape}.")
    return confidences.to(torch.float32), accuracies.to(torch.float32)


def calibration_error(preds: Tensor, target: Tensor, n_bins: int = 15, norm: str = "l1") -> Tensor:
    """Top-label calibration error.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.classification.calibration_error import calibration_error
        >>> preds = torch.tensor([0.25, 0.35, 0.75, 0.95])
        >>> target = torch.tensor([0, 0, 1, 1])
        >>> round(float(calibration_error(preds, target, n_bins=3)), 4)
        0.225
    """
    if norm not in ("l1", "l2", "max"):
        raise ValueError(f"Norm {norm} is not supported. Please select from l1, l2, or max. ")
    if not isinstance(n_bins, int) or n_bins <= 0:
        raise ValueError(f"Expected argument `n_bins` to be a positive integer but got {n_bins}")
    confidences, accuracies = _ce_update(preds, target)
    bin_boundaries = linspace_thresholds(n_bins + 1).to(confidences.device)
    return _ce_compute(confidences, accuracies, bin_boundaries, norm=norm)
