"""Elementwise-error regression functionals: MSE, MAE, MSLE, MAPE, SMAPE, WMAPE.

Counterpart of ``metrics_tpu/ops/regression/basic.py``. Each returns its
float32 sum and the observation count as a python int, which the classes add
into their int32 ``total``.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape

_EPS = 1.17e-06


def _as_float(x: Tensor) -> Tensor:
    return x if x.is_floating_point() else x.to(torch.float32)


def _mean_squared_error_update(preds: Tensor, target: Tensor, num_outputs: int = 1) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    if num_outputs == 1:
        preds = preds.reshape(-1)
        target = target.reshape(-1)
    diff = preds - target
    return torch.sum(diff * diff, dim=0), target.shape[0]


def _mean_squared_error_compute(sum_squared_error: Tensor, n_obs, squared: bool = True) -> Tensor:
    res = sum_squared_error / n_obs
    return res if squared else torch.sqrt(res)


def mean_squared_error(preds: Tensor, target: Tensor, squared: bool = True, num_outputs: int = 1) -> Tensor:
    """MSE (or RMSE with ``squared=False``).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import mean_squared_error
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(mean_squared_error(preds, target)), 4)
        0.375
    """
    sum_squared_error, n_obs = _mean_squared_error_update(preds, target, num_outputs)
    return _mean_squared_error_compute(sum_squared_error, n_obs, squared=squared)


def _mean_absolute_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    preds, target = _as_float(preds), _as_float(target)
    return torch.sum(torch.abs(preds - target)), target.numel()


def _mean_absolute_error_compute(sum_abs_error: Tensor, n_obs) -> Tensor:
    return sum_abs_error / n_obs


def mean_absolute_error(preds: Tensor, target: Tensor) -> Tensor:
    """MAE.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import mean_absolute_error
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(mean_absolute_error(preds, target)), 4)
        0.5
    """
    sum_abs_error, n_obs = _mean_absolute_error_update(preds, target)
    return _mean_absolute_error_compute(sum_abs_error, n_obs)


def _mean_squared_log_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    return torch.sum((torch.log1p(preds) - torch.log1p(target)) ** 2), target.numel()


def _mean_squared_log_error_compute(sum_squared_log_error: Tensor, n_obs) -> Tensor:
    return sum_squared_log_error / n_obs


def mean_squared_log_error(preds: Tensor, target: Tensor) -> Tensor:
    """MSLE.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import mean_squared_log_error
        >>> target = torch.tensor([2.5, 5.0, 4.0, 8.0])
        >>> preds = torch.tensor([3.0, 5.0, 2.5, 7.0])
        >>> round(float(mean_squared_log_error(preds, target)), 4)
        0.0397
    """
    sum_squared_log_error, n_obs = _mean_squared_log_error_update(preds, target)
    return _mean_squared_log_error_compute(sum_squared_log_error, n_obs)


def _mean_absolute_percentage_error_update(preds: Tensor, target: Tensor, epsilon: float = _EPS) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    abs_per_error = torch.abs(preds - target) / torch.clamp(torch.abs(target), min=epsilon)
    return torch.sum(abs_per_error), target.numel()


def _mean_absolute_percentage_error_compute(sum_abs_per_error: Tensor, num_obs) -> Tensor:
    return sum_abs_per_error / num_obs


def mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    """MAPE.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import mean_absolute_percentage_error
        >>> target = torch.tensor([1.0, 10.0, 1e6])
        >>> preds = torch.tensor([0.9, 15.0, 1.2e6])
        >>> round(float(mean_absolute_percentage_error(preds, target)), 4)
        0.2667
    """
    sum_abs_per_error, num_obs = _mean_absolute_percentage_error_update(preds, target)
    return _mean_absolute_percentage_error_compute(sum_abs_per_error, num_obs)


def _symmetric_mean_absolute_percentage_error_update(
    preds: Tensor, target: Tensor, epsilon: float = _EPS
) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    abs_per_error = torch.abs(preds - target) / torch.clamp(torch.abs(target) + torch.abs(preds), min=epsilon)
    return 2 * torch.sum(abs_per_error), target.numel()


def symmetric_mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    """SMAPE.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import symmetric_mean_absolute_percentage_error
        >>> preds = torch.tensor([0.0, 1.0, 2.0, 3.0])
        >>> target = torch.tensor([0.5, 1.0, 2.5, 3.0])
        >>> round(float(symmetric_mean_absolute_percentage_error(preds, target)), 4)
        0.5556
    """
    sum_abs_per_error, num_obs = _symmetric_mean_absolute_percentage_error_update(preds, target)
    return sum_abs_per_error / num_obs


def _weighted_mean_absolute_percentage_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    _check_same_shape(preds, target)
    preds = preds.reshape(-1)
    target = target.reshape(-1)
    return torch.sum(torch.abs(preds - target)), torch.sum(torch.abs(target))


def _weighted_mean_absolute_percentage_error_compute(
    sum_abs_error: Tensor, sum_scale: Tensor, epsilon: float = _EPS
) -> Tensor:
    return sum_abs_error / torch.clamp(sum_scale, min=epsilon)


def weighted_mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    """WMAPE.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import weighted_mean_absolute_percentage_error
        >>> preds = torch.tensor([0.0, 1.0, 2.0, 3.0])
        >>> target = torch.tensor([0.5, 1.0, 2.5, 3.0])
        >>> round(float(weighted_mean_absolute_percentage_error(preds, target)), 4)
        0.1429
    """
    sum_abs_error, sum_scale = _weighted_mean_absolute_percentage_error_update(preds, target)
    return _weighted_mean_absolute_percentage_error_compute(sum_abs_error, sum_scale)
