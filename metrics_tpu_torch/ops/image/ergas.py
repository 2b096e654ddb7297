"""ERGAS, Erreur Relative Globale Adimensionnelle de Synthèse (counterpart of
``metrics_tpu/ops/image/ergas.py``)."""
from __future__ import annotations

from typing import Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.ops.image.helper import _check_image_pair
from metrics_tpu_torch.utils.compute import reduce


def _ergas_check_inputs(preds: Tensor, target: Tensor):
    return _check_image_pair(preds, target)


def _ergas_compute(
    preds: Tensor,
    target: Tensor,
    ratio: Union[int, float] = 4,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    b, c, h, w = preds.shape
    preds = preds.reshape(b, c, h * w)
    target = target.reshape(b, c, h * w)

    diff = preds - target
    sum_squared_error = torch.sum(diff * diff, dim=2)
    rmse_per_band = torch.sqrt(sum_squared_error / (h * w))
    mean_target = torch.mean(target, dim=2)

    ergas_score = 100 * ratio * torch.sqrt(torch.sum((rmse_per_band / mean_target) ** 2, dim=1) / c)
    return reduce(ergas_score, reduction)


def error_relative_global_dimensionless_synthesis(
    preds: Tensor,
    target: Tensor,
    ratio: Union[int, float] = 4,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """ERGAS.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import error_relative_global_dimensionless_synthesis
        >>> target = torch.ones(1, 1, 2, 2)
        >>> round(float(error_relative_global_dimensionless_synthesis(target * 1.1, target)), 4)
        40.0
    """
    preds, target = _ergas_check_inputs(preds, target)
    return _ergas_compute(preds, target, ratio, reduction)
