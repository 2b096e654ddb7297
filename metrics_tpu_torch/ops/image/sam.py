"""Spectral Angle Mapper (counterpart of ``metrics_tpu/ops/image/sam.py``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.ops.image.helper import _check_image_pair
from metrics_tpu_torch.utils.compute import reduce


def _sam_check_inputs(preds: Tensor, target: Tensor):
    return _check_image_pair(preds, target, min_channels=2)


def _sam_compute(preds: Tensor, target: Tensor, reduction: Optional[str] = "elementwise_mean") -> Tensor:
    dot_product = (preds * target).sum(dim=1)
    preds_norm = torch.linalg.vector_norm(preds, dim=1)
    target_norm = torch.linalg.vector_norm(target, dim=1)
    sam_score = torch.arccos(torch.clamp(dot_product / (preds_norm * target_norm), -1, 1))
    return reduce(sam_score, reduction)


def spectral_angle_mapper(preds: Tensor, target: Tensor, reduction: Optional[str] = "elementwise_mean") -> Tensor:
    """SAM, in radians.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import spectral_angle_mapper
        >>> preds = torch.tensor([[[[1.0]], [[0.0]]]])
        >>> target = torch.tensor([[[[0.0]], [[1.0]]]])
        >>> round(float(spectral_angle_mapper(preds, target)), 4)
        1.5708
    """
    preds, target = _sam_check_inputs(preds, target)
    return _sam_compute(preds, target, reduction)
