"""Universal Image Quality Index (counterpart of ``metrics_tpu/ops/image/uqi.py``)."""
from __future__ import annotations

from typing import Optional, Sequence

from torch import Tensor

from metrics_tpu_torch.ops.image.helper import _check_image_pair, _gaussian_kernel_2d, _windowed_moments
from metrics_tpu_torch.utils.compute import reduce


def _uqi_check_inputs(preds: Tensor, target: Tensor):
    return _check_image_pair(preds, target)


def _uqi_map(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
) -> Tensor:
    """Per-pixel UQI map (B, C, H', W'), halo trimmed; shared with the
    spectral distortion index's pair matrix."""
    if len(kernel_size) != 2 or len(sigma) != 2:
        raise ValueError(
            "Expected `kernel_size` and `sigma` to have the length of two."
            f" Got kernel_size: {len(kernel_size)} and sigma: {len(sigma)}."
        )
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {list(kernel_size)}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {list(sigma)}.")

    channel = preds.shape[1]
    kernel = _gaussian_kernel_2d(channel, kernel_size, sigma, preds.dtype)
    pads = [(k - 1) // 2 for k in kernel_size]
    mu_pred, mu_target, sigma_pred_sq, sigma_target_sq, sigma_pred_target = _windowed_moments(
        preds, target, kernel, pads
    )
    mu_pred_sq = mu_pred ** 2
    mu_target_sq = mu_target ** 2
    mu_pred_target = mu_pred * mu_target
    del mu_pred, mu_target

    upper = 2 * sigma_pred_target
    lower = sigma_pred_sq + sigma_target_sq
    del sigma_pred_target, sigma_pred_sq, sigma_target_sq
    uqi_idx = ((2 * mu_pred_target) * upper) / ((mu_pred_sq + mu_target_sq) * lower)
    slc = (...,) + tuple(slice(p, -p if p else None) for p in pads)
    return uqi_idx[slc]


def _uqi_compute(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    return reduce(_uqi_map(preds, target, kernel_size, sigma), reduction)


def universal_image_quality_index(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """UQI.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import universal_image_quality_index
        >>> imgs = torch.linspace(0.0, 1.0, 2 * 1 * 16 * 16).reshape(2, 1, 16, 16)
        >>> round(float(universal_image_quality_index(imgs, imgs)), 4)
        1.0
    """
    preds, target = _uqi_check_inputs(preds, target)
    return _uqi_compute(preds, target, kernel_size, sigma, reduction)
