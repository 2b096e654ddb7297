"""Peak Signal-to-Noise Ratio (counterpart of ``metrics_tpu/ops/image/psnr.py``)."""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.utils.compute import reduce
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _psnr_compute(
    sum_squared_error: Tensor,
    n_obs: Tensor,
    data_range: Tensor,
    base: float = 10.0,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    psnr_base_e = 2 * torch.log(data_range) - torch.log(sum_squared_error / n_obs)
    psnr_vals = psnr_base_e * (10 / np.log(base))
    return reduce(psnr_vals, reduction=reduction)


def _psnr_update(
    preds: Tensor,
    target: Tensor,
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> Tuple[Tensor, Tensor]:
    """Sum of squared errors and the int32 count of observations (per slice
    of the dims kept when ``dim`` is given)."""
    if dim is None:
        sum_squared_error = torch.sum((preds - target) ** 2)
        n_obs = torch.full((), target.numel(), dtype=torch.int32, device=target.device)
        return sum_squared_error, n_obs

    diff = preds - target
    dim_list = [dim] if isinstance(dim, int) else list(dim)
    # an empty dim reduces nothing, as jnp.sum(axis=()) (torch.sum(dim=[]) would sum everything)
    sum_squared_error = torch.sum(diff * diff, dim=dim_list) if dim_list else diff * diff
    if not dim_list:
        n_obs = torch.full((), target.numel(), dtype=torch.int32, device=target.device)
    else:
        count = int(np.prod([target.shape[d] for d in dim_list]))
        n_obs = torch.full(sum_squared_error.shape, count, dtype=torch.int32, device=target.device)
    return sum_squared_error, n_obs


def peak_signal_noise_ratio(
    preds: Tensor,
    target: Tensor,
    data_range: Optional[float] = None,
    base: float = 10.0,
    reduction: Optional[str] = "elementwise_mean",
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> Tensor:
    """PSNR.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import peak_signal_noise_ratio
        >>> preds = torch.tensor([[0.0, 1.0], [2.0, 3.0]])
        >>> target = torch.tensor([[3.0, 2.0], [1.0, 0.0]])
        >>> round(float(peak_signal_noise_ratio(preds, target)), 4)
        2.5527
    """
    if dim is None and reduction != "elementwise_mean":
        rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")
    if data_range is None:
        if dim is not None:
            raise ValueError("The `data_range` must be given when `dim` is not None.")
        data_range = target.max() - target.min()
    else:
        data_range = torch.full((), float(data_range), dtype=torch.float32, device=target.device)
    sum_squared_error, n_obs = _psnr_update(preds, target, dim=dim)
    return _psnr_compute(sum_squared_error, n_obs, data_range, base=base, reduction=reduction)
