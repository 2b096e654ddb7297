"""Area under a curve by the trapezoidal rule (counterpart of
``metrics_tpu/ops/classification/auc.py``). The monotonicity check reads two
flags back: eager.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor


def _auc_update(x: Tensor, y: Tensor) -> Tuple[Tensor, Tensor]:
    if x.ndim > 1:
        x = x.squeeze()
    if y.ndim > 1:
        y = y.squeeze()
    if x.ndim > 1 or y.ndim > 1:
        raise ValueError(f"Expected both `x` and `y` tensor to be 1d, but got tensors with dimension {x.ndim} and {y.ndim}")
    if x.numel() != y.numel():
        raise ValueError(
            f"Expected the same number of elements in `x` and `y` tensor but received {x.numel()} and {y.numel()}"
        )
    return x, y


def _trapezoid(y: Tensor, x: Tensor) -> Tensor:
    """``jnp.trapezoid(y, x)``: ``0.5 * sum(diff(x) * (y[1:] + y[:-1]))``,
    integers promoted to float32 first."""
    if not x.is_floating_point():
        x = x.to(torch.float32)
    if not y.is_floating_point():
        y = y.to(torch.float32)
    dx = x[..., 1:] - x[..., :-1]
    return 0.5 * (dx * (y[..., 1:] + y[..., :-1])).sum(-1)


def _auc_compute_without_check(x: Tensor, y: Tensor, direction: float) -> Tensor:
    return _trapezoid(y, x) * direction


def _auc_compute(x: Tensor, y: Tensor, reorder: bool = False) -> Tensor:
    if reorder:
        x_idx = torch.argsort(x, stable=True)
        x, y = x[x_idx], y[x_idx]
    dx = x[1:] - x[:-1]
    if bool((dx < 0).any()):
        if bool((dx <= 0).all()):
            direction = -1.0
        else:
            raise ValueError("`x` must be monotonic (sorted ascending or descending); pass reorder=True to sort it first.")
    else:
        direction = 1.0
    return _auc_compute_without_check(x, y, direction)


def auc(x: Tensor, y: Tensor, reorder: bool = False) -> Tensor:
    """AUC by trapezoid.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.classification.auc import auc
        >>> round(float(auc(torch.tensor([0, 1, 2, 3]), torch.tensor([0, 1, 2, 2]), reorder=True)), 4)
        4.0
    """
    x, y = _auc_update(x, y)
    return _auc_compute(x, y, reorder=reorder)
