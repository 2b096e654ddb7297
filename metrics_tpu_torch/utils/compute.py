"""Numerically safe helpers (counterpart of ``metrics_tpu/utils/compute.py``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor


def safe_matmul(x: Tensor, y: Tensor) -> Tensor:
    """``x @ y``; half-precision inputs are multiplied with float32
    accumulation and cast back, as the JAX package's ``safe_matmul`` asks
    for ``preferred_element_type=float32``."""
    if x.dtype in (torch.float16, torch.bfloat16):
        return torch.matmul(x.to(torch.float32), y.to(torch.float32)).to(x.dtype)
    return torch.matmul(x, y)


def safe_xlogy(x: Tensor, y: Tensor) -> Tensor:
    """``x * log(y)`` with ``0 * log(anything) = 0``, as the JAX package
    defines it: ``where(x == 0, 0, x * log(where(x == 0, 1, y)))``.
    ``torch.xlogy`` differs where ``x == 0`` and ``y`` is NaN (NaN there)."""
    zero = x == 0
    y_safe = torch.where(zero, torch.ones_like(y), y)
    return torch.where(zero, torch.zeros_like(x * y), x * torch.log(y_safe))


def safe_divide(num: Tensor, denom: Tensor) -> Tensor:
    """``num / denom`` returning 0 where ``denom == 0`` (no NaN/Inf)."""
    zero = denom == 0
    denom_safe = torch.where(zero, torch.ones_like(denom), denom)
    quotient = num / denom_safe
    return torch.where(zero, torch.zeros_like(quotient), quotient)


def reduce(x: Tensor, reduction: Optional[str]) -> Tensor:
    """Elementwise reduce: ``"elementwise_mean"``, ``"sum"`` or ``"none"``/None."""
    if reduction == "elementwise_mean":
        return torch.mean(x)
    if reduction == "none" or reduction is None:
        return x
    if reduction == "sum":
        return torch.sum(x)
    raise ValueError("Reduction parameter unknown.")


def class_reduce(num: Tensor, denom: Tensor, weights: Tensor, class_reduction: Optional[str] = "none") -> Tensor:
    """Per-class fractions ``num / denom`` (NaN to 0) reduced ``micro``,
    ``macro``, ``weighted`` or ``none``."""
    valid_reduction = ("micro", "macro", "weighted", "none", None)
    fraction = torch.sum(num) / torch.sum(denom) if class_reduction == "micro" else num / denom
    fraction = torch.where(torch.isnan(fraction), torch.zeros((), dtype=fraction.dtype, device=fraction.device), fraction)
    if class_reduction == "micro":
        return fraction
    if class_reduction == "macro":
        return torch.mean(fraction)
    if class_reduction == "weighted":
        return torch.sum(fraction * (weights / torch.sum(weights)))
    if class_reduction == "none" or class_reduction is None:
        return fraction
    raise ValueError(f"Reduction parameter {class_reduction} unknown. Choose between one of these: {valid_reduction}")
