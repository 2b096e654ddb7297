"""Numerically safe helpers (counterpart of ``metrics_tpu/utils/compute.py``)."""
from __future__ import annotations

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
