"""Numerically safe helpers (counterpart of ``metrics_tpu/utils/compute.py``)."""
from __future__ import annotations

import torch
from torch import Tensor


def safe_divide(num: Tensor, denom: Tensor) -> Tensor:
    """``num / denom`` returning 0 where ``denom == 0`` (no NaN/Inf)."""
    zero = denom == 0
    denom_safe = torch.where(zero, torch.ones_like(denom), denom)
    quotient = num / denom_safe
    return torch.where(zero, torch.zeros_like(quotient), quotient)
