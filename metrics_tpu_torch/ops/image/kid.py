"""Polynomial-kernel MMD for the Kernel Inception Distance (counterpart of
``metrics_tpu/ops/image/kid.py``). Every subset is one batch entry of a
batched matrix product, so the ``subsets`` MMDs are one program."""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor


def maximum_mean_discrepancy(k_xx: Tensor, k_xy: Tensor, k_yy: Tensor) -> Tensor:
    """Unbiased MMD from the three kernel matrices; a leading batch dim is kept."""
    m = k_xx.shape[-1]
    kt_xx_sum = k_xx.sum(dim=(-2, -1)) - k_xx.diagonal(dim1=-2, dim2=-1).sum(-1)
    kt_yy_sum = k_yy.sum(dim=(-2, -1)) - k_yy.diagonal(dim1=-2, dim2=-1).sum(-1)
    k_xy_sum = k_xy.sum(dim=(-2, -1))
    return (kt_xx_sum + kt_yy_sum) / (m * (m - 1)) - 2 * k_xy_sum / (m ** 2)


def poly_kernel(f1: Tensor, f2: Tensor, degree: int = 3, gamma: Optional[float] = None, coef: float = 1.0) -> Tensor:
    if gamma is None:
        gamma = 1.0 / f1.shape[-1]
    return (f1 @ f2.transpose(-2, -1) * gamma + coef) ** degree


def poly_mmd(
    f_real: Tensor, f_fake: Tensor, degree: int = 3, gamma: Optional[float] = None, coef: float = 1.0
) -> Tensor:
    k_11 = poly_kernel(f_real, f_real, degree, gamma, coef)
    k_22 = poly_kernel(f_fake, f_fake, degree, gamma, coef)
    k_12 = poly_kernel(f_real, f_fake, degree, gamma, coef)
    return maximum_mean_discrepancy(k_11, k_12, k_22)


def batched_poly_mmd(
    f_real_subsets: Tensor,  # (S, subset_size, D)
    f_fake_subsets: Tensor,  # (S, subset_size, D)
    degree: int = 3,
    gamma: Optional[float] = None,
    coef: float = 1.0,
) -> Tensor:
    """MMD per subset, (S,): batched matrix products over the subsets."""
    return poly_mmd(f_real_subsets, f_fake_subsets, degree, gamma, coef)
