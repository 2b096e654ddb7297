"""KL divergence D(P || Q) per row (counterpart of
``metrics_tpu/ops/classification/kl_divergence.py``); rows are normalized
first unless they are log-probabilities, and ``0 * log(0/q)`` is 0
(``utils.compute.safe_xlogy``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.compute import safe_xlogy


def _kld_update(p: Tensor, q: Tensor, log_prob: bool) -> Tuple[Tensor, int]:
    _check_same_shape(p, q)
    if p.ndim != 2 or q.ndim != 2:
        raise ValueError(f"Expected both p and q distribution to be 2D but got {p.ndim} and {q.ndim} respectively")

    total = p.shape[0]
    if log_prob:
        measures = (torch.exp(p) * (p - q)).sum(dim=-1)
    else:
        p = p / p.sum(dim=-1, keepdim=True)
        q = q / q.sum(dim=-1, keepdim=True)
        measures = safe_xlogy(p, p / q).sum(dim=-1)
    return measures, total


def _kld_compute(measures: Tensor, total, reduction: Optional[str] = "mean") -> Tensor:
    if reduction == "sum":
        return measures.sum()
    if reduction == "mean":
        return measures.sum() / total
    if reduction is None or reduction == "none":
        return measures
    return measures / total


def kl_divergence(p: Tensor, q: Tensor, log_prob: bool = False, reduction: Optional[str] = "mean") -> Tensor:
    """D_KL(P || Q).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.classification import kl_divergence
        >>> p = torch.tensor([[0.36, 0.48, 0.16]])
        >>> q = torch.tensor([[1 / 3, 1 / 3, 1 / 3]])
        >>> round(float(kl_divergence(p, q)), 4)
        0.0853
    """
    measures, total = _kld_update(p, q, log_prob)
    return _kld_compute(measures, total, reduction)
