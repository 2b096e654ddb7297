"""Cosine similarity and Tweedie deviance (counterpart of
``metrics_tpu/ops/regression/other.py``).

Tweedie's domain checks read the inputs back, so they run eager only, as the
JAX package runs them only on concrete arrays: a captured step
(``utils.checks._capturing``) skips them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _capturing, _check_same_shape
from metrics_tpu_torch.utils.compute import safe_xlogy


def _cosine_similarity_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    _check_same_shape(preds, target)
    return preds.to(torch.float32), target.to(torch.float32)


def _cosine_similarity_compute(preds: Tensor, target: Tensor, reduction: Optional[str] = "sum") -> Tensor:
    dot_product = torch.sum(preds * target, dim=-1)
    preds_norm = torch.linalg.vector_norm(preds, dim=-1)
    target_norm = torch.linalg.vector_norm(target, dim=-1)
    similarity = dot_product / (preds_norm * target_norm)
    reduction_mapping = {"sum": torch.sum, "mean": torch.mean, "none": lambda x: x, None: lambda x: x}
    return reduction_mapping[reduction](similarity)


def cosine_similarity(preds: Tensor, target: Tensor, reduction: Optional[str] = "sum") -> Tensor:
    """Row-wise cosine similarity, reduced over the rows.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import cosine_similarity
        >>> target = torch.tensor([[0.0, 1.0], [1.0, 1.0]])
        >>> preds = torch.tensor([[0.0, 1.0], [0.0, 1.0]])
        >>> round(float(cosine_similarity(preds, target, reduction='mean')), 4)
        0.8536
    """
    preds, target = _cosine_similarity_update(preds, target)
    return _cosine_similarity_compute(preds, target, reduction)


def _any(x: Tensor) -> bool:
    return bool(torch.any(x))


def _tweedie_deviance_score_update(preds: Tensor, targets: Tensor, power: float = 0.0) -> Tuple[Tensor, int]:
    """The summed deviance for ``power`` and the observation count; the
    domain checks of each branch run eager only."""
    _check_same_shape(preds, targets)
    if 0 < power < 1:
        raise ValueError(f"Deviance Score is not defined for power={power}.")

    concrete = not _capturing()
    if power == 0:
        deviance_score = (targets - preds) ** 2
    elif power == 1:
        if concrete and (_any(preds <= 0) or _any(targets < 0)):
            raise ValueError(f"For power={power}, 'preds' has to be strictly positive and 'targets' cannot be negative.")
        deviance_score = 2 * (safe_xlogy(targets, targets / preds) + preds - targets)
    elif power == 2:
        if concrete and (_any(preds <= 0) or _any(targets <= 0)):
            raise ValueError(f"For power={power}, both 'preds' and 'targets' have to be strictly positive.")
        deviance_score = 2 * (torch.log(preds / targets) + targets / preds - 1)
    else:
        if power < 0:
            if concrete and _any(preds <= 0):
                raise ValueError(f"For power={power}, 'preds' has to be strictly positive.")
        elif 1 < power < 2:
            if concrete and (_any(preds <= 0) or _any(targets < 0)):
                raise ValueError(f"For power={power}, 'targets' has to be strictly positive and 'preds' cannot be negative.")
        else:
            if concrete and (_any(preds <= 0) or _any(targets <= 0)):
                raise ValueError(f"For power={power}, both 'preds' and 'targets' have to be strictly positive.")
        term_1 = torch.clamp(targets, min=0.0) ** (2 - power) / ((1 - power) * (2 - power))
        term_2 = targets * preds ** (1 - power) / (1 - power)
        term_3 = preds ** (2 - power) / (2 - power)
        deviance_score = 2 * (term_1 - term_2 + term_3)

    return torch.sum(deviance_score), deviance_score.numel()


def _tweedie_deviance_score_compute(sum_deviance_score: Tensor, num_observations) -> Tensor:
    return sum_deviance_score / num_observations


def tweedie_deviance_score(preds: Tensor, targets: Tensor, power: float = 0.0) -> Tensor:
    """Mean Tweedie deviance for ``power``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import tweedie_deviance_score
        >>> preds = torch.tensor([1.0, 2.0, 3.0, 4.0])
        >>> target = torch.tensor([1.5, 2.5, 3.5, 4.5])
        >>> round(float(tweedie_deviance_score(preds, target, power=2)), 4)
        0.0706
    """
    sum_deviance_score, num_observations = _tweedie_deviance_score_update(preds, targets, power)
    return _tweedie_deviance_score_compute(sum_deviance_score, num_observations)
