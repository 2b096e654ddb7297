"""Moment-based regression functionals: Pearson, Spearman, R2, ExplainedVariance.

Counterpart of ``metrics_tpu/ops/regression/moments.py``: Pearson's running
moments merged one batch at a time, Spearman's mean-tie ranks through one
sort and two ``searchsorted`` (``rank = (left + right + 1) / 2``), R2 with
its ``adjusted`` correction and three ``multioutput`` modes, and explained
variance. R2's sample-count check and the ``adjusted`` fallback warnings read
the count back, so they run eager only; a captured step takes the same
fallback as a select, as the JAX package does under a trace.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _capturing, _check_same_shape
from metrics_tpu_torch.utils.prints import rank_zero_warn


# --------------------------------------------------------------------------- #
# pearson
# --------------------------------------------------------------------------- #
def _pearson_corrcoef_update(
    preds: Tensor,
    target: Tensor,
    mean_x: Tensor,
    mean_y: Tensor,
    var_x: Tensor,
    var_y: Tensor,
    corr_xy: Tensor,
    n_prior: Tensor,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """One merge step of the running moments (Welford style)."""
    _check_same_shape(preds, target)
    preds = torch.squeeze(preds)
    target = torch.squeeze(target)
    if preds.ndim > 1 or target.ndim > 1:
        raise ValueError("Expected both predictions and target to be 1 dimensional tensors.")

    n_obs = preds.numel()
    mx_new = (n_prior * mean_x + torch.mean(preds) * n_obs) / (n_prior + n_obs)
    my_new = (n_prior * mean_y + torch.mean(target) * n_obs) / (n_prior + n_obs)
    n_prior = n_prior + n_obs
    var_x = var_x + torch.sum((preds - mx_new) * (preds - mean_x))
    var_y = var_y + torch.sum((target - my_new) * (target - mean_y))
    corr_xy = corr_xy + torch.sum((preds - mx_new) * (target - mean_y))
    return mx_new, my_new, var_x, var_y, corr_xy, n_prior


def _pearson_corrcoef_compute(var_x: Tensor, var_y: Tensor, corr_xy: Tensor, nb: Tensor) -> Tensor:
    var_x = var_x / (nb - 1)
    var_y = var_y / (nb - 1)
    corr_xy = corr_xy / (nb - 1)
    corrcoef = torch.squeeze(corr_xy / torch.sqrt(var_x * var_y))
    return torch.clamp(corrcoef, -1.0, 1.0)


def pearson_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Pearson correlation.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import pearson_corrcoef
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(pearson_corrcoef(preds, target)), 4)
        0.9849
    """
    dtype = preds.dtype if preds.is_floating_point() else torch.float32
    zero = torch.zeros(1, dtype=dtype, device=preds.device)
    _, _, var_x, var_y, corr_xy, nb = _pearson_corrcoef_update(preds, target, zero, zero, zero, zero, zero, zero)
    return _pearson_corrcoef_compute(var_x, var_y, corr_xy, nb)


# --------------------------------------------------------------------------- #
# spearman
# --------------------------------------------------------------------------- #
def _rank_data(data: Tensor) -> Tensor:
    """Mean-tie rank (1-based): ``(left + right + 1) / 2`` through searchsorted."""
    sorted_data = torch.sort(data).values
    left = torch.searchsorted(sorted_data, data, side="left")
    right = torch.searchsorted(sorted_data, data, side="right")
    return (left + right + 1) / 2.0


def _spearman_corrcoef_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" Got preds: {preds.dtype} and target: {target.dtype}."
        )
    _check_same_shape(preds, target)
    preds = torch.squeeze(preds)
    target = torch.squeeze(target)
    if preds.ndim > 1 or target.ndim > 1:
        raise ValueError("Expected both predictions and target to be 1 dimensional tensors.")
    return preds, target


def _spearman_corrcoef_compute(preds: Tensor, target: Tensor, eps: float = 1e-6) -> Tensor:
    preds = _rank_data(preds)
    target = _rank_data(target)

    preds_diff = preds - torch.mean(preds)
    target_diff = target - torch.mean(target)

    cov = torch.mean(preds_diff * target_diff)
    preds_std = torch.sqrt(torch.mean(preds_diff * preds_diff))
    target_std = torch.sqrt(torch.mean(target_diff * target_diff))

    corrcoef = cov / (preds_std * target_std + eps)
    return torch.clamp(corrcoef, -1.0, 1.0)


def spearman_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Spearman rank correlation.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import spearman_corrcoef
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(spearman_corrcoef(preds, target)), 4)
        1.0
    """
    preds, target = _spearman_corrcoef_update(preds, target)
    return _spearman_corrcoef_compute(preds, target)


# --------------------------------------------------------------------------- #
# r2
# --------------------------------------------------------------------------- #
def _r2_score_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, Tensor, int]:
    _check_same_shape(preds, target)
    if preds.ndim > 2:
        raise ValueError(
            "Expected both prediction and target to be 1D or 2D tensors,"
            f" but received tensors with dimension {preds.shape}"
        )
    sum_obs = torch.sum(target, dim=0)
    sum_squared_obs = torch.sum(target * target, dim=0)
    residual = target - preds
    rss = torch.sum(residual * residual, dim=0)
    return sum_squared_obs, sum_obs, rss, target.shape[0]


def _r2_score_compute(
    sum_squared_obs: Tensor,
    sum_obs: Tensor,
    rss: Tensor,
    n_obs: Union[int, Tensor],
    adjusted: int = 0,
    multioutput: str = "uniform_average",
) -> Tensor:
    concrete = not _capturing()
    if concrete and int(n_obs) < 2:
        raise ValueError("Needs at least two samples to calculate r2 score.")

    mean_obs = sum_obs / n_obs
    tss = sum_squared_obs - sum_obs * mean_obs
    raw_scores = 1 - (rss / tss)

    if multioutput == "raw_values":
        r2 = raw_scores
    elif multioutput == "uniform_average":
        r2 = torch.mean(raw_scores)
    elif multioutput == "variance_weighted":
        tss_sum = torch.sum(tss)
        r2 = torch.sum(tss / tss_sum * raw_scores)
    else:
        raise ValueError(
            "Argument `multioutput` must be either `raw_values`,"
            f" `uniform_average` or `variance_weighted`. Received {multioutput}."
        )

    if adjusted < 0 or not isinstance(adjusted, int):
        raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")
    if adjusted != 0:
        if concrete or not isinstance(n_obs, Tensor):
            n = int(n_obs)
            if adjusted > n - 1:
                rank_zero_warn(
                    "More independent regressions than data points in adjusted r2 score. Falls back to standard r2 score.",
                    UserWarning,
                )
            elif adjusted == n - 1:
                rank_zero_warn("Division by zero in adjusted r2 score. Falls back to standard r2 score.", UserWarning)
            else:
                r2 = 1 - (1 - r2) * (n_obs - 1) / (n_obs - adjusted - 1)
        else:
            # a count on the device in a captured step: the same fallback, as a select
            valid = n_obs - adjusted - 1 > 0
            corrected = 1 - (1 - r2) * (n_obs - 1) / torch.where(valid, n_obs - adjusted - 1, 1)
            r2 = torch.where(valid, corrected, r2)
    return r2


def r2_score(preds: Tensor, target: Tensor, adjusted: int = 0, multioutput: str = "uniform_average") -> Tensor:
    """R².

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import r2_score
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(r2_score(preds, target)), 4)
        0.9486
    """
    sum_squared_obs, sum_obs, rss, n_obs = _r2_score_update(preds, target)
    return _r2_score_compute(sum_squared_obs, sum_obs, rss, n_obs, adjusted, multioutput)


# --------------------------------------------------------------------------- #
# explained variance
# --------------------------------------------------------------------------- #
def _explained_variance_update(preds: Tensor, target: Tensor) -> Tuple[int, Tensor, Tensor, Tensor, Tensor]:
    _check_same_shape(preds, target)
    n_obs = preds.shape[0]
    diff = target - preds
    sum_error = torch.sum(diff, dim=0)
    sum_squared_error = torch.sum(diff * diff, dim=0)
    sum_target = torch.sum(target, dim=0)
    sum_squared_target = torch.sum(target * target, dim=0)
    return n_obs, sum_error, sum_squared_error, sum_target, sum_squared_target


def _explained_variance_compute(
    n_obs: Union[int, Tensor],
    sum_error: Tensor,
    sum_squared_error: Tensor,
    sum_target: Tensor,
    sum_squared_target: Tensor,
    multioutput: str = "uniform_average",
) -> Tensor:
    diff_avg = sum_error / n_obs
    numerator = sum_squared_error / n_obs - diff_avg * diff_avg
    target_avg = sum_target / n_obs
    denominator = sum_squared_target / n_obs - target_avg * target_avg

    nonzero_numerator = numerator != 0
    nonzero_denominator = denominator != 0
    valid_score = nonzero_numerator & nonzero_denominator
    output_scores = torch.ones_like(diff_avg, dtype=torch.float32)
    safe_denom = torch.where(valid_score, denominator, 1.0)
    output_scores = torch.where(valid_score, 1.0 - numerator / safe_denom, output_scores)
    output_scores = torch.where(nonzero_numerator & ~nonzero_denominator, 0.0, output_scores)

    if multioutput == "raw_values":
        return output_scores
    if multioutput == "uniform_average":
        return torch.mean(output_scores)
    if multioutput == "variance_weighted":
        denom_sum = torch.sum(denominator)
        return torch.sum(denominator / denom_sum * output_scores)
    raise ValueError(f"Invalid input to multioutput. Received multioutput={multioutput}")


def explained_variance(preds: Tensor, target: Tensor, multioutput: str = "uniform_average") -> Tensor:
    """Explained variance.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import explained_variance
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(explained_variance(preds, target)), 4)
        0.9572
    """
    n_obs, sum_error, sum_squared_error, sum_target, sum_squared_target = _explained_variance_update(preds, target)
    return _explained_variance_compute(
        n_obs, sum_error, sum_squared_error, sum_target, sum_squared_target, multioutput
    )
