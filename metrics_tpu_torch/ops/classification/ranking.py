"""Multilabel ranking metrics: coverage error, label ranking average
precision (LRAP) and label ranking loss (counterpart of
``metrics_tpu/ops/classification/ranking.py``).

LRAP ranks by one (N, L, L) comparison, not a per-sample loop; the ranking
loss masks rows with no or only relevant labels instead of dropping them.
Its double argsort is stable both times, as ``jnp.argsort`` is: an unstable
sort orders tied scores differently and changes the loss. A weighted compute
tests ``sample_weight != 0`` on the host, so it stays eager, as the JAX
trace of it fails.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor


def _rank_data(x: Tensor) -> Tensor:
    """Max-tie rank: rank(v) = #{u : u <= v}."""
    return (x[None, :] <= x[:, None]).sum(dim=1, dtype=torch.int32)


def _check_ranking_input(preds: Tensor, target: Tensor, sample_weight: Optional[Tensor] = None) -> None:
    if preds.ndim != 2 or target.ndim != 2:
        raise ValueError(
            f"Ranking metrics need 2-d `[N, C]` preds and target; got ndim {preds.ndim} and {target.ndim}."
        )
    if preds.shape != target.shape:
        raise ValueError(f"`preds` and `target` shapes differ: {tuple(preds.shape)} vs {tuple(target.shape)}.")
    if sample_weight is not None and (sample_weight.ndim != 1 or sample_weight.shape[0] != preds.shape[0]):
        raise ValueError(
            f"`sample_weight` must be 1-d with length N={preds.shape[0]}; got shape {tuple(sample_weight.shape)}."
        )


def _weighted_compute(measure: Tensor, n_elements, sample_weight: Optional[Tensor] = None) -> Tensor:
    if sample_weight is not None and sample_weight != 0.0:
        return measure / sample_weight
    return measure / n_elements


# --------------------------------------------------------------------------- #
# coverage error
# --------------------------------------------------------------------------- #
def _coverage_error_update(
    preds: Tensor, target: Tensor, sample_weight: Optional[Tensor] = None
) -> Tuple[Tensor, int, Optional[Tensor]]:
    _check_ranking_input(preds, target, sample_weight)
    offset = torch.where(target == 0, preds.min().abs() + 10, 0.0)
    preds_mod = preds + offset
    preds_min = preds_mod.amin(dim=1)
    coverage = (preds >= preds_min[:, None]).sum(dim=1, dtype=torch.int32).to(torch.float32)
    if isinstance(sample_weight, Tensor):
        coverage = coverage * sample_weight
        sample_weight = sample_weight.sum()
    return coverage.sum(), coverage.numel(), sample_weight


_coverage_error_compute = _weighted_compute


def coverage_error(preds: Tensor, target: Tensor, sample_weight: Optional[Tensor] = None) -> Tensor:
    """How deep in the ranking one must go to cover all true labels.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.classification import coverage_error
        >>> preds = torch.tensor([[0.75, 0.05, 0.35, 0.75, 0.05], [0.05, 0.75, 0.35, 0.05, 0.75]])
        >>> target = torch.tensor([[1, 0, 0, 0, 1], [0, 1, 0, 1, 0]])
        >>> round(float(coverage_error(preds, target)), 4)
        5.0
    """
    coverage, n_elements, sample_weight = _coverage_error_update(preds, target, sample_weight)
    return _coverage_error_compute(coverage, n_elements, sample_weight)


# --------------------------------------------------------------------------- #
# label ranking average precision
# --------------------------------------------------------------------------- #
def _label_ranking_average_precision_update(
    preds: Tensor, target: Tensor, sample_weight: Optional[Tensor] = None
) -> Tuple[Tensor, int, Optional[Tensor]]:
    _check_ranking_input(preds, target, sample_weight)
    neg_preds = -preds
    n_preds, n_labels = neg_preds.shape
    relevant = target == 1

    # cmp[i, c, c'] == (neg[i, c'] <= neg[i, c])
    cmp = neg_preds[:, None, :] <= neg_preds[:, :, None]
    rank_all = cmp.sum(dim=2, dtype=torch.int32).to(torch.float32)  # rank among all labels
    rank_rel = (cmp & relevant[:, None, :]).sum(dim=2, dtype=torch.int32).to(torch.float32)  # among relevant

    n_rel = relevant.sum(dim=1, dtype=torch.int32)
    per_label = torch.where(relevant, rank_rel / rank_all, 0.0)
    score_idx = per_label.sum(dim=1) / n_rel.clamp(min=1)
    # rows with no relevant label, or only relevant labels, score 1
    score_idx = torch.where((n_rel == 0) | (n_rel == n_labels), 1.0, score_idx)

    if sample_weight is not None:
        score_idx = score_idx * sample_weight
        return score_idx.sum(), n_preds, sample_weight.sum()
    return score_idx.sum(), n_preds, sample_weight


_label_ranking_average_precision_compute = _weighted_compute


def label_ranking_average_precision(preds: Tensor, target: Tensor, sample_weight: Optional[Tensor] = None) -> Tensor:
    """LRAP for multilabel data.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.classification import label_ranking_average_precision
        >>> preds = torch.tensor([[0.75, 0.05, 0.35, 0.75, 0.05], [0.05, 0.75, 0.35, 0.05, 0.75]])
        >>> target = torch.tensor([[1, 0, 0, 0, 1], [0, 1, 0, 1, 0]])
        >>> round(float(label_ranking_average_precision(preds, target)), 4)
        0.45
    """
    score, n_elements, sample_weight = _label_ranking_average_precision_update(preds, target, sample_weight)
    return _label_ranking_average_precision_compute(score, n_elements, sample_weight)


# --------------------------------------------------------------------------- #
# label ranking loss
# --------------------------------------------------------------------------- #
def _label_ranking_loss_update(
    preds: Tensor, target: Tensor, sample_weight: Optional[Tensor] = None
) -> Tuple[Tensor, int, Optional[Tensor]]:
    _check_ranking_input(preds, target, sample_weight)
    n_preds, n_labels = preds.shape
    relevant = target == 1
    n_relevant = relevant.sum(dim=1, dtype=torch.int32)

    valid = (n_relevant > 0) & (n_relevant < n_labels)

    inverse = torch.argsort(torch.argsort(preds, dim=1, stable=True), dim=1, stable=True).to(torch.int32)
    per_label_loss = ((n_labels - inverse) * relevant).to(torch.float32)
    correction = 0.5 * n_relevant * (n_relevant + 1)
    denom = n_relevant * (n_labels - n_relevant)
    loss = (per_label_loss.sum(dim=1) - correction) / torch.where(valid, denom, 1)
    loss = torch.where(valid, loss, 0.0)

    if isinstance(sample_weight, Tensor):
        loss = loss * torch.where(valid, sample_weight, 0.0)
        # the weights of all samples count, valid or not
        sample_weight = sample_weight.sum()
    return loss.sum(), n_preds, sample_weight


_label_ranking_loss_compute = _weighted_compute


def label_ranking_loss(preds: Tensor, target: Tensor, sample_weight: Optional[Tensor] = None) -> Tensor:
    """Average fraction of wrongly ordered label pairs.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.classification import label_ranking_loss
        >>> preds = torch.tensor([[0.75, 0.05, 0.35, 0.75, 0.05], [0.05, 0.75, 0.35, 0.05, 0.75]])
        >>> target = torch.tensor([[1, 0, 0, 0, 1], [0, 1, 0, 1, 0]])
        >>> round(float(label_ranking_loss(preds, target)), 4)
        0.5
    """
    loss, n_elements, sample_weight = _label_ranking_loss_update(preds, target, sample_weight)
    return _label_ranking_loss_compute(loss, n_elements, sample_weight)
