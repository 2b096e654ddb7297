"""True/false positive/negative counting, the classification engine.

Counterpart of ``metrics_tpu/ops/classification/stat_scores.py``. Counts are
int32 as there: torch sums int32 into int64 unless told otherwise, so every
count sum here names ``dtype=torch.int32``.

The multiclass top-1 path (float ``(N, C)`` scores or ``(N,)`` labels
against ``(N,)`` labels) never builds the one-hot ``(N, C)`` operands: the
per-class counts are three int32 ``scatter_add_`` calls
(``_stat_scores_multiclass_counts``). Top-k, multilabel, mdmc and
``multiclass=False`` keep the broadcast formulation.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import (
    _check_arg_choice,
    _check_classification_inputs,
    _input_format_classification,
    _input_squeeze,
)
from metrics_tpu_torch.utils.data import argmax_first
from metrics_tpu_torch.utils.enums import AverageMethod, DataType, MDMCAverageMethod


def _del_column(data: Tensor, idx: int) -> Tensor:
    """Delete column ``idx``."""
    return torch.cat([data[:, :idx], data[:, (idx + 1):]], dim=1)


def _stat_scores(
    preds: Tensor,
    target: Tensor,
    reduce: Optional[str] = "micro",
    sample_mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Count tp/fp/tn/fn over binary ``(N, C)`` / ``(N, C, X)`` inputs.

    ``sample_mask`` (broadcastable to the inputs) zeroes ignored elements.

    Output shapes:
      (N, C) inputs: micro -> scalar, macro -> (C,), samples -> (N,)
      (N, C, X) inputs: micro -> (N,), macro -> (N, C), samples -> (N, X)
    """
    dim: Union[int, Tuple[int, ...]] = 1  # for "samples"
    if reduce == "micro":
        dim = (0, 1) if preds.ndim == 2 else (1, 2)
    elif reduce == "macro":
        dim = 0 if preds.ndim == 2 else 2

    true_pred, false_pred = target == preds, target != preds
    pos_pred, neg_pred = preds == 1, preds == 0

    def count(x: Tensor) -> Tensor:
        x = x.to(torch.int32)
        if sample_mask is not None:
            x = x * sample_mask.to(torch.int32)
        return x.sum(dim=dim, dtype=torch.int32)

    tp = count(true_pred & pos_pred)
    fp = count(false_pred & pos_pred)
    tn = count(true_pred & neg_pred)
    fn = count(false_pred & neg_pred)
    return tp, fp, tn, fn


def _scatter_count(index: Tensor, weight: Tensor, num_classes: int) -> Tensor:
    """int32 per-class sums of ``weight`` at ``index``.

    Indices behave as in ``jnp.zeros(C).at[index].add(weight, mode="drop")``:
    negative indices count from the end, indices outside ``[-C, C)`` are
    dropped (into a spare bin that is cut off).
    """
    index = torch.where(index < 0, index + num_classes, index)
    index = torch.where((index >= 0) & (index < num_classes), index, num_classes)
    out = torch.zeros(num_classes + 1, dtype=torch.int32, device=index.device)
    return out.scatter_add_(0, index, weight)[:num_classes]


def _stat_scores_multiclass_counts(
    pred_labels: Tensor,
    target_labels: Tensor,
    reduce: Optional[str],
    num_classes: int,
    row_mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """O(batch) scatter-add stat scores for multiclass top-1 label predictions.

    The same counts as one-hotting both sides and running ``_stat_scores``;
    the micro and samples reductions collapse to closed-form row counts.
    ``row_mask`` zeroes ignored rows' contributions.
    """
    t = target_labels.reshape(-1).to(torch.int64)
    p = pred_labels.reshape(-1).to(torch.int64)
    w = torch.ones_like(t, dtype=torch.int32) if row_mask is None else row_mask.reshape(-1).to(torch.int32)
    wc = w * (p == t).to(torch.int32)

    if reduce == "macro":
        tp = _scatter_count(t, wc, num_classes)
        pred_count = _scatter_count(p, w, num_classes)
        target_count = _scatter_count(t, w, num_classes)
        fp = pred_count - tp
        fn = target_count - tp
        tn = w.sum(dtype=torch.int32) - (tp + fp + fn)
        return tp, fp, tn, fn
    if reduce == "micro":
        tp = wc.sum(dtype=torch.int32)
        n_valid = w.sum(dtype=torch.int32)
        wrong = n_valid - tp
        tn = (num_classes - 2) * n_valid + tp
        return tp, wrong, tn, wrong
    # samples: per-row counts
    wrong = w - wc
    tn = (num_classes - 2) * w + wc
    return wc, wrong, tn, wrong


def _multiclass_fast_path_eligible(
    preds: Tensor,
    target: Tensor,
    reduce: Optional[str],
    top_k: Optional[int],
    multiclass: Optional[bool],
    ignore_index: Optional[int],
) -> bool:
    """Whether the scatter path applies: multiclass top-1 inputs whose
    canonical form is a plain (N, C) one-hot pair."""
    if preds.numel() == 0 or target.numel() == 0:
        return False
    if top_k not in (None, 1) or multiclass is False:
        return False
    if ignore_index is not None and reduce != "macro":
        return False  # the column-delete path needs the one-hot layout
    if target.is_floating_point() or target.ndim != 1:
        return False
    if preds.is_floating_point():
        return preds.ndim == 2 and preds.shape[1] >= 2
    return preds.ndim == 1


def _mark_ignored(stats: Tuple[Tensor, ...], ignore_index: int) -> Tuple[Tensor, ...]:
    """Set the ignored class's counts to the -1 sentinel (out of place)."""
    out = []
    for s in stats:
        s = s.clone()
        s[..., ignore_index] = -1
        out.append(s)
    return tuple(out)


def _stat_scores_update(
    preds: Tensor,
    target: Tensor,
    reduce: Optional[str] = "micro",
    mdmc_reduce: Optional[str] = None,
    num_classes: Optional[int] = None,
    top_k: Optional[int] = None,
    threshold: float = 0.5,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
    mode: Optional[DataType] = None,
    sample_mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Canonicalize inputs and count stats.

    ``sample_mask`` is an optional ``(N,)`` validity mask over input rows
    whose False rows contribute nothing to any count.
    """
    ext_mask = sample_mask
    internal_mask = None
    if ignore_index is not None and ignore_index < 0 and mode is not None:
        # negative ignore labels: flatten mdmc logits, then mask the ignored
        # rows instead of dropping them
        if mode == DataType.MULTIDIM_MULTICLASS and preds.is_floating_point():
            n_dims = preds.ndim
            nc = preds.shape[1]
            if ext_mask is not None:
                # expand the per-sample mask over the extra dims being flattened
                ext_mask = ext_mask.reshape(ext_mask.shape[0], *([1] * (target.ndim - 1))).expand(target.shape).reshape(-1)
            preds = preds.movedim(1, n_dims - 1).reshape(-1, nc)
            target = target.reshape(-1)
        if mode in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS):
            valid = target != ignore_index
            # broadcast over the canonical (N, C) / (N, C, X) layout
            internal_mask = valid.reshape(valid.shape[0], 1, -1) if target.ndim > 1 else valid.reshape(-1, 1)
            # negative labels one-hot to all-zero rows, so masked rows
            # contribute nothing
            target = torch.where(target == ignore_index, 0, target)
        ignore_index = None  # handled; skip the column path below

    preds, target = _input_squeeze(preds, target)
    if preds.dtype in (torch.float16, torch.bfloat16):
        preds = preds.to(torch.float32)

    if _multiclass_fast_path_eligible(preds, target, reduce, top_k, multiclass, ignore_index):
        # validation parity with the canonicalizer (which runs the same check)
        _check_classification_inputs(
            preds, target, threshold=threshold, num_classes=num_classes,
            multiclass=multiclass, top_k=top_k, ignore_index=ignore_index,
        )
        if preds.is_floating_point():
            n_cls = preds.shape[1]
            # top-1 with select_topk(p, 1)'s exact tie-breaking
            pred_labels = argmax_first(preds, dim=1)
        else:
            if not num_classes:
                num_classes = int(max(preds.max(), target.max())) + 1
            n_cls = max(2, int(num_classes))
            pred_labels = preds
        if ignore_index is not None and ignore_index >= n_cls:
            raise ValueError(f"`ignore_index` {ignore_index} is out of range for inputs with {n_cls} classes.")
        row_mask = None if internal_mask is None else internal_mask.reshape(-1).to(torch.int32)
        if ext_mask is not None:
            em = ext_mask.reshape(-1).to(torch.int32)
            row_mask = em if row_mask is None else row_mask * em
        stats = _stat_scores_multiclass_counts(pred_labels, target, reduce, n_cls, row_mask)
        if ignore_index is not None and reduce == "macro":
            stats = _mark_ignored(stats, ignore_index)
        return stats

    preds, target, _ = _input_format_classification(
        preds, target, threshold=threshold, num_classes=num_classes,
        multiclass=multiclass, top_k=top_k, ignore_index=ignore_index,
    )

    sample_mask = internal_mask
    if ext_mask is not None:
        # lift the (N,) row mask to the canonical layout and fold it in
        if preds.ndim == 3:
            em = ext_mask.reshape(-1, 1, 1).to(torch.int32).expand(preds.shape[0], 1, preds.shape[2])
        else:
            em = ext_mask.reshape(-1, 1).to(torch.int32)
        sample_mask = em if sample_mask is None else sample_mask.to(torch.int32) * em

    if ignore_index is not None and ignore_index >= preds.shape[1]:
        raise ValueError(f"`ignore_index` {ignore_index} is out of range for inputs with {preds.shape[1]} classes.")
    if ignore_index is not None and preds.shape[1] == 1:
        raise ValueError("`ignore_index` is not supported for binary (single-column) inputs.")

    if preds.ndim == 3:
        if not mdmc_reduce:
            raise ValueError(
                "Multi-dimensional multi-class inputs require `mdmc_reduce` to be set"
                " ('global' or 'samplewise')."
            )
        if mdmc_reduce == "global":
            preds = preds.transpose(1, 2).reshape(-1, preds.shape[1])
            target = target.transpose(1, 2).reshape(-1, target.shape[1])
            if sample_mask is not None and sample_mask.ndim == 3:
                sample_mask = sample_mask.transpose(1, 2).reshape(-1, 1)

    if ignore_index is not None and reduce != "macro":
        preds = _del_column(preds, ignore_index)
        target = _del_column(target, ignore_index)

    stats = _stat_scores(preds, target, reduce=reduce, sample_mask=sample_mask)

    if ignore_index is not None and reduce == "macro":
        stats = _mark_ignored(stats, ignore_index)
    return stats


def _stat_scores_compute(tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> Tensor:
    """Stack [tp, fp, tn, fn, support] along a trailing dim."""
    outputs = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)
    return torch.where(outputs < 0, -1, outputs)


def _reduce_stat_scores(
    numerator: Tensor,
    denominator: Tensor,
    weights: Optional[Tensor],
    average: Optional[str],
    mdmc_average: Optional[str],
    zero_division: int = 0,
) -> Tensor:
    """Reduce ``numerator/denominator`` scores with ignore/zero-div handling.

    Negative denominators mark ignored classes; zero denominators score
    ``zero_division``.
    """
    numerator, denominator = numerator.to(torch.float32), denominator.to(torch.float32)
    zero_div_mask = denominator == 0
    ignore_mask = denominator < 0

    weights = torch.ones_like(denominator) if weights is None else weights.to(torch.float32)
    numerator = torch.where(zero_div_mask, float(zero_division), numerator)
    denominator = torch.where(zero_div_mask | ignore_mask, 1.0, denominator)
    weights = torch.where(ignore_mask, 0.0, weights)

    if average not in (AverageMethod.MICRO, AverageMethod.NONE, None):
        weights = weights / weights.sum(dim=-1, keepdim=True)

    scores = weights * (numerator / denominator)
    scores = torch.where(torch.isnan(scores), float(zero_division), scores)

    if mdmc_average == MDMCAverageMethod.SAMPLEWISE:
        scores = scores.mean(dim=0)
        ignore_mask = ignore_mask.sum(dim=0).to(torch.bool)

    if average in (AverageMethod.NONE, None):
        return torch.where(ignore_mask, float("nan"), scores)
    return scores.sum()


def stat_scores(
    preds: Tensor,
    target: Tensor,
    reduce: str = "micro",
    mdmc_reduce: Optional[str] = None,
    num_classes: Optional[int] = None,
    top_k: Optional[int] = None,
    threshold: float = 0.5,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> Tensor:
    """Public stat-scores: tensor ``(..., 5)`` of [tp, fp, tn, fn, support].

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import stat_scores
        >>> preds = torch.tensor([1, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> stat_scores(preds, target, reduce='micro').tolist()  # [tp, fp, tn, fn, support]
        [2, 2, 6, 2, 4]
    """
    _check_arg_choice(reduce, "reduce", ("micro", "macro", "samples"))
    _check_arg_choice(mdmc_reduce, "mdmc_reduce", (None, "samplewise", "global"))
    if reduce == "macro" and (not num_classes or num_classes < 1):
        raise ValueError("reduce='macro' requires `num_classes` to be set to a positive integer.")
    if num_classes and ignore_index is not None and (not 0 <= ignore_index < num_classes or num_classes == 1):
        raise ValueError(
            f"`ignore_index` {ignore_index} is out of range for {num_classes} classes "
            "(needs 0 <= ignore_index < num_classes and num_classes > 1)."
        )

    tp, fp, tn, fn = _stat_scores_update(
        preds, target, reduce=reduce, mdmc_reduce=mdmc_reduce, top_k=top_k,
        threshold=threshold, num_classes=num_classes, multiclass=multiclass, ignore_index=ignore_index,
    )
    return _stat_scores_compute(tp, fp, tn, fn)
