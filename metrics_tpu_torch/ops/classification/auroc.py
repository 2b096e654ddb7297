"""Area under the ROC curve (counterpart of
``metrics_tpu/ops/classification/auroc.py``).

``_auroc_update`` depends on shapes only (capturable). ``_auroc_compute`` is
eager, with the JAX package's host reads kept: the per-class curves, the
weighted average's drop of unobserved classes (in numpy, with a warning per
class) and, for ``max_fpr``, the float32 search of the cut-off.
"""
from __future__ import annotations

import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.ops.classification.auc import _auc_compute_without_check
from metrics_tpu_torch.ops.classification.roc import roc
from metrics_tpu_torch.utils.checks import _input_format_classification
from metrics_tpu_torch.utils.data import bincount
from metrics_tpu_torch.utils.enums import AverageMethod, DataType


def _auroc_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, DataType]:
    _, _, mode = _input_format_classification(preds, target)
    if mode == DataType.MULTIDIM_MULTICLASS:
        n_classes = preds.shape[1]
        preds = preds.transpose(0, 1).reshape(n_classes, -1).T
        target = target.reshape(-1)
    if mode == DataType.MULTILABEL and preds.ndim > 2:
        n_classes = preds.shape[1]
        preds = preds.transpose(0, 1).reshape(n_classes, -1).T
        target = target.transpose(0, 1).reshape(n_classes, -1).T
    return preds, target, mode


def _auroc_compute(
    preds: Tensor,
    target: Tensor,
    mode: DataType,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    max_fpr: Optional[float] = None,
    sample_weights: Optional[Sequence] = None,
) -> Tensor:
    """Including the exclusion of unobserved classes and the McClish-corrected
    partial AUC."""
    average = AverageMethod.NONE if average is None else average  # None = per class
    if mode == DataType.BINARY:
        num_classes = 1

    if max_fpr is not None:
        if not isinstance(max_fpr, float) or not 0 < max_fpr <= 1:
            raise ValueError(f"`max_fpr` must be a float in (0, 1]; got {max_fpr}")
        if mode != DataType.BINARY:
            raise ValueError(
                "Partial AUC (`max_fpr`) is only defined for binary inputs; leave it as"
                f" None for multiclass/multilabel data (got {max_fpr})."
            )

    if mode == DataType.MULTILABEL:
        if average == AverageMethod.MICRO:
            fpr, tpr, _ = roc(preds.reshape(-1), target.reshape(-1), 1, pos_label, sample_weights)
        elif num_classes:
            output = [
                roc(preds[:, i], target[:, i], num_classes=1, pos_label=1, sample_weights=sample_weights)
                for i in range(num_classes)
            ]
            fpr = [o[0] for o in output]
            tpr = [o[1] for o in output]
        else:
            raise ValueError("Multilabel input needs an explicit `num_classes` argument")
    else:
        if mode != DataType.BINARY:
            if num_classes is None:
                raise ValueError("Multiclass input needs an explicit `num_classes` argument")
            if average == AverageMethod.WEIGHTED and len(np.unique(target_host := target.cpu().numpy())) < num_classes:
                # exclude unobserved classes (their weight would be 0)
                target_bool_mat = np.zeros((len(target_host), num_classes), dtype=bool)
                target_bool_mat[np.arange(len(target_host)), target_host.astype(int)] = 1
                class_observed = target_bool_mat.sum(axis=0) > 0
                for c in range(num_classes):
                    if not class_observed[c]:
                        warnings.warn(f"Class {c} has no observations and is dropped from the AUROC average", UserWarning)
                preds = preds[:, torch.from_numpy(class_observed).to(preds.device)]
                target = torch.from_numpy(np.where(target_bool_mat[:, class_observed])[1]).to(target.device)
                num_classes = int(class_observed.sum())
                if num_classes == 1:
                    raise ValueError("Only one observed class remains; multiclass AUROC is undefined")
        fpr, tpr, _ = roc(preds, target, num_classes, pos_label, sample_weights)

    if max_fpr is None or max_fpr == 1:
        if mode == DataType.MULTILABEL and average == AverageMethod.MICRO:
            pass
        elif num_classes != 1:
            auc_scores = [_auc_compute_without_check(x, y, 1.0) for x, y in zip(fpr, tpr)]
            if average == AverageMethod.NONE:
                return torch.stack(auc_scores)
            if average == AverageMethod.MACRO:
                return torch.stack(auc_scores).mean()
            if average == AverageMethod.WEIGHTED:
                if mode == DataType.MULTILABEL:
                    support = target.sum(dim=0)
                else:
                    support = bincount(target.reshape(-1), minlength=num_classes)
                return (torch.stack(auc_scores) * support / support.sum()).sum()
            allowed_average = (AverageMethod.NONE.value, AverageMethod.MACRO.value, AverageMethod.WEIGHTED.value)
            raise ValueError(f"`average` must be one of {allowed_average}; got {average}")
        return _auc_compute_without_check(fpr, tpr, 1.0)

    max_area = torch.tensor(max_fpr, dtype=torch.float32, device=fpr.device)
    stop = int(torch.searchsorted(fpr, max_area, right=True))
    weight = (max_area - fpr[stop - 1]) / (fpr[stop] - fpr[stop - 1])
    interp_tpr = tpr[stop - 1] + weight * (tpr[stop] - tpr[stop - 1])
    tpr = torch.cat([tpr[:stop], interp_tpr.reshape(1)])
    fpr = torch.cat([fpr[:stop], max_area.reshape(1)])

    partial_auc = _auc_compute_without_check(fpr, tpr, 1.0)
    min_area = 0.5 * max_area**2
    return 0.5 * (1 + (partial_auc - min_area) / (max_area - min_area))


def auroc(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    max_fpr: Optional[float] = None,
    sample_weights: Optional[Sequence] = None,
) -> Tensor:
    """ROC-AUC.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.classification.auroc import auroc
        >>> preds = torch.tensor([0.13, 0.26, 0.08, 0.19, 0.34])
        >>> target = torch.tensor([0, 0, 1, 1, 1])
        >>> round(float(auroc(preds, target, pos_label=1)), 4)
        0.5
    """
    preds, target, mode = _auroc_update(preds, target)
    return _auroc_compute(preds, target, mode, num_classes, pos_label, average, max_fpr, sample_weights)
