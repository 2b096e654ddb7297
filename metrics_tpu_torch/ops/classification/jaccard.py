"""Jaccard index, the IoU of a confusion matrix (counterpart of
``metrics_tpu/ops/classification/jaccard.py``).

``ignore_index`` zeroes that row of a copy of the matrix and cuts the class
out of the per-class scores and the weights; absent classes take
``absent_score`` by ``where``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.ops.classification.confusion_matrix import _confusion_matrix_update
from metrics_tpu_torch.utils.checks import _check_arg_choice


def _drop(x: Tensor, index: int) -> Tensor:
    return torch.cat([x[:index], x[index + 1:]])


def _jaccard_from_confmat(
    confmat: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
    absent_score: float = 0.0,
) -> Tensor:
    _check_arg_choice(average, "average", ("micro", "macro", "weighted", "none", None))
    ignored = ignore_index is not None and 0 <= ignore_index < num_classes

    if ignored:
        confmat = confmat.clone()
        confmat[ignore_index] = 0

    if average == "none" or average is None:
        intersection = torch.diagonal(confmat)
        union = confmat.sum(dim=0, dtype=confmat.dtype) + confmat.sum(dim=1, dtype=confmat.dtype) - intersection
        scores = intersection.to(torch.float32) / torch.where(union == 0, 1, union).to(torch.float32)
        scores = torch.where(union == 0, absent_score, scores)
        return _drop(scores, ignore_index) if ignored else scores

    if average == "macro":
        return _jaccard_from_confmat(confmat, num_classes, "none", ignore_index, absent_score).mean()

    if average == "micro":
        diag = torch.diagonal(confmat)
        intersection = diag.sum(dtype=confmat.dtype)
        union = (confmat.sum(dim=1, dtype=confmat.dtype) + confmat.sum(dim=0, dtype=confmat.dtype) - diag).sum(
            dtype=confmat.dtype
        )
        return intersection.to(torch.float32) / union.to(torch.float32)

    # weighted
    weights = confmat.sum(dim=1, dtype=confmat.dtype).to(torch.float32) / confmat.sum(dtype=confmat.dtype).to(
        torch.float32
    )
    scores = _jaccard_from_confmat(confmat, num_classes, "none", ignore_index, absent_score)
    if ignored:
        weights = _drop(weights, ignore_index)
    return (weights * scores).sum()


def jaccard_index(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
    absent_score: float = 0.0,
    threshold: float = 0.5,
) -> Tensor:
    """Intersection over union.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.classification import jaccard_index
        >>> round(float(jaccard_index(torch.tensor([0, 1, 0, 0]), torch.tensor([1, 1, 0, 0]), num_classes=2)), 4)
        0.5833
    """
    confmat = _confusion_matrix_update(preds, target, num_classes, threshold)
    return _jaccard_from_confmat(confmat, num_classes, average, ignore_index, absent_score)
