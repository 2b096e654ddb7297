"""Confusion matrix, binary, multiclass and multilabel (counterpart of
``metrics_tpu/ops/classification/confusion_matrix.py``).

Labels become flat indices ``target * C + pred`` and one int32 ``bincount``
of static length ``C * C`` (``utils.data.bincount``; ``torch.bincount`` reads
the maximum back and grows with it, so no graph could hold it).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import (
    _capturing,
    _check_arg_choice,
    _check_classification_inputs,
    _input_format_classification,
    _input_squeeze,
)
from metrics_tpu_torch.utils.data import bincount
from metrics_tpu_torch.utils.enums import DataType
from metrics_tpu_torch.utils.exceptions import Uncapturable


def _label_pairs(preds: Tensor, target: Tensor, threshold: float, num_classes: int) -> Optional[Tuple[Tensor, Tensor]]:
    """``(preds, target)`` as the class indices the one-hot canonicalization
    and its argmax would give, when both are integer labels of one shape, or
    None. The round trip returns such labels unchanged, so it is skipped: its
    (N, C) one-hots of 2**20 pairs at 4,096 classes take 16 GiB each. The
    value checks still run (eager), and under a capture a label outside the
    one-hot's width becomes 0, the argmax of its all-zero row."""
    p, t = _input_squeeze(preds, target)
    if p.shape != t.shape or p.ndim == 0 or not (_is_label(p) and _is_label(t)):
        return None
    if _capturing():
        try:
            _check_classification_inputs(p, t, threshold=threshold, num_classes=num_classes, multiclass=None, top_k=None)
        except ValueError as err:
            raise Uncapturable(f"the input check with num_classes raised: {err}") from err
        width = max(2, num_classes)
        return tuple(torch.where((x >= 0) & (x < width), x, torch.zeros_like(x)) for x in (p, t))
    _check_classification_inputs(p, t, threshold=threshold, num_classes=None, multiclass=None, top_k=None)
    return p, t


def _is_label(x: Tensor) -> bool:
    return not (x.is_floating_point() or x.is_complex() or x.dtype == torch.bool)


def _confusion_matrix_update(
    preds: Tensor, target: Tensor, num_classes: int, threshold: float = 0.5, multilabel: bool = False
) -> Tensor:
    """Count pair occurrences into an un-normalized int32 confusion matrix."""
    labels = None if multilabel else _label_pairs(preds, target, threshold, num_classes)
    if labels is not None:
        unique_mapping = (labels[1].reshape(-1) * num_classes + labels[0].reshape(-1)).to(torch.int32)
        return bincount(unique_mapping, minlength=num_classes**2).reshape(num_classes, num_classes)
    # eager canonicalizes without num_classes, as the JAX package does, so
    # its binary/num_classes check does not fire (binary probabilities with
    # num_classes=2 are accepted); a captured step needs the static count for
    # the one-hot, where the JAX trace passes it and reverts when that raises
    if _capturing():
        try:
            preds, target, mode = _input_format_classification(preds, target, threshold, num_classes=num_classes)
        except ValueError as err:
            raise Uncapturable(f"the input check with num_classes raised: {err}") from err
    else:
        preds, target, mode = _input_format_classification(preds, target, threshold)
    if mode not in (DataType.BINARY, DataType.MULTILABEL):
        preds = preds.argmax(dim=1)
        target = target.argmax(dim=1)
    if multilabel:
        unique_mapping = ((2 * target + preds) + 4 * torch.arange(num_classes, device=preds.device)).reshape(-1)
        minlength = 4 * num_classes
    else:
        unique_mapping = (target.reshape(-1) * num_classes + preds.reshape(-1)).to(torch.int32)
        minlength = num_classes**2

    bins = bincount(unique_mapping, minlength=minlength)
    return bins.reshape(num_classes, 2, 2) if multilabel else bins.reshape(num_classes, num_classes)


def _confusion_matrix_compute(confmat: Tensor, normalize: Optional[str] = None, group=None) -> Tensor:
    """Optionally normalize over true labels, predictions or all; 0 where a
    row or column is empty. With a ``group`` the matrix is this rank's block
    of rows (the state sharded along the true-class axis, the sharded
    compute): ``"true"`` is block-local; ``"pred"``/``"all"`` divide by a
    ``psum`` of the partial sums; the block then gathers as a *result*, so
    nothing reshards. Bitwise equal to the replicated path for
    ``None``/``"true"``."""
    from metrics_tpu_torch.parallel import sync as _psync  # at call time: parallel imports core, core the metrics

    _check_arg_choice(normalize, "normalize", ("true", "pred", "all", "none", None))
    if normalize is not None and normalize != "none":
        confmat = confmat.to(torch.float32)
        if normalize == "true":
            confmat = confmat / confmat.sum(dim=1, keepdim=True)
        elif normalize == "pred":
            confmat = confmat / _psync.psum_result(confmat.sum(dim=0, keepdim=True), group)
        elif normalize == "all":
            confmat = confmat / _psync.psum_result(confmat.sum(), group)
        confmat = torch.where(torch.isnan(confmat), 0.0, confmat)
    return _psync.gather_result(confmat, group, axis=0)


def confusion_matrix(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    normalize: Optional[str] = None,
    threshold: float = 0.5,
    multilabel: bool = False,
) -> Tensor:
    """``(C, C)`` (or ``(C, 2, 2)`` multilabel) confusion matrix.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.classification import confusion_matrix
        >>> confusion_matrix(torch.tensor([0, 1, 0, 0]), torch.tensor([1, 1, 0, 0]), num_classes=2).tolist()
        [[2, 0], [1, 1]]
    """
    confmat = _confusion_matrix_update(preds, target, num_classes, threshold, multilabel)
    return _confusion_matrix_compute(confmat, normalize)
