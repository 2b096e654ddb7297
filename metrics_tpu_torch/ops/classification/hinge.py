"""Hinge loss, binary and multiclass (counterpart of
``metrics_tpu/ops/classification/hinge.py``): Crammer-Singer or one-vs-all
margins by ``where`` over the one-hot target, optionally squared."""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _input_squeeze
from metrics_tpu_torch.utils.data import to_onehot
from metrics_tpu_torch.utils.enums import DataType, EnumStr


class MulticlassMode(EnumStr):
    CRAMMER_SINGER = "crammer-singer"
    ONE_VS_ALL = "one-vs-all"


def _check_shape_and_type_consistency_hinge(preds: Tensor, target: Tensor) -> DataType:
    if target.ndim > 1:
        raise ValueError(f"The `target` should be one dimensional, got `target` with shape={tuple(target.shape)}.")
    if preds.ndim == 1:
        if preds.shape != target.shape:
            raise ValueError(
                "The `preds` and `target` should have the same shape,"
                f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}."
            )
        mode = DataType.BINARY
    elif preds.ndim == 2:
        if preds.shape[0] != target.shape[0]:
            raise ValueError(
                "The `preds` and `target` should have the same shape in the first dimension,"
                f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}."
            )
        mode = DataType.MULTICLASS
    else:
        raise ValueError(f"The `preds` should be one or two dimensional, got `preds` with shape={tuple(preds.shape)}.")
    return mode


def _hinge_update(
    preds: Tensor,
    target: Tensor,
    squared: bool = False,
    multiclass_mode: Optional[Union[str, MulticlassMode]] = None,
) -> Tuple[Tensor, Tensor]:
    preds, target = _input_squeeze(preds, target)
    mode = _check_shape_and_type_consistency_hinge(preds, target)

    if mode == DataType.MULTICLASS:
        target_oh = to_onehot(target, max(2, preds.shape[1])).to(torch.bool)

    if mode == DataType.MULTICLASS and (multiclass_mode is None or multiclass_mode == MulticlassMode.CRAMMER_SINGER):
        margin_true = torch.where(target_oh, preds, 0.0).sum(dim=1)
        margin_other = torch.where(target_oh, -torch.inf, preds).amax(dim=1)
        margin = margin_true - margin_other
    elif mode == DataType.BINARY or multiclass_mode == MulticlassMode.ONE_VS_ALL:
        t = (target_oh if mode == DataType.MULTICLASS else target).to(torch.bool)
        margin = torch.where(t, preds, -preds)
    else:
        raise ValueError(
            "The `multiclass_mode` should be either None / 'crammer-singer' / MulticlassMode.CRAMMER_SINGER"
            f"(default) or 'one-vs-all' / MulticlassMode.ONE_VS_ALL, got {multiclass_mode}."
        )

    measures = (1 - margin).clamp(min=0)
    if squared:
        measures = measures**2
    total = torch.full((), target.shape[0], dtype=torch.int32, device=preds.device)
    return measures.sum(dim=0), total


def _hinge_compute(measure: Tensor, total: Tensor) -> Tensor:
    return measure / total


def hinge_loss(
    preds: Tensor,
    target: Tensor,
    squared: bool = False,
    multiclass_mode: Optional[Union[str, MulticlassMode]] = None,
) -> Tensor:
    """Mean hinge loss.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.classification import hinge_loss
        >>> round(float(hinge_loss(torch.tensor([-2.2, 2.4, 0.1]), torch.tensor([0, 1, 1]))), 4)
        0.3
    """
    measure, total = _hinge_update(preds, target, squared=squared, multiclass_mode=multiclass_mode)
    return _hinge_compute(measure, total)
