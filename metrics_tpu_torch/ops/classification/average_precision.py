"""Average precision from a precision-recall curve (counterpart of
``_average_precision_compute_with_precision_recall`` in
``metrics_tpu/ops/classification/average_precision.py``).

Per-class curves may come as a list of 1-D tensors or as one ``(C, K)``
tensor; the tensor form integrates every class in one batched expression
instead of a Python loop of tiny launches per class.
"""
from __future__ import annotations

from typing import List, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.utils.prints import rank_zero_warn


def _average_precision_compute_with_precision_recall(
    precision: Union[Tensor, List[Tensor]],
    recall: Union[Tensor, List[Tensor]],
    num_classes: int,
    average: Optional[str] = "macro",
    weights: Optional[Tensor] = None,
) -> Union[List[Tensor], Tensor]:
    """AP = -sum(dRecall * precision), per class along the last axis."""
    if num_classes == 1:
        return -((recall[1:] - recall[:-1]) * precision[:-1]).sum()

    if isinstance(precision, Tensor):
        res_t = -((recall[:, 1:] - recall[:, :-1]) * precision[:, :-1]).sum(dim=1)
    else:
        res_t = torch.stack([-((r[1:] - r[:-1]) * p[:-1]).sum() for p, r in zip(precision, recall)])

    if average == "macro":
        nan = torch.isnan(res_t)
        if bool(nan.any()):
            rank_zero_warn(
                "Average precision score for one or more classes was `nan`. Ignoring these classes in macro-average",
                UserWarning,
            )
        return res_t[~nan].mean()
    if average == "weighted":
        res_t = res_t * weights
        return res_t[~torch.isnan(res_t)].sum()
    if average in (None, "none", "micro"):
        return list(res_t)
    raise ValueError(f"Expected argument `average` to be one of ['macro', 'weighted', 'micro', None] but got {average}")
