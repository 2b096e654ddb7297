"""Hamming distance, the share of wrong labels (counterpart of
``metrics_tpu/ops/classification/hamming.py``)."""
from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _input_format_classification


def _hamming_distance_update(preds: Tensor, target: Tensor, threshold: float = 0.5) -> Tuple[Tensor, int]:
    preds, target, _ = _input_format_classification(preds, target, threshold=threshold)
    correct = (preds == target).sum(dtype=torch.int32)
    return correct, preds.numel()


def _hamming_distance_compute(correct: Tensor, total: Union[int, Tensor]) -> Tensor:
    return 1 - correct.to(torch.float32) / total


def hamming_distance(preds: Tensor, target: Tensor, threshold: float = 0.5) -> Tensor:
    """Fraction of mismatched labels.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.classification import hamming_distance
        >>> preds = torch.tensor([[0, 1], [0, 1]])
        >>> target = torch.tensor([[0, 1], [1, 1]])
        >>> round(float(hamming_distance(preds, target)), 4)
        0.25
    """
    correct, total = _hamming_distance_update(preds, target, threshold)
    return _hamming_distance_compute(correct, total)
