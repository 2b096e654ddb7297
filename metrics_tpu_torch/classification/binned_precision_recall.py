"""Binned (fixed-threshold) PR curves (counterpart of
``metrics_tpu/classification/binned_precision_recall.py``).

Fixed ``(C, T)`` float32 state. The threshold counting runs through
:func:`metrics_tpu_torch.ops.classification.binned_counts.binned_counts`: the
hand-written CUDA kernel for state on the card, the plain PyTorch version for
state on the CPU. ``(N, C)`` scores with ``(N,)`` class labels reach it as
labels, where the JAX package first builds their one-hot. The threshold grid
is sorted once, here, at construction.

``compute`` works on all classes at once: the per-class curves are rows of
one ``(C, T + 1)`` tensor, integrated row-wise, instead of a Python loop of
small launches per class.
"""
from __future__ import annotations

from typing import Any, List, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.ops.classification.average_precision import _average_precision_compute_with_precision_recall
from metrics_tpu_torch.ops.classification.binned_counts import binned_counts, sort_thresholds
from metrics_tpu_torch.utils.data import METRIC_EPS


def linspace_thresholds(num: int) -> Tensor:
    """``jnp.linspace(0, 1.0, num)``, bit for bit.

    ``torch.linspace`` rounds differently (1 of 100 values, 20 of 101, 125 of
    1000 differ by an ulp) and a one-ulp shift moves scores between buckets.
    ``jnp.linspace`` computes ``i * float32(1 / (num - 1))`` and sets the last
    value to exactly 1.0.
    """
    if num <= 1:
        return torch.zeros(num, dtype=torch.float32)
    step = torch.tensor(1.0 / (num - 1), dtype=torch.float32)
    return torch.cat([torch.arange(num - 1, dtype=torch.float32) * step, torch.ones(1, dtype=torch.float32)])


def _class_labels(target: Tensor) -> Tensor:
    """Class labels as the kernel reads them (int32 or int64), standing for
    ``to_onehot(target) == 1``: other integer types widen exactly, and a
    float label matches the class it equals, so one that is not a whole
    number in range (or NaN) matches none and becomes -1."""
    if target.dtype in (torch.int32, torch.int64):
        return target
    if target.is_floating_point():
        whole = (target == torch.floor(target)) & (target >= 0) & (target < 2**31)
        return torch.where(whole, target, -1).to(torch.int64)
    return target.to(torch.int64)


def _recall_at_precision(
    precision: Tensor, recall: Tensor, thresholds: Tensor, min_precision: float
) -> Tuple[Tensor, Tensor]:
    """Max recall subject to precision >= min_precision, along the last axis.

    Maximizes the tuple (recall, precision, threshold) lexicographically, one
    exact stage at a time.
    """
    n_thr = thresholds.shape[-1]
    precision_t = precision[..., :n_thr]  # ignore the appended curve point
    recall_t = recall[..., :n_thr]
    qualify = precision_t >= min_precision
    max_recall = torch.where(qualify, recall_t, float("-inf")).amax(dim=-1)
    recall_tied = qualify & (recall_t == max_recall.unsqueeze(-1))
    max_precision = torch.where(recall_tied, precision_t, float("-inf")).amax(dim=-1)
    best_tied = recall_tied & (precision_t == max_precision.unsqueeze(-1))
    best_threshold = torch.where(best_tied, thresholds, float("-inf")).amax(dim=-1)
    max_recall = torch.where(qualify.any(dim=-1), max_recall, 0.0)
    best_threshold = torch.where(max_recall == 0.0, 1e6, best_threshold)
    return max_recall, best_threshold


class BinnedPrecisionRecallCurve(Metric):
    """Constant-memory PR curve over fixed thresholds.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import BinnedPrecisionRecallCurve
        >>> preds = torch.tensor([0.0, 0.1, 0.8, 0.4])
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> curve = BinnedPrecisionRecallCurve(num_classes=1, thresholds=5, device="cpu")
        >>> curve.update(preds, target)
        >>> precision, recall, thresholds = curve.compute()
        >>> [round(float(p), 4) for p in precision]
        [0.75, 1.0, 1.0, 1.0, 1.0, 1.0]
        >>> [round(float(r), 4) for r in recall]
        [1.0, 0.6667, 0.3333, 0.3333, 0.0, 0.0]
        >>> [round(float(t), 4) for t in thresholds]
        [0.0, 0.25, 0.5, 0.75, 1.0]
    """

    is_differentiable: bool = False
    higher_is_better = None
    full_state_update: bool = False

    # check hook: True makes update() count with the plain PyTorch version
    # instead of the CUDA kernel; it lets a check hold one against the other
    _plain_counts: bool = False

    def __init__(self, num_classes: int, thresholds: Union[int, Tensor, List[float]] = 100, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        if isinstance(thresholds, int):
            grid = linspace_thresholds(thresholds)
        elif isinstance(thresholds, (list, Tensor)):
            grid = torch.as_tensor(thresholds, dtype=torch.float32).reshape(-1)
        else:
            raise ValueError("Expected argument `thresholds` to either be an integer, list of floats or a tensor")
        self.thresholds = grid.to(self.device)
        self.num_thresholds = self.thresholds.numel()
        self._grid = sort_thresholds(self.thresholds)
        self._threshold_key = tuple(self.thresholds.tolist())

        for name in ("TPs", "FPs", "FNs"):
            self.add_state(
                name=name,
                default=torch.zeros((num_classes, self.num_thresholds), dtype=torch.float32),
                dist_reduce_fx="sum",
            )

    def _update_signature(self):
        return ("binned-pr", self.num_classes, self.num_thresholds, self._threshold_key)

    def _move_attributes(self, device: torch.device) -> None:
        self.thresholds = self.thresholds.to(device)
        self._grid = sort_thresholds(self.thresholds)

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        if preds.ndim == target.ndim == 1:
            preds = preds.reshape(-1, 1)
            target = target.reshape(-1, 1)
        if preds.ndim == target.ndim + 1:
            if preds.ndim != 2 or preds.shape[1] != self.num_classes:
                # the one-hot the JAX package builds would not match such scores
                raise ValueError(
                    f"Expected (N, {self.num_classes}) scores with (N,) class labels, got {tuple(preds.shape)}"
                )
            target = _class_labels(target)  # the kernel reads labels; no one-hot is built
        else:
            target = target == 1
        tp, fp, fn = binned_counts(
            preds.to(torch.float32).contiguous(), target.contiguous(), self._grid, plain=self._plain_counts
        )
        self.TPs = self.TPs + tp
        self.FPs = self.FPs + fp
        self.FNs = self.FNs + fn

    def _curve_rows(self) -> Tuple[Tensor, Tensor]:
        """(C, T + 1) precision and recall rows, ending in precision 1, recall 0."""
        precisions = (self.TPs + METRIC_EPS) / (self.TPs + self.FPs + METRIC_EPS)
        recalls = self.TPs / (self.TPs + self.FNs + METRIC_EPS)
        ones = torch.ones((self.num_classes, 1), dtype=precisions.dtype, device=precisions.device)
        precisions = torch.cat([precisions, ones], dim=1)
        recalls = torch.cat([recalls, torch.zeros_like(ones)], dim=1)
        return precisions, recalls

    def compute(self) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
        precisions, recalls = self._curve_rows()
        if self.num_classes == 1:
            return precisions[0, :], recalls[0, :], self.thresholds
        return list(precisions), list(recalls), [self.thresholds for _ in range(self.num_classes)]


class BinnedAveragePrecision(BinnedPrecisionRecallCurve):
    """Average precision over a binned PR curve: one scalar per class (a list
    of C 0-d tensors; a single tensor when ``num_classes == 1``).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import BinnedAveragePrecision
        >>> preds = torch.tensor([0.0, 0.1, 0.8, 0.4])
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> metric = BinnedAveragePrecision(num_classes=1, thresholds=5, device="cpu")
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()), 4)
        0.9167
    """

    def compute(self) -> Union[List[Tensor], Tensor]:  # type: ignore[override]
        precisions, recalls = self._curve_rows()
        if self.num_classes == 1:
            precisions, recalls = precisions[0], recalls[0]
        return _average_precision_compute_with_precision_recall(precisions, recalls, self.num_classes, average=None)


class BinnedRecallAtFixedPrecision(BinnedPrecisionRecallCurve):
    """Max recall meeting a precision floor, over binned thresholds.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import BinnedRecallAtFixedPrecision
        >>> preds = torch.tensor([0.0, 0.1, 0.8, 0.4])
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> metric = BinnedRecallAtFixedPrecision(num_classes=1, thresholds=5, min_precision=0.8, device="cpu")
        >>> metric.update(preds, target)
        >>> recall, threshold = metric.compute()
        >>> round(float(recall), 4), round(float(threshold), 4)
        (0.6667, 0.25)
    """

    def __init__(
        self,
        num_classes: int,
        min_precision: float,
        thresholds: Union[int, Tensor, List[float]] = 100,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_classes=num_classes, thresholds=thresholds, **kwargs)
        self.min_precision = min_precision

    def _update_signature(self):
        return None  # min_precision changes compute only; kept out of groups as in the JAX package

    def compute(self) -> Tuple[Tensor, Tensor]:  # type: ignore[override]
        precisions, recalls = self._curve_rows()
        if self.num_classes == 1:
            precisions, recalls = precisions[0], recalls[0]
        return _recall_at_precision(precisions, recalls, self.thresholds, self.min_precision)
