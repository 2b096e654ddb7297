"""Accuracy module (counterpart of ``metrics_tpu/classification/accuracy.py``).

The input mode is determined at the first update and fixed from then on.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.classification.stat_scores import StatScores
from metrics_tpu_torch.ops.classification.accuracy import (
    _accuracy_compute,
    _accuracy_update,
    _check_subset_validity,
    _mode,
    _subset_accuracy_compute,
    _subset_accuracy_update,
)
from metrics_tpu_torch.utils.checks import _check_arg_choice
from metrics_tpu_torch.utils.enums import DataType


class Accuracy(StatScores):
    """Accuracy over any classification input type.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy
        >>> target = torch.tensor([0, 1, 2, 3])
        >>> preds = torch.tensor([0, 2, 1, 3])
        >>> accuracy = Accuracy(device="cpu")
        >>> accuracy.update(preds, target)
        >>> round(float(accuracy.compute()), 4)
        0.5
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    _ckpt_aux_attrs = ("mode", "subset_accuracy")

    def __init__(
        self,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        average: Optional[str] = "micro",
        mdmc_average: Optional[str] = "global",
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        multiclass: Optional[bool] = None,
        subset_accuracy: bool = False,
        **kwargs: Any,
    ) -> None:
        _check_arg_choice(average, "average", ("micro", "macro", "weighted", "samples", "none", None))

        super().__init__(
            reduce="macro" if average in ("weighted", "none", None) else average,
            mdmc_reduce=mdmc_average,
            threshold=threshold,
            top_k=top_k,
            num_classes=num_classes,
            multiclass=multiclass,
            ignore_index=ignore_index,
            **kwargs,
        )
        if top_k is not None and (not isinstance(top_k, int) or top_k <= 0):
            raise ValueError(f"The `top_k` should be an integer larger than 0, got {top_k}")

        self.average = average
        self.subset_accuracy = subset_accuracy
        self.mode: Optional[DataType] = None

        if self.subset_accuracy:
            # int32 like the JAX package's jnp.asarray(0); torch.tensor(0) is int64
            self.add_state("correct", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")
            self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def _update_signature(self):
        # `mode` is determined at the first update; grouping would skip that
        # side effect on members, so Accuracy never shares a compute group
        return None

    def update(self, preds: Tensor, target: Tensor, sample_mask: Optional[Tensor] = None) -> None:  # type: ignore[override]
        mode = _mode(preds, target, self.threshold, self.top_k, self.num_classes, self.multiclass, self.ignore_index)
        if not self.mode:
            self.mode = mode
        elif self.mode != mode:
            raise ValueError(f"Cannot mix {mode} inputs with previously seen {self.mode} inputs.")

        if self.subset_accuracy and not _check_subset_validity(self.mode):
            self.subset_accuracy = False

        if self.subset_accuracy:
            correct, total = _subset_accuracy_update(
                preds, target, self.threshold, self.top_k, self.ignore_index, self.num_classes,
                sample_mask=sample_mask,
            )
            self.correct = self.correct + correct
            self.total = self.total + total
        else:
            tp, fp, tn, fn = _accuracy_update(
                preds, target, self.reduce, self.mdmc_reduce, self.threshold, self.num_classes,
                self.top_k, self.multiclass, self.ignore_index, self.mode, sample_mask=sample_mask,
            )
            self._accumulate(tp, fp, tn, fn)

    def compute(self) -> Tensor:
        if not self.mode:
            raise RuntimeError("You have to have determined mode.")
        if self.subset_accuracy:
            return _subset_accuracy_compute(self.correct, self.total)
        tp, fp, tn, fn = self._get_final_stats()
        return _accuracy_compute(tp, fp, tn, fn, self.average, self.mdmc_reduce, self.mode)
