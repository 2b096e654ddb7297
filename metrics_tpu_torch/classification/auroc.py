"""AUROC (counterpart of ``metrics_tpu/classification/auroc.py``).

The exact route keeps ``cat`` states (lists, or captured ``CatBuffer``
states with ``buffer_capacity=N``) and computes eagerly. The bounded
``approx="sketch"`` route (binary only) keeps two
:class:`~metrics_tpu_torch.sketches.QuantileSketch` states, the positive and
the negative scores on one log-bucket grid, and computes AUROC as the rank
statistic ``P(s_pos > s_neg) + 0.5 P(tie)`` over the grid; its update and
compute are both captured.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.ops.classification.auroc import _auroc_compute, _auroc_update
from metrics_tpu_torch.sketches import QuantileSketch
from metrics_tpu_torch.utils.checks import _check_arg_choice
from metrics_tpu_torch.utils.data import append_cat, dim_zero_cat
from metrics_tpu_torch.utils.enums import DataType
from metrics_tpu_torch.utils.exceptions import MetricsUserError


class AUROC(Metric):
    """Area under the ROC curve.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import AUROC
        >>> preds = torch.tensor([0.13, 0.26, 0.08, 0.19, 0.34])
        >>> target = torch.tensor([0, 0, 1, 1, 1])
        >>> auroc = AUROC(pos_label=1, device="cpu")
        >>> auroc.update(preds, target)
        >>> round(float(auroc.compute()), 4)
        0.5
        >>> approx = AUROC(pos_label=1, approx="sketch", device="cpu")
        >>> approx.update(preds, target)
        >>> round(float(approx.compute()), 4)
        0.5
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    _ckpt_aux_attrs = ("mode",)

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
        average: Optional[str] = "macro",
        max_fpr: Optional[float] = None,
        approx: Optional[str] = None,
        num_buckets: int = 2048,
        relative_accuracy: float = 0.01,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.pos_label = pos_label
        self.average = average
        self.max_fpr = max_fpr
        _check_arg_choice(approx, "approx", (None, "sketch"))
        self.approx = approx

        _check_arg_choice(self.average, "average", (None, "macro", "weighted", "micro"))
        if self.max_fpr is not None:
            if not isinstance(max_fpr, float) or not 0 < max_fpr <= 1:
                raise ValueError(f"`max_fpr` should be a float in range (0, 1], got: {max_fpr}")

        self.mode: Optional[DataType] = None
        if self.approx == "sketch":
            if num_classes is not None:
                raise MetricsUserError("AUROC(approx='sketch') supports binary scores only; drop `num_classes`")
            if max_fpr is not None:
                raise MetricsUserError(
                    "AUROC(approx='sketch') does not support `max_fpr` (the partial-area "
                    "McClish correction needs exact score order)"
                )
            for name in ("pos_scores", "neg_scores"):
                self.add_state(
                    name,
                    default=QuantileSketch(
                        num_buckets=num_buckets, relative_accuracy=relative_accuracy, device=self.device
                    ),
                    dist_reduce_fx="sketch",
                    persistent=True,
                    sync_tolerance=float(relative_accuracy),
                )
        else:
            self.add_state("preds", default=[], dist_reduce_fx="cat")
            self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        if self.approx == "sketch":
            preds = torch.as_tensor(preds, device=self.device).reshape(-1).to(torch.float32)
            target = torch.as_tensor(target, device=self.device).reshape(-1)
            if preds.shape != target.shape:
                raise ValueError("AUROC(approx='sketch') expects binary `preds`/`target` of the same shape")
            pos_label = 1 if self.pos_label is None else int(self.pos_label)
            is_pos = target == pos_label
            # the sketch drops non-finite entries, so masking with NaN is the
            # static-shape form of boolean indexing
            self.pos_scores = self.pos_scores.insert(torch.where(is_pos, preds, math.nan))
            self.neg_scores = self.neg_scores.insert(torch.where(is_pos, math.nan, preds))
            self.mode = DataType.BINARY
            return
        preds, target, mode = _auroc_update(preds, target)
        self.preds = append_cat(self.preds, preds)
        self.target = append_cat(self.target, target)
        if self.mode and self.mode != mode:
            raise ValueError(
                "The mode of data (binary, multi-label, multi-class) should be constant, but changed"
                f" between batches from {self.mode} to {mode}"
            )
        self.mode = mode

    def compute(self) -> Tensor:
        if self.approx == "sketch":
            # rank statistic over the shared ordered bucket grid: every
            # positive beats the negatives in strictly lower buckets and ties
            # (0.5 credit) with the negatives in its own bucket
            pos = self.pos_scores._ordered_counts().to(torch.float32)
            neg = self.neg_scores._ordered_counts().to(torch.float32)
            n_pos, n_neg = torch.sum(pos), torch.sum(neg)
            neg_below = torch.cumsum(neg, dim=0) - neg
            wins = torch.sum(pos * (neg_below + 0.5 * neg))
            denom = n_pos * n_neg
            return torch.where(denom > 0, wins / torch.clamp(denom, min=1.0), math.nan).to(torch.float32)
        if not self.mode:
            raise RuntimeError("You have to have determined mode.")
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _auroc_compute(preds, target, self.mode, self.num_classes, self.pos_label, self.average, self.max_fpr)
