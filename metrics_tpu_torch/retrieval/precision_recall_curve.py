"""The retrieval precision-recall curve over top-k cutoffs (counterpart of
``metrics_tpu/retrieval/precision_recall_curve.py``). Both classes evaluate
eager, query by query; they have no row scorer for the compiled path.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.ops.retrieval import retrieval_precision_recall_curve
from metrics_tpu_torch.retrieval.base import RetrievalMetric
from metrics_tpu_torch.utils.data import dim_zero_cat, get_group_indexes


def _retrieval_recall_at_fixed_precision(
    precision: Tensor, recall: Tensor, top_k: Tensor, min_precision: float
) -> Tuple[Tensor, Tensor]:
    """The largest recall whose precision reaches ``min_precision``, and its k
    (recall ties go to the larger k)."""
    qualify = precision >= min_precision
    masked = torch.where(qualify, recall, -torch.inf)
    rmax = torch.max(masked)
    best_k = torch.max(torch.where(qualify & (masked == rmax), top_k, 0))
    max_recall = torch.where(torch.any(qualify), rmax, 0.0)
    best_k = torch.where(max_recall == 0.0, len(top_k), best_k)
    return max_recall, best_k


class RetrievalPrecisionRecallCurve(RetrievalMetric):
    """Precision and recall at each top-k cutoff, averaged over queries.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalPrecisionRecallCurve
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> curve = RetrievalPrecisionRecallCurve(max_k=2, device="cpu")
        >>> curve.update(preds, target, indexes=indexes)
        >>> precisions, recalls, top_k = curve.compute()
        >>> [round(float(p), 4) for p in precisions]
        [0.5, 0.5]
        >>> [round(float(r), 4) for r in recalls]
        [0.5, 0.75]
        >>> top_k.tolist()
        [1, 2]
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        max_k: Optional[int] = None,
        adaptive_k: bool = False,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs)
        if (max_k is not None) and not (isinstance(max_k, int) and max_k > 0):
            raise ValueError("`max_k` has to be a positive integer or None")
        self.max_k = max_k
        if not isinstance(adaptive_k, bool):
            raise ValueError("`adaptive_k` has to be a boolean")
        self.adaptive_k = adaptive_k

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:  # pragma: no cover - unused
        raise NotImplementedError

    def compute(self) -> Tuple[Tensor, Tensor, Tensor]:
        indexes = dim_zero_cat(self.indexes)
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        groups = get_group_indexes(indexes)

        max_k = self.max_k or max(len(g) for g in groups)

        precisions, recalls = [], []
        for group in groups:
            mini_preds = preds[group]
            mini_target = target[group]
            if not float(torch.sum(mini_target)):
                if self.empty_target_action == "error":
                    raise ValueError("`compute` method was provided with a query with no positive target.")
                if self.empty_target_action == "pos":
                    recalls.append(preds.new_ones(max_k))
                    precisions.append(preds.new_ones(max_k))
                elif self.empty_target_action == "neg":
                    recalls.append(preds.new_zeros(max_k))
                    precisions.append(preds.new_zeros(max_k))
            else:
                precision, recall, _ = retrieval_precision_recall_curve(mini_preds, mini_target, max_k, self.adaptive_k)
                precisions.append(precision)
                recalls.append(recall)

        precision = torch.mean(torch.stack(precisions), dim=0) if precisions else preds.new_zeros(max_k)
        recall = torch.mean(torch.stack(recalls), dim=0) if recalls else preds.new_zeros(max_k)
        top_k = torch.arange(1, max_k + 1, dtype=torch.int32, device=preds.device)
        return precision, recall, top_k


class RetrievalRecallAtFixedPrecision(RetrievalPrecisionRecallCurve):
    """The largest recall@k whose precision@k reaches ``min_precision``, and the k.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalRecallAtFixedPrecision
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalRecallAtFixedPrecision(min_precision=0.5, device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> recall, best_k = metric.compute()
        >>> round(float(recall), 4), int(best_k)
        (1.0, 3)
    """

    higher_is_better = True

    def __init__(
        self,
        min_precision: float = 0.0,
        max_k: Optional[int] = None,
        adaptive_k: bool = False,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            max_k=max_k, adaptive_k=adaptive_k, empty_target_action=empty_target_action,
            ignore_index=ignore_index, **kwargs,
        )
        if not (isinstance(min_precision, float) and 0.0 <= min_precision <= 1.0):
            raise ValueError("`min_precision` has to be a positive float between 0 and 1")
        self.min_precision = min_precision

    def compute(self) -> Tuple[Tensor, Tensor]:  # type: ignore[override]
        precisions, recalls, top_k = super().compute()
        return _retrieval_recall_at_fixed_precision(precisions, recalls, top_k, self.min_precision)
