"""The scalar retrieval metrics (counterpart of ``metrics_tpu/retrieval/metrics.py``):
MAP, MRR, Precision@k, Recall@k, HitRate@k, FallOut@k (its empty query has
no negative document), nDCG@k and R-precision, each with its single-query
functional for the eager path and its row scorer for the compiled one.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.ops.retrieval import (
    retrieval_average_precision,
    retrieval_fall_out,
    retrieval_hit_rate,
    retrieval_normalized_dcg,
    retrieval_precision,
    retrieval_r_precision,
    retrieval_reciprocal_rank,
    retrieval_recall,
)
from metrics_tpu_torch.ops.retrieval import segmented as _seg
from metrics_tpu_torch.retrieval.base import RetrievalMetric

class RetrievalMAP(RetrievalMetric):
    """Mean average precision over queries.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalMAP
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalMAP(device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> round(float(metric.compute()), 4)
        0.7917
    """

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return retrieval_average_precision(preds, target)

    def _metric_rows(self, p_mat: Tensor, t_mat: Tensor, m_mat: Tensor) -> Tensor:
        return _seg.average_precision_rows(p_mat, t_mat, m_mat)


class RetrievalMRR(RetrievalMetric):
    """Mean reciprocal rank.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalMRR
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalMRR(device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> round(float(metric.compute()), 4)
        0.75
    """

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return retrieval_reciprocal_rank(preds, target)

    def _metric_rows(self, p_mat: Tensor, t_mat: Tensor, m_mat: Tensor) -> Tensor:
        return _seg.reciprocal_rank_rows(p_mat, t_mat, m_mat)


class _TopKRetrievalMetric(RetrievalMetric):
    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        k: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs)
        if (k is not None) and not (isinstance(k, int) and k > 0):
            raise ValueError("`k` has to be a positive integer or None")
        self.k = k


class RetrievalPrecision(_TopKRetrievalMetric):
    """Precision@k averaged over queries.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalPrecision
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalPrecision(k=2, device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> round(float(metric.compute()), 4)
        0.5
    """

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        k: Optional[int] = None,
        adaptive_k: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, k=k, **kwargs)
        if not isinstance(adaptive_k, bool):
            raise ValueError("`adaptive_k` has to be a boolean")
        self.adaptive_k = adaptive_k

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return retrieval_precision(preds, target, k=self.k, adaptive_k=self.adaptive_k)

    def _metric_rows(self, p_mat: Tensor, t_mat: Tensor, m_mat: Tensor) -> Tensor:
        return _seg.precision_rows(p_mat, t_mat, m_mat, k=self.k, adaptive_k=self.adaptive_k)


class RetrievalRecall(_TopKRetrievalMetric):
    """Recall@k averaged over queries.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalRecall
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalRecall(k=2, device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> round(float(metric.compute()), 4)
        0.75
    """

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return retrieval_recall(preds, target, k=self.k)

    def _metric_rows(self, p_mat: Tensor, t_mat: Tensor, m_mat: Tensor) -> Tensor:
        return _seg.recall_rows(p_mat, t_mat, m_mat, k=self.k)


class RetrievalHitRate(_TopKRetrievalMetric):
    """HitRate@k averaged over queries.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalHitRate
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalHitRate(k=2, device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> round(float(metric.compute()), 4)
        1.0
    """

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return retrieval_hit_rate(preds, target, k=self.k)

    def _metric_rows(self, p_mat: Tensor, t_mat: Tensor, m_mat: Tensor) -> Tensor:
        return _seg.hit_rate_rows(p_mat, t_mat, m_mat, k=self.k)


class RetrievalNormalizedDCG(_TopKRetrievalMetric):
    """nDCG@k averaged over queries (graded relevance allowed).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalNormalizedDCG
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalNormalizedDCG(device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> round(float(metric.compute()), 4)
        0.8467
    """

    def __init__(self, empty_target_action: str = "neg", ignore_index: Optional[int] = None, k: Optional[int] = None,
                 **kwargs: Any) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, k=k, **kwargs)
        self.allow_non_binary_target = True

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return retrieval_normalized_dcg(preds, target, k=self.k)

    def _metric_rows(self, p_mat: Tensor, t_mat: Tensor, m_mat: Tensor) -> Tensor:
        return _seg.normalized_dcg_rows(p_mat, t_mat, m_mat, k=self.k)


class RetrievalRPrecision(RetrievalMetric):
    """R-precision averaged over queries.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalRPrecision
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalRPrecision(device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> round(float(metric.compute()), 4)
        0.75
    """

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return retrieval_r_precision(preds, target)

    def _metric_rows(self, p_mat: Tensor, t_mat: Tensor, m_mat: Tensor) -> Tensor:
        return _seg.r_precision_rows(p_mat, t_mat, m_mat)


class RetrievalFallOut(_TopKRetrievalMetric):
    """FallOut@k averaged over queries. Its empty query is inverted: a query
    with no *negative* document is the degenerate one.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalFallOut
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalFallOut(k=2, device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> round(float(metric.compute()), 4)
        0.5
    """

    higher_is_better = False
    _empty_kind = "negative"

    def _is_empty_query(self, target: Tensor) -> bool:
        return not float(torch.sum(1 - target))

    def _empty_rows(self, t_mat: Tensor, m_mat: Tensor) -> Tensor:
        return torch.sum(torch.where(m_mat, 1 - t_mat, 0), dim=1) == 0

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return retrieval_fall_out(preds, target, k=self.k)

    def _metric_rows(self, p_mat: Tensor, t_mat: Tensor, m_mat: Tensor) -> Tensor:
        return _seg.fall_out_rows(p_mat, t_mat, m_mat, k=self.k)
