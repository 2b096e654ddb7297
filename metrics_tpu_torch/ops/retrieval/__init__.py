"""Single-query retrieval functionals (counterpart of
``metrics_tpu/ops/retrieval/__init__.py``).

Each takes the scores and targets of ONE query. Documents are ranked by a
stable argsort of the negated scores, as the JAX package ranks them, so tied
scores keep their input order and AP, MRR and nDCG agree bit for bit on
ties. The grouped evaluation lives in :mod:`metrics_tpu_torch.retrieval`;
the dense, static-shape one in :mod:`metrics_tpu_torch.ops.retrieval.segmented`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_retrieval_functional_inputs
from metrics_tpu_torch.utils.compute import safe_divide


def _sorted_by_preds(preds: Tensor, target: Tensor) -> Tensor:
    return target[torch.argsort(-preds, stable=True)]


def _isum(x: Tensor) -> Tensor:
    """``jnp.sum`` of a target: int32 stays int32 (torch would sum into int64)."""
    return torch.sum(x, dtype=torch.int32) if x.dtype == torch.int32 else torch.sum(x)


def _check_k(k) -> None:
    if not (isinstance(k, int) and k > 0):
        raise ValueError("`k` has to be a positive integer or None")


def retrieval_average_precision(preds: Tensor, target: Tensor) -> Tensor:
    """AP of one query.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import retrieval_average_precision
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> round(float(retrieval_average_precision(preds, target)), 4)
        0.8333
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    rel = _sorted_by_preds(preds, target).to(torch.float32)
    ranks = torch.arange(1, rel.shape[-1] + 1, dtype=torch.float32, device=rel.device)
    return safe_divide(torch.sum(rel * torch.cumsum(rel, dim=0) / ranks), torch.sum(rel))


def retrieval_reciprocal_rank(preds: Tensor, target: Tensor) -> Tensor:
    """RR of one query.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import retrieval_reciprocal_rank
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> round(float(retrieval_reciprocal_rank(preds, target)), 4)
        1.0
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    rel = _sorted_by_preds(preds, target)
    first = torch.argmax((rel > 0).to(torch.uint8))  # the first positive (argmax takes the first maximum)
    return torch.where(_isum(rel) == 0, 0.0, 1.0 / (first + 1.0))


def retrieval_precision(preds: Tensor, target: Tensor, k: Optional[int] = None, adaptive_k: bool = False) -> Tensor:
    """Precision@k of one query.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import retrieval_precision
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> round(float(retrieval_precision(preds, target, k=2)), 4)
        0.5
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    if not isinstance(adaptive_k, bool):
        raise ValueError("`adaptive_k` has to be a boolean")
    if k is None or (adaptive_k and k > preds.shape[-1]):
        k = preds.shape[-1]
    _check_k(k)
    return _isum(_sorted_by_preds(preds, target)[: min(k, preds.shape[-1])]).to(torch.float32) / k


def retrieval_recall(preds: Tensor, target: Tensor, k: Optional[int] = None) -> Tensor:
    """Recall@k of one query.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import retrieval_recall
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> round(float(retrieval_recall(preds, target, k=2)), 4)
        0.5
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    if k is None:
        k = preds.shape[-1]
    _check_k(k)
    return safe_divide(_isum(_sorted_by_preds(preds, target)[:k]).to(torch.float32), _isum(target))


def retrieval_hit_rate(preds: Tensor, target: Tensor, k: Optional[int] = None) -> Tensor:
    """HitRate@k of one query.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import retrieval_hit_rate
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> round(float(retrieval_hit_rate(preds, target, k=2)), 4)
        1.0
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    if k is None:
        k = preds.shape[-1]
    _check_k(k)
    return (_isum(_sorted_by_preds(preds, target)[:k]) > 0).to(torch.float32)


def retrieval_fall_out(preds: Tensor, target: Tensor, k: Optional[int] = None) -> Tensor:
    """FallOut@k of one query: non-relevant documents retrieved over all
    non-relevant ones.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import retrieval_fall_out
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> round(float(retrieval_fall_out(preds, target, k=2)), 4)
        1.0
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    k = preds.shape[-1] if k is None else k
    _check_k(k)
    target = 1 - target
    return safe_divide(_isum(_sorted_by_preds(preds, target)[:k]).to(torch.float32), _isum(target))


def _dcg(target: Tensor) -> Tensor:
    denom = torch.log2(torch.arange(target.shape[-1], dtype=torch.float32, device=target.device) + 2.0)
    return torch.sum(target / denom, dim=-1)


def retrieval_normalized_dcg(preds: Tensor, target: Tensor, k: Optional[int] = None) -> Tensor:
    """nDCG@k of one query (graded relevance allowed).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import retrieval_normalized_dcg
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> round(float(retrieval_normalized_dcg(preds, target)), 4)
        0.9197
    """
    preds, target = _check_retrieval_functional_inputs(preds, target, allow_non_binary_target=True)
    k = preds.shape[-1] if k is None else k
    _check_k(k)
    sorted_target = _sorted_by_preds(preds, target)[:k]
    ideal_target = torch.sort(target, descending=True).values[:k]
    ideal_dcg = _dcg(ideal_target.to(torch.float32))
    target_dcg = _dcg(sorted_target.to(torch.float32))
    return torch.where(ideal_dcg == 0, 0.0, target_dcg / torch.where(ideal_dcg == 0, 1.0, ideal_dcg))


def retrieval_r_precision(preds: Tensor, target: Tensor) -> Tensor:
    """R-precision of one query: precision at R, the number of relevant
    documents, counted with a position mask.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import retrieval_r_precision
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> round(float(retrieval_r_precision(preds, target)), 4)
        0.5
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    rel = _sorted_by_preds(preds, target).to(torch.float32)
    total = torch.sum(rel)
    in_top_r = torch.arange(rel.shape[-1], dtype=torch.float32, device=rel.device) < total
    return safe_divide(torch.sum(rel * in_top_r), total)


def retrieval_precision_recall_curve(
    preds: Tensor, target: Tensor, max_k: Optional[int] = None, adaptive_k: bool = False
) -> Tuple[Tensor, Tensor, Tensor]:
    """Precision@k and recall@k for k = 1..max_k of one query, and the k.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import retrieval_precision_recall_curve
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> precisions, recalls, top_k = retrieval_precision_recall_curve(preds, target, max_k=2)
        >>> [round(float(p), 4) for p in precisions]
        [1.0, 0.5]
        >>> [round(float(r), 4) for r in recalls]
        [0.5, 0.5]
        >>> top_k.tolist()
        [1, 2]
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    if not isinstance(adaptive_k, bool):
        raise ValueError("`adaptive_k` has to be a boolean")
    if max_k is None:
        max_k = preds.shape[-1]
    if not (isinstance(max_k, int) and max_k > 0):
        raise ValueError("`max_k` has to be a positive integer or None")
    n = preds.shape[-1]
    device = preds.device
    if adaptive_k and max_k > n:
        # the curves keep length max_k: k stops at the query's document count
        topk = torch.cat([torch.arange(1, n + 1, device=device), torch.full((max_k - n,), n, device=device)])
        topk = topk.to(torch.float32)
    else:
        topk = torch.arange(1, max_k + 1, dtype=torch.float32, device=device)
    sorted_target = _sorted_by_preds(preds, target)[:max_k].to(torch.float32)
    cs = torch.cumsum(sorted_target, dim=0)
    if len(cs) < max_k:  # fewer documents than max_k: the counts saturate
        cs = torch.cat([cs, cs[-1:].expand(max_k - len(cs))])
    precision = cs / topk
    total = _isum(target)
    recall = torch.where(total == 0, 0.0, cs / torch.where(total == 0, 1, total))
    return precision, recall, topk.to(torch.int32)

