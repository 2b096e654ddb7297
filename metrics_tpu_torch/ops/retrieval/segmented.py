"""The compiled (static-shape) retrieval evaluation (counterpart of
``metrics_tpu/ops/retrieval/segmented.py``).

Instead of grouping the documents by query on the host and scoring each
query in a Python loop, the whole evaluation is a fixed sequence of device
operations with static bounds ``(max_queries, max_docs_per_query)``, which a
CUDA graph can hold:

1. :func:`bucketize_queries` stable-sorts the flat ``(N,)`` streams by query
   id (documents keep their order within a query), numbers the queries with
   a cumulative sum and the documents within each from the row where their
   query starts, and scatters the rows into dense ``(Q, D)`` matrices with
   validity masks.
   Rows past ``max_queries`` or ``max_docs_per_query`` are dropped and
   reported by the overflow flag. The JAX package drops them with an
   out-of-bounds scatter (``mode="drop"``); a torch scatter would raise on the
   CPU and trap on the card, so the matrices here have one spare row and one
   spare column that take every dropped row (indices are clamped into them)
   and are cut off after the scatter. No index out of bounds reaches a scatter.
2. The ``*_rows`` scorers: the single-query functionals of
   :mod:`metrics_tpu_torch.ops.retrieval` over every row at once, with
   invalid documents sorted last (``-inf`` scores) and a per-row ``k`` as a
   position mask.
3. :func:`segmented_mean`: the mean over queries, with
   ``empty_target_action`` as a masked selection.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

__all__ = [
    "bucketize_queries",
    "average_precision_rows",
    "reciprocal_rank_rows",
    "precision_rows",
    "recall_rows",
    "hit_rate_rows",
    "fall_out_rows",
    "normalized_dcg_rows",
    "r_precision_rows",
    "segmented_mean",
]

_INT32_MAX = 2**31 - 1


def bucketize_queries(
    indexes: Tensor,
    preds: Tensor,
    target: Tensor,
    valid: Optional[Tensor],
    max_queries: int,
    max_docs: int,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Scatter flat ``(N,)`` streams into dense ``(Q, D)`` per-query matrices.

    Returns ``(P, T, M, query_mask, overflow)``: scores (``-inf`` outside
    ``M``), targets (0 outside ``M``), the document mask, the mask of rows
    that hold a query, and a 0-d bool that is True when the bounds were
    exceeded (more distinct queries than ``max_queries``, or a query with
    more than ``max_docs`` documents).
    """
    n = indexes.shape[0]
    device = indexes.device
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=device)
    idxs = torch.where(valid, indexes.to(torch.int32), _INT32_MAX)
    order = torch.argsort(idxs, stable=True)
    si, sp, st, sv = idxs[order], preds[order], target[order], valid[order]

    first = torch.ones((n,), dtype=torch.bool, device=device)
    first[1:] = si[1:] != si[:-1]
    new_q = first & sv
    group = torch.cumsum(new_q, dim=0) - 1  # the query of each row, numbered in sorted order
    dense = torch.where(sv & (group < max_queries), group, max_queries)  # the spare row
    # the row where each row's query starts: the JAX package's running
    # maximum (associative_scan), as a scatter of the start rows and a gather;
    # torch.cummax scans a 1-D tensor in one thread block, 20.5 ms a call at
    # 7,000,000 rows on an NVIDIA H100
    arange = torch.arange(n, device=device)
    starts = torch.zeros((n + 1,), dtype=arange.dtype, device=device)
    starts[torch.where(new_q, group, n)] = arange  # row n takes every row that starts nothing
    group_start = torch.where(group >= 0, starts[group.clamp(min=0)], 0)
    pos = arange - group_start

    n_queries = torch.sum(new_q, dtype=torch.int32)
    overflow = (n_queries > max_queries) | torch.any(sv & (pos >= max_docs))

    col = torch.clamp(pos, max=max_docs)  # the spare column
    shape = (max_queries + 1, max_docs + 1)
    p_mat = torch.full(shape, -torch.inf, dtype=preds.dtype, device=device)
    p_mat[dense, col] = sp
    t_mat = torch.zeros(shape, dtype=target.dtype, device=device)
    t_mat[dense, col] = st
    m_mat = torch.zeros(shape, dtype=torch.bool, device=device)
    m_mat[dense, col] = sv
    qmask = torch.arange(max_queries, device=device) < torch.clamp(n_queries, max=max_queries)
    return p_mat[:max_queries, :max_docs], t_mat[:max_queries, :max_docs], m_mat[:max_queries, :max_docs], qmask, overflow


# --------------------------------------------------------------------------- #
# masked row scorers
# --------------------------------------------------------------------------- #
def _sort_rows(p_mat: Tensor, t_mat: Tensor, m_mat: Tensor) -> Tuple[Tensor, Tensor]:
    """Each row's targets in descending score order (invalid documents
    last), and the mask in that order."""
    masked_p = torch.where(m_mat, p_mat, -torch.inf)
    order = torch.argsort(-masked_p, dim=1, stable=True)
    tt = torch.take_along_dim(torch.where(m_mat, t_mat, 0), order, dim=1).to(torch.float32)
    mm = torch.take_along_dim(m_mat, order, dim=1)
    return tt, mm


def _positions(d: int, device: torch.device) -> Tensor:
    return torch.arange(d, dtype=torch.float32, device=device)


def _n_docs(mm: Tensor) -> Tensor:
    return torch.sum(mm, dim=1, dtype=torch.int32).to(torch.float32)


def average_precision_rows(p_mat: Tensor, t_mat: Tensor, m_mat: Tensor) -> Tensor:
    tt, _ = _sort_rows(p_mat, t_mat, m_mat)
    cs = torch.cumsum(tt, dim=1)
    prec_at = cs / (_positions(tt.shape[1], tt.device) + 1.0)
    n_pos = torch.sum(tt, dim=1)
    return torch.where(n_pos > 0, torch.sum(prec_at * tt, dim=1) / torch.clamp(n_pos, min=1.0), 0.0)


def reciprocal_rank_rows(p_mat: Tensor, t_mat: Tensor, m_mat: Tensor) -> Tensor:
    tt, _ = _sort_rows(p_mat, t_mat, m_mat)
    positive = tt > 0
    first = torch.argmax(positive.to(torch.uint8), dim=1)  # argmax refuses bool; it takes the first maximum
    has_pos = torch.any(positive, dim=1)
    return torch.where(has_pos, 1.0 / (first + 1.0), 0.0)


def _relevant_at(tt: Tensor, k_eff: Tensor) -> Tensor:
    """Sum of the sorted targets within each row's first ``k_eff`` positions."""
    return torch.sum(tt * (_positions(tt.shape[1], tt.device)[None, :] < k_eff[:, None]), dim=1)


def _k_eff(k: Optional[int], adaptive_k: bool, n_docs: Tensor, d: int) -> Tensor:
    if k is None:
        return n_docs
    k_arr = torch.full_like(n_docs, float(min(k, d) if not adaptive_k else k))
    if adaptive_k:
        k_arr = torch.where(k_arr > n_docs, n_docs, k_arr)
    return k_arr


def precision_rows(p_mat: Tensor, t_mat: Tensor, m_mat: Tensor, k: Optional[int] = None, adaptive_k: bool = False) -> Tensor:
    tt, mm = _sort_rows(p_mat, t_mat, m_mat)
    n_docs = _n_docs(mm)
    k_eff = _k_eff(k, adaptive_k, n_docs, tt.shape[1])
    # a static k without adaptive_k keeps the full k as the denominator, also
    # for a query with fewer than k documents (relevant[:k].sum() / k)
    denom = torch.full_like(n_docs, float(k)) if k is not None and not adaptive_k else k_eff
    rel = _relevant_at(tt, k_eff)
    return torch.where(denom > 0, rel / torch.clamp(denom, min=1.0), 0.0)


def recall_rows(p_mat: Tensor, t_mat: Tensor, m_mat: Tensor, k: Optional[int] = None) -> Tensor:
    tt, mm = _sort_rows(p_mat, t_mat, m_mat)
    n_pos = torch.sum(tt, dim=1)
    rel = _relevant_at(tt, _k_eff(k, False, _n_docs(mm), tt.shape[1]))
    return torch.where(n_pos > 0, rel / torch.clamp(n_pos, min=1.0), 0.0)


def hit_rate_rows(p_mat: Tensor, t_mat: Tensor, m_mat: Tensor, k: Optional[int] = None) -> Tensor:
    tt, mm = _sort_rows(p_mat, t_mat, m_mat)
    rel = _relevant_at(tt, _k_eff(k, False, _n_docs(mm), tt.shape[1]))
    return (rel > 0).to(torch.float32)


def fall_out_rows(p_mat: Tensor, t_mat: Tensor, m_mat: Tensor, k: Optional[int] = None) -> Tensor:
    inv = torch.where(m_mat, 1 - t_mat, 0)
    tt, mm = _sort_rows(p_mat, inv, m_mat)
    n_neg = torch.sum(tt, dim=1)
    rel = _relevant_at(tt, _k_eff(k, False, _n_docs(mm), tt.shape[1]))
    return torch.where(n_neg > 0, rel / torch.clamp(n_neg, min=1.0), 0.0)


def normalized_dcg_rows(p_mat: Tensor, t_mat: Tensor, m_mat: Tensor, k: Optional[int] = None) -> Tensor:
    tt, mm = _sort_rows(p_mat, t_mat, m_mat)
    n_docs = _n_docs(mm)
    # the eager path slices sorted_target[:k], which stops at the query's documents
    k_eff = n_docs if k is None else torch.minimum(torch.full_like(n_docs, float(k)), n_docs)
    positions = _positions(tt.shape[1], tt.device)
    gain_mask = positions[None, :] < k_eff[:, None]
    denom = torch.log2(positions + 2.0)
    dcg = torch.sum(torch.where(gain_mask, tt / denom, 0.0), dim=1)
    ideal = -torch.sort(-torch.where(m_mat, t_mat, 0).to(torch.float32), dim=1).values
    idcg = torch.sum(torch.where(gain_mask, ideal / denom, 0.0), dim=1)
    return torch.where(idcg > 0, dcg / torch.clamp(idcg, min=1e-38), 0.0)


def r_precision_rows(p_mat: Tensor, t_mat: Tensor, m_mat: Tensor) -> Tensor:
    tt, _ = _sort_rows(p_mat, t_mat, m_mat)
    n_pos = torch.sum(tt, dim=1)
    rel = _relevant_at(tt, n_pos)
    return torch.where(n_pos > 0, rel / torch.clamp(n_pos, min=1.0), 0.0)


# --------------------------------------------------------------------------- #
# the mean over queries, with the empty_target_action policy
# --------------------------------------------------------------------------- #
def segmented_mean(scores: Tensor, empty: Tensor, qmask: Tensor, empty_target_action: str) -> Tensor:
    """Mean over the queries present, with ``empty_target_action`` as masking
    ("error" is refused when the metric is built)."""
    if empty_target_action == "pos":
        scores = torch.where(empty, 1.0, scores)
        include = qmask
    elif empty_target_action == "neg":
        scores = torch.where(empty, 0.0, scores)
        include = qmask
    else:  # "skip"
        include = qmask & ~empty
    n = torch.sum(include, dtype=torch.int32)
    return torch.where(n > 0, torch.sum(torch.where(include, scores, 0.0)) / torch.clamp(n, min=1), 0.0)
