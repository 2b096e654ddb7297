"""The retrieval metric template (counterpart of
``metrics_tpu/retrieval/base.py``): accumulate ``(indexes, preds, target)``,
group the rows by query at ``compute()`` and average a per-query score.

Two evaluation paths, as in the JAX package:

- **Eager** (the default): the rows are grouped by query
  (:func:`~metrics_tpu_torch.utils.data.get_group_indexes`, first-seen order)
  and each query is scored by its single-query functional in a Python loop,
  with one read of its target sum to find an empty query.
- **Compiled**: with ``max_queries=Q, max_docs_per_query=D`` the evaluation
  is one fixed sequence of device operations (sort, scatter into dense
  ``(Q, D)`` matrices, masked row scoring; :mod:`~metrics_tpu_torch.ops.
  retrieval.segmented`). With ``buffer_capacity=N`` as well, ``update()`` and
  ``compute()`` are both captured by the engines. Exceeding the bounds raises
  eager and gives NaN in a captured compute, never a silently truncated value.

The states are flat ``dist_reduce_fx=None`` lists, or buffers under
``buffer_capacity`` (``bufferable=True``); the JAX package's ``shard_axis=0``
declaration on them waits for sharded state (ROADMAP A17b).
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, List, Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.core.buffers import CatBuffer
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.ops.retrieval import segmented as _seg
from metrics_tpu_torch.utils.checks import _capturing, _check_arg_choice, _check_retrieval_inputs
from metrics_tpu_torch.utils.data import append_cat, dim_zero_cat, get_group_indexes
from metrics_tpu_torch.utils.exceptions import MetricsUserError


class RetrievalMetric(Metric, ABC):
    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False

    indexes: List[Tensor]
    preds: List[Tensor]
    target: List[Tensor]

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        max_queries: Optional[int] = None,
        max_docs_per_query: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.allow_non_binary_target = False

        _check_arg_choice(empty_target_action, "empty_target_action", ("error", "skip", "neg", "pos"))
        self.empty_target_action = empty_target_action

        if ignore_index is not None and not isinstance(ignore_index, int):
            raise ValueError("Argument `ignore_index` must be an integer or None.")
        self.ignore_index = ignore_index

        if (max_queries is None) != (max_docs_per_query is None):
            raise ValueError("Arguments `max_queries` and `max_docs_per_query` must be set together.")
        if max_queries is not None:
            if not (isinstance(max_queries, int) and max_queries > 0
                    and isinstance(max_docs_per_query, int) and max_docs_per_query > 0):
                raise ValueError("`max_queries` and `max_docs_per_query` must be positive integers.")
            if empty_target_action == "error":
                raise ValueError(
                    "empty_target_action='error' is incompatible with the compiled evaluation path "
                    "(no data-dependent raises inside a captured compute); use 'skip', 'neg' or 'pos'."
                )
        self.max_queries = max_queries
        self.max_docs_per_query = max_docs_per_query

        # buffers under buffer_capacity, shardable along the sample axis
        shard_axis = 0 if self.buffer_capacity is not None else None
        self.add_state("indexes", default=[], dist_reduce_fx=None, bufferable=True, shard_axis=shard_axis)
        self.add_state("preds", default=[], dist_reduce_fx=None, bufferable=True, shard_axis=shard_axis)
        self.add_state("target", default=[], dist_reduce_fx=None, bufferable=True, shard_axis=shard_axis)

    def update(self, preds: Tensor, target: Tensor, indexes: Tensor) -> None:  # type: ignore[override]
        if indexes is None:
            raise ValueError("Argument `indexes` cannot be None")
        indexes, preds, target = _check_retrieval_inputs(
            indexes, preds, target, allow_non_binary_target=self.allow_non_binary_target, ignore_index=self.ignore_index
        )
        self.indexes = append_cat(self.indexes, indexes)
        self.preds = append_cat(self.preds, preds)
        self.target = append_cat(self.target, target)

    def compute(self) -> Tensor:
        if self.max_queries is not None:
            return self._compute_segmented()

        indexes = dim_zero_cat(self.indexes)
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)

        res = []
        fill = {"pos": preds.new_ones(()), "neg": preds.new_zeros(())}.get(self.empty_target_action)
        for group in get_group_indexes(indexes):
            mini_preds = preds[group]
            mini_target = target[group]
            if self._is_empty_query(mini_target):
                if self.empty_target_action == "error":
                    raise ValueError(f"`compute` method was provided with a query with no {self._empty_kind} target.")
                if fill is not None:
                    res.append(fill)
            else:
                res.append(self._metric(mini_preds, mini_target))
        return torch.mean(torch.stack(res)) if res else preds.new_zeros(())

    # ------------------------------------------------------------------ #
    # compiled evaluation (static (max_queries, max_docs_per_query) bounds)
    # ------------------------------------------------------------------ #
    def _flat_with_mask(self, name: str) -> Tuple[Tensor, Optional[Tensor], Tensor]:
        """``(values, valid, overflowed)`` of one state: a buffer gives its
        whole static data and its row mask (capturable), a list its
        concatenation."""
        val = getattr(self, name)
        if isinstance(val, CatBuffer):
            if not val.materialized:
                raise MetricsUserError("`compute` called before any `update`; no retrieval state accumulated.")
            # a buffer whose count outran its capacity has a corrupt tail: its
            # sticky flag poisons the compiled result as to_array() raises eager
            overflowed = val.overflowed | (val.count > val.capacity)
            if not _capturing() and (val.overflow_seen or len(val) > val.capacity):
                raise MetricsUserError(
                    f"Retrieval state {name!r} overflowed its buffer_capacity ({val.capacity}) "
                    "inside a compiled program; raise `buffer_capacity` to cover the evaluated corpus."
                )
            return val.data, val.valid_mask(), overflowed
        flat = dim_zero_cat(val)
        return flat, None, torch.zeros((), dtype=torch.bool, device=flat.device)

    def _compute_segmented(self) -> Tensor:
        indexes, valid, over_i = self._flat_with_mask("indexes")
        preds, _, over_p = self._flat_with_mask("preds")
        target, _, over_t = self._flat_with_mask("target")
        p_mat, t_mat, m_mat, qmask, overflow = _seg.bucketize_queries(
            indexes, preds, target, valid, self.max_queries, self.max_docs_per_query
        )
        overflow = overflow | over_i | over_p | over_t
        if not _capturing() and bool(overflow):
            raise MetricsUserError(
                f"Compiled retrieval evaluation overflowed its static bounds "
                f"(max_queries={self.max_queries}, max_docs_per_query={self.max_docs_per_query}); "
                "raise them to cover the evaluated corpus."
            )
        scores = self._metric_rows(p_mat, t_mat, m_mat)
        empty = self._empty_rows(t_mat, m_mat) & qmask
        mean = _seg.segmented_mean(scores, empty, qmask, self.empty_target_action)
        return torch.where(overflow, torch.nan, mean)

    def _empty_rows(self, t_mat: Tensor, m_mat: Tensor) -> Tensor:
        """The compiled path's empty queries: no positive document."""
        return torch.sum(torch.where(m_mat, t_mat, 0), dim=1) == 0

    def _metric_rows(self, p_mat: Tensor, t_mat: Tensor, m_mat: Tensor) -> Tensor:
        """(Q,) scores for the compiled path; overridden by subclasses."""
        raise NotImplementedError(
            f"{type(self).__name__} has no compiled evaluation path; drop the `max_queries` argument."
        )

    # what makes a query empty: no positive document for most metrics;
    # FallOut inverts it to "no negative document"
    _empty_kind = "positive"

    def _is_empty_query(self, target: Tensor) -> bool:
        return not float(torch.sum(target))

    @abstractmethod
    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        """Score one query; overridden by subclasses."""
