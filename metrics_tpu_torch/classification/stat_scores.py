"""StatScores module, the shared tp/fp/tn/fn engine (counterpart of
``metrics_tpu/classification/stat_scores.py``).

Subclasses (Accuracy, Precision, Recall, F1, FBeta) share this int32 state
layout; with equal init args they land in one static compute group
(``_update_signature``), so a MetricCollection updates it once per step.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.parallel import sync as _psync
from metrics_tpu_torch.ops.classification.stat_scores import _stat_scores_compute, _stat_scores_update


class StatScores(Metric):
    """True/false positives and negatives plus support, any reduce mode.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import StatScores
        >>> preds = torch.tensor([1, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> stat_scores = StatScores(reduce='micro', device="cpu")
        >>> stat_scores.update(preds, target)
        >>> stat_scores.compute().tolist()  # [tp, fp, tn, fn, support]
        [2, 2, 6, 2, 4]
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def __init__(
        self,
        threshold: float = 0.5,
        top_k: Optional[int] = None,
        reduce: str = "micro",
        num_classes: Optional[int] = None,
        ignore_index: Optional[int] = None,
        mdmc_reduce: Optional[str] = None,
        multiclass: Optional[bool] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.reduce = reduce
        self.mdmc_reduce = mdmc_reduce
        self.num_classes = num_classes
        self.threshold = threshold
        self.multiclass = multiclass
        self.ignore_index = ignore_index
        self.top_k = top_k

        if reduce not in ["micro", "macro", "samples"]:
            raise ValueError(f"The `reduce` {reduce} is not valid.")
        if mdmc_reduce not in [None, "samplewise", "global"]:
            raise ValueError(f"The `mdmc_reduce` {mdmc_reduce} is not valid.")
        if reduce == "macro" and (not num_classes or num_classes < 1):
            raise ValueError("reduce='macro' requires `num_classes` to be set.")
        if num_classes and ignore_index is not None and (not ignore_index < num_classes or num_classes == 1):
            raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")

        for s in ("tp", "fp", "tn", "fn"):
            if mdmc_reduce != "samplewise" and reduce != "samples":
                shape = [] if reduce == "micro" else [num_classes]
                # per-class count vectors shard along the class axis; the
                # micro layout is a scalar and stays replicated
                self.add_state(s, default=torch.zeros(shape, dtype=torch.int32), dist_reduce_fx="sum",
                               shard_axis=None if reduce == "micro" else 0)
            else:
                self.add_state(s, default=[], dist_reduce_fx="cat")

        # sum-reduced counts are additive over masked rows, so the compiled
        # update may pad ragged batches and pass a validity mask; the cat
        # layouts (samples / samplewise) would append the padded rows
        self._accepts_sample_mask = reduce != "samples" and mdmc_reduce != "samplewise"

    def _update_signature(self):
        """Stat-scores family compute-group key: equal args => identical state."""
        return (
            "stat-scores", self.reduce, self.mdmc_reduce, self.num_classes,
            self.threshold, self.multiclass, self.ignore_index, self.top_k,
        )

    def _accumulate(self, tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> None:
        if self.reduce != "samples" and self.mdmc_reduce != "samplewise":
            self.tp = self.tp + tp
            self.fp = self.fp + fp
            self.tn = self.tn + tn
            self.fn = self.fn + fn
        else:
            self.tp = self.tp + [tp]
            self.fp = self.fp + [fp]
            self.tn = self.tn + [tn]
            self.fn = self.fn + [fn]

    def update(self, preds: Tensor, target: Tensor, sample_mask: Optional[Tensor] = None) -> None:  # type: ignore[override]
        tp, fp, tn, fn = _stat_scores_update(
            preds, target, reduce=self.reduce, mdmc_reduce=self.mdmc_reduce,
            threshold=self.threshold, num_classes=self.num_classes, top_k=self.top_k,
            multiclass=self.multiclass, ignore_index=self.ignore_index, sample_mask=sample_mask,
        )
        self._accumulate(tp, fp, tn, fn)

    def _get_final_stats(self) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        tp = torch.cat(self.tp) if isinstance(self.tp, list) else self.tp
        fp = torch.cat(self.fp) if isinstance(self.fp, list) else self.fp
        tn = torch.cat(self.tn) if isinstance(self.tn, list) else self.tn
        fn = torch.cat(self.fn) if isinstance(self.fn, list) else self.fn
        return tp, fp, tn, fn

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._get_final_stats()
        return _stat_scores_compute(tp, fp, tn, fn)

    def compute_sharded_state(self, state, group) -> Tensor:
        # the macro layout (the only one that shards): the (C, 5) stack is
        # elementwise per class, so the block finalizes in place and one
        # result gather rebuilds the class dimension, bit for bit
        block = _stat_scores_compute(state["tp"], state["fp"], state["tn"], state["fn"])
        return _psync.gather_result(block, group, axis=0)
