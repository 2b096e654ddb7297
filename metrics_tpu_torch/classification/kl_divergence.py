"""KLDivergence (counterpart of ``metrics_tpu/classification/kl_divergence.py``).

``"mean"`` and ``"sum"`` keep a float32 running sum; ``"none"``/``None``
keep every row's divergence in a ``cat`` state, a list, or a
:class:`~metrics_tpu_torch.core.buffers.CatBuffer` under ``buffer_capacity``.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.ops.classification.kl_divergence import _kld_compute, _kld_update
from metrics_tpu_torch.utils.data import append_cat, dim_zero_cat


class KLDivergence(Metric):
    """KL(P || Q) over batches of distributions.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import KLDivergence
        >>> p = torch.tensor([[0.36, 0.48, 0.16]])
        >>> q = torch.tensor([[1 / 3, 1 / 3, 1 / 3]])
        >>> kl = KLDivergence(device="cpu")
        >>> kl.update(p, q)
        >>> round(float(kl.compute()), 4)
        0.0853
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update: bool = False

    def __init__(self, log_prob: bool = False, reduction: Optional[str] = "mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(log_prob, bool):
            raise TypeError(f"Expected argument `log_prob` to be bool but got {log_prob}")
        allowed_reduction = ["mean", "sum", "none", None]
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction} but got {reduction}")
        self.log_prob = log_prob
        self.reduction = reduction

        if self.reduction in ["mean", "sum"]:
            self.add_state("measures", torch.tensor(0.0), dist_reduce_fx="sum")
        else:
            self.add_state("measures", [], dist_reduce_fx="cat")
        self.add_state("total", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, p: Tensor, q: Tensor) -> None:  # type: ignore[override]
        measures, total = _kld_update(p, q, self.log_prob)
        if self.reduction is None or self.reduction == "none":
            self.measures = append_cat(self.measures, measures)
        else:
            self.measures = self.measures + measures.sum()
        self.total = self.total + total

    def compute(self) -> Tensor:
        measures = dim_zero_cat(self.measures) if self.reduction in ["none", None] else self.measures
        return _kld_compute(measures, self.total, self.reduction)
