"""CosineSimilarity and TweedieDevianceScore (counterpart of
``metrics_tpu/regression/other.py``).

CosineSimilarity keeps its rows in ``cat`` states: lists, or
:class:`~metrics_tpu_torch.core.buffers.CatBuffer` states under
``buffer_capacity``, whose update is captured while the compute, which
reads the filled rows, stays eager.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.ops.regression.other import (
    _cosine_similarity_compute,
    _cosine_similarity_update,
    _tweedie_deviance_score_compute,
    _tweedie_deviance_score_update,
)
from metrics_tpu_torch.utils.checks import _check_arg_choice
from metrics_tpu_torch.utils.data import append_cat, dim_zero_cat


class CosineSimilarity(Metric):
    """Row-wise cosine similarity, reduced over every row seen.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import CosineSimilarity
        >>> target = torch.tensor([[0.0, 1.0], [1.0, 1.0]])
        >>> preds = torch.tensor([[0.0, 1.0], [0.0, 1.0]])
        >>> cosine = CosineSimilarity(reduction="mean", device="cpu")
        >>> cosine.update(preds, target)
        >>> round(float(cosine.compute()), 4)
        0.8536
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(self, reduction: Optional[str] = "sum", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_arg_choice(reduction, "reduction", ("sum", "mean", "none", None))
        self.reduction = reduction
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        preds, target = _cosine_similarity_update(preds, target)
        self.preds = append_cat(self.preds, preds)
        self.target = append_cat(self.target, target)

    def compute(self) -> Tensor:
        return _cosine_similarity_compute(dim_zero_cat(self.preds), dim_zero_cat(self.target), self.reduction)


class TweedieDevianceScore(Metric):
    """Mean Tweedie deviance for a given ``power``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import TweedieDevianceScore
        >>> preds = torch.tensor([1.0, 2.0, 3.0, 4.0])
        >>> target = torch.tensor([1.5, 2.5, 3.5, 4.5])
        >>> deviance = TweedieDevianceScore(power=2, device="cpu")
        >>> deviance.update(preds, target)
        >>> round(float(deviance.compute()), 4)
        0.0706
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, power: float = 0.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if 0 < power < 1:
            raise ValueError(f"Deviance Score is not defined for power={power}.")
        self.power = power
        self.add_state("sum_deviance_score", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("num_observations", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, targets: Tensor) -> None:  # type: ignore[override]
        sum_deviance_score, num_observations = _tweedie_deviance_score_update(preds, targets, self.power)
        self.sum_deviance_score = self.sum_deviance_score + sum_deviance_score
        self.num_observations = self.num_observations + num_observations

    def compute(self) -> Tensor:
        return _tweedie_deviance_score_compute(self.sum_deviance_score, self.num_observations)
