"""FBetaScore and F1Score modules (counterpart of
``metrics_tpu/classification/f_beta.py``)."""
from __future__ import annotations

from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.classification.stat_scores import StatScores
from metrics_tpu_torch.ops.classification.f_beta import _fbeta_compute
from metrics_tpu_torch.utils.checks import _check_arg_choice


class FBetaScore(StatScores):
    """F-beta: recall weighted ``beta``-times as much as precision.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import FBetaScore
        >>> preds = torch.tensor([0, 2, 1, 0, 0, 1])
        >>> target = torch.tensor([0, 1, 2, 0, 1, 2])
        >>> f_beta = FBetaScore(num_classes=3, beta=0.5, device="cpu")
        >>> f_beta.update(preds, target)
        >>> round(float(f_beta.compute()), 4)
        0.3333
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False

    def __init__(
        self,
        num_classes: Optional[int] = None,
        beta: float = 1.0,
        threshold: float = 0.5,
        average: Optional[str] = "micro",
        mdmc_average: Optional[str] = None,
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        multiclass: Optional[bool] = None,
        **kwargs: Any,
    ) -> None:
        self.beta = beta
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
        self.average = average

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._get_final_stats()
        return _fbeta_compute(tp, fp, tn, fn, self.beta, self.ignore_index, self.average, self.mdmc_reduce)


class F1Score(FBetaScore):
    """F-beta with beta=1.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import F1Score
        >>> target = torch.tensor([0, 1, 2, 0, 1, 2])
        >>> preds = torch.tensor([0, 2, 1, 0, 0, 1])
        >>> f1 = F1Score(num_classes=3, device="cpu")
        >>> f1.update(preds, target)
        >>> round(float(f1.compute()), 4)
        0.3333
    """

    def __init__(
        self,
        num_classes: Optional[int] = None,
        threshold: float = 0.5,
        average: Optional[str] = "micro",
        mdmc_average: Optional[str] = None,
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        multiclass: Optional[bool] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes,
            beta=1.0,
            threshold=threshold,
            average=average,
            mdmc_average=mdmc_average,
            ignore_index=ignore_index,
            top_k=top_k,
            multiclass=multiclass,
            **kwargs,
        )
