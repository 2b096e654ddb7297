"""Dice (counterpart of ``metrics_tpu/classification/dice.py``), on the
stat-scores state."""
from __future__ import annotations

from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.classification.stat_scores import StatScores
from metrics_tpu_torch.ops.classification.dice import _dice_compute
from metrics_tpu_torch.utils.checks import _check_arg_choice


class Dice(StatScores):
    """Dice score.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Dice
        >>> preds = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> dice = Dice(average="micro", device="cpu")
        >>> dice.update(preds, target)
        >>> round(float(dice.compute()), 4)
        0.25
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False

    def __init__(
        self,
        zero_division: int = 0,
        num_classes: Optional[int] = None,
        threshold: float = 0.5,
        average: Optional[str] = "micro",
        mdmc_average: Optional[str] = "global",
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        multiclass: Optional[bool] = None,
        **kwargs: Any,
    ) -> None:
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
        self.zero_division = zero_division

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._get_final_stats()
        return _dice_compute(tp, fp, fn, self.average, self.mdmc_reduce, self.zero_division)
