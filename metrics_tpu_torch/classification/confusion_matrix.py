"""ConfusionMatrix (counterpart of ``metrics_tpu/classification/confusion_matrix.py``).

Its int32 ``confmat`` state is the one JaccardIndex, MatthewsCorrCoef and
CohenKappa hold: with equal arguments the four share one compute group
(``_update_signature``). The JAX package's ``shard_axis`` and sharded
compute have no counterpart here (ROADMAP A17b).
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.ops.classification.confusion_matrix import (
    _confusion_matrix_compute,
    _confusion_matrix_update,
)
from metrics_tpu_torch.utils.checks import _check_arg_choice


class ConfusionMatrix(Metric):
    """Confusion matrix.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ConfusionMatrix
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> confmat = ConfusionMatrix(num_classes=2, device="cpu")
        >>> confmat.update(preds, target)
        >>> confmat.compute().tolist()
        [[2, 0], [1, 1]]
    """

    is_differentiable = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def __init__(
        self,
        num_classes: int,
        normalize: Optional[str] = None,
        threshold: float = 0.5,
        multilabel: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.normalize = normalize
        self.threshold = threshold
        self.multilabel = multilabel

        _check_arg_choice(normalize, "normalize", ("true", "pred", "all", "none", None))

        shape = (num_classes, 2, 2) if multilabel else (num_classes, num_classes)
        # shardable along the true-class axis: a 4096-class matrix over 8
        # ranks keeps a (512, 4096) block on each after shard_state()
        self.add_state("confmat", default=torch.zeros(shape, dtype=torch.int32), dist_reduce_fx="sum", shard_axis=0)

    def _update_signature(self):
        return ("confmat", self.num_classes, self.threshold, self.multilabel)

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        confmat = _confusion_matrix_update(preds, target, self.num_classes, self.threshold, self.multilabel)
        self.confmat = self.confmat + confmat

    def compute(self) -> Tensor:
        return _confusion_matrix_compute(self.confmat, self.normalize)

    def compute_sharded_state(self, state, group) -> Tensor:
        # finalize the local row block; only the (normalized) result moves
        return _confusion_matrix_compute(state["confmat"], self.normalize, group)
