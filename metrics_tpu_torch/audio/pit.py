"""PermutationInvariantTraining (counterpart of ``metrics_tpu/audio/pit.py``)."""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict

from torch import Tensor

from metrics_tpu_torch.audio.base import _MeanAudioMetric
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.ops.audio.pit import permutation_invariant_training

# every keyword of the port's Metric constructor (the device, the buffers,
# the sync and the engine switches); the rest go to ``metric_func``
_BASE_KWARGS = tuple(p for p in inspect.signature(Metric.__init__).parameters if p not in ("self", "kwargs"))


class PermutationInvariantTraining(_MeanAudioMetric):
    """PIT over any pairwise audio metric: the mean of each sample's best
    permutation's value.

    The keywords of the port's ``Metric`` constructor go to the base class;
    every other keyword is forwarded to ``metric_func``. (The JAX class pops
    only its five sync keywords, so an engine switch passed there reaches
    ``metric_func``.)

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import PermutationInvariantTraining
        >>> from metrics_tpu_torch.ops.audio import scale_invariant_signal_noise_ratio
        >>> t = torch.arange(16, dtype=torch.float32)
        >>> target = torch.stack([torch.stack([torch.sin(t), torch.cos(t)])] * 2)   # (batch, spk, time)
        >>> preds = torch.stack([target[0], target[1].flip(0)]) + 0.1 * torch.sin(3 * t)
        >>> pit = PermutationInvariantTraining(scale_invariant_signal_noise_ratio, device="cpu")
        >>> pit.update(preds, target)
        >>> round(float(pit.compute()), 2)
        19.2
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(self, metric_func: Callable, eval_func: str = "max", **kwargs: Any) -> None:
        base_kwargs: Dict[str, Any] = {k: kwargs.pop(k) for k in _BASE_KWARGS if k in kwargs}
        super().__init__(**base_kwargs)
        self.metric_func = metric_func
        self.eval_func = eval_func
        self.kwargs = kwargs

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        pit_metric = permutation_invariant_training(preds, target, self.metric_func, self.eval_func, **self.kwargs)[0]
        self._accumulate(pit_metric)
