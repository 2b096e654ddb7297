"""ShortTimeObjectiveIntelligibility (counterpart of
``metrics_tpu/audio/stoi.py``), over the tensor STOI of
``ops/audio/stoi.py``."""
from __future__ import annotations

from typing import Any

from torch import Tensor

from metrics_tpu_torch.audio.base import _MeanAudioMetric
from metrics_tpu_torch.ops.audio.stoi import short_time_objective_intelligibility


class ShortTimeObjectiveIntelligibility(_MeanAudioMetric):
    """STOI (``extended=True``: ESTOI), the mean over every sample seen. At
    ``fs != 10000`` each update resamples on the host, so its compiled update
    reverts to eager.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ShortTimeObjectiveIntelligibility
        >>> t = torch.arange(16000, dtype=torch.float32) / 8000
        >>> target = torch.sin(2 * torch.pi * 440 * t) * torch.sin(2 * torch.pi * 3 * t)
        >>> preds = target + 0.3 * torch.sin(2 * torch.pi * 1234 * t)
        >>> stoi = ShortTimeObjectiveIntelligibility(8000, device="cpu")
        >>> stoi.update(preds, target)
        >>> round(float(stoi.compute()), 3)
        0.815
    """

    is_differentiable = False
    higher_is_better = True

    def __init__(self, fs: int, extended: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if fs <= 0:
            raise ValueError(f"Expected argument `fs` to be a positive integer, but got {fs}")
        self.fs = fs
        self.extended = extended

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        self._accumulate(short_time_objective_intelligibility(preds, target, self.fs, self.extended))
