"""SignalNoiseRatio and ScaleInvariantSignalNoiseRatio (counterpart of
``metrics_tpu/audio/snr.py``)."""
from __future__ import annotations

from typing import Any

from torch import Tensor

from metrics_tpu_torch.audio.base import _MeanAudioMetric
from metrics_tpu_torch.ops.audio.snr import scale_invariant_signal_noise_ratio, signal_noise_ratio


class SignalNoiseRatio(_MeanAudioMetric):
    """SNR, the mean over every sample seen.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SignalNoiseRatio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> snr = SignalNoiseRatio(device="cpu")
        >>> snr.update(preds, target)
        >>> round(float(snr.compute()), 4)
        16.1805
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        self._accumulate(signal_noise_ratio(preds=preds, target=target, zero_mean=self.zero_mean))


class ScaleInvariantSignalNoiseRatio(_MeanAudioMetric):
    """SI-SNR, the mean over every sample seen.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ScaleInvariantSignalNoiseRatio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> si_snr = ScaleInvariantSignalNoiseRatio(device="cpu")
        >>> si_snr.update(preds, target)
        >>> round(float(si_snr.compute()), 4)
        15.0918
    """

    is_differentiable = True
    higher_is_better = True

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        self._accumulate(scale_invariant_signal_noise_ratio(preds=preds, target=target))
