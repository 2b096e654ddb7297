"""SignalDistortionRatio and ScaleInvariantSignalDistortionRatio
(counterpart of ``metrics_tpu/audio/sdr.py``)."""
from __future__ import annotations

from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.audio.base import _MeanAudioMetric
from metrics_tpu_torch.ops.audio.sdr import scale_invariant_signal_distortion_ratio, signal_distortion_ratio


class SignalDistortionRatio(_MeanAudioMetric):
    """SDR, the mean over every sample seen.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SignalDistortionRatio
        >>> t = torch.arange(8000, dtype=torch.float32) / 8000
        >>> target = torch.sin(2 * torch.pi * 440 * t) * torch.sin(2 * torch.pi * 3 * t)
        >>> preds = target + 0.1 * torch.sin(2 * torch.pi * 1234 * t)
        >>> sdr = SignalDistortionRatio(filter_length=64, device="cpu")
        >>> sdr.update(preds, target)
        >>> round(float(sdr.compute()), 2)
        16.99
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(
        self,
        use_cg_iter: Optional[int] = None,
        filter_length: int = 512,
        zero_mean: bool = False,
        load_diag: Optional[float] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.use_cg_iter = use_cg_iter
        self.filter_length = filter_length
        self.zero_mean = zero_mean
        self.load_diag = load_diag

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        self._accumulate(
            signal_distortion_ratio(preds, target, self.use_cg_iter, self.filter_length, self.zero_mean, self.load_diag)
        )


class ScaleInvariantSignalDistortionRatio(_MeanAudioMetric):
    """SI-SDR, the mean over every sample seen.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ScaleInvariantSignalDistortionRatio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> si_sdr = ScaleInvariantSignalDistortionRatio(device="cpu")
        >>> si_sdr.update(preds, target)
        >>> round(float(si_sdr.compute()), 4)
        18.403
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        self._accumulate(scale_invariant_signal_distortion_ratio(preds, target, self.zero_mean))
