"""PerceptualEvaluationSpeechQuality (counterpart of
``metrics_tpu/audio/pesq.py``): the ``pesq`` C extension on the host by
default, gated on its presence at construction, or the native model on the
state's device (``implementation="native"``)."""
from __future__ import annotations

from typing import Any

from torch import Tensor

from metrics_tpu_torch.audio.base import _MeanAudioMetric
from metrics_tpu_torch.ops.audio import pesq as _pesq_ops
from metrics_tpu_torch.utils.checks import _check_arg_choice


class PerceptualEvaluationSpeechQuality(_MeanAudioMetric):
    """PESQ, the mean MOS over every sample seen.

    The default backend is the ``pesq`` C extension, and construction raises
    ``ModuleNotFoundError`` without it; ``implementation="native"`` runs the
    native perceptual model (``ops/audio/pesq_native.py``) on the device,
    and rejects ``fs=8000`` with ``mode="wb"`` at construction.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import PerceptualEvaluationSpeechQuality
        >>> t = torch.arange(16000, dtype=torch.float32) / 8000
        >>> target = torch.sin(2 * torch.pi * 440 * t) * torch.sin(2 * torch.pi * 3 * t)
        >>> preds = target + 0.1 * torch.sin(2 * torch.pi * 1234 * t)
        >>> nb_pesq = PerceptualEvaluationSpeechQuality(8000, "nb", implementation="native", device="cpu")
        >>> nb_pesq.update(preds, target)
        >>> round(float(nb_pesq.compute()), 2)
        4.25
    """

    is_differentiable = False
    higher_is_better = True

    def __init__(self, fs: int, mode: str, implementation: str = "pesq", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_arg_choice(implementation, "implementation", ("pesq", "native"))
        self.implementation = implementation
        if implementation == "pesq" and not _pesq_ops._PESQ_AVAILABLE:
            raise ModuleNotFoundError(
                "PerceptualEvaluationSpeechQuality metric requires that `pesq` is installed."
                " Either install as `pip install metrics-tpu[audio]` or `pip install pesq`,"
                " or construct with implementation='native' for the on-device model."
            )
        if fs not in (8000, 16000):
            raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
        self.fs = fs
        if mode not in ("wb", "nb"):
            raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
        # the C extension rejects fs=8000 with mode="wb" at update time; the
        # native model, which has no such backend check, rejects it here
        if implementation == "native" and fs == 8000 and mode == "wb":
            raise ValueError("Expected argument `mode` to be 'nb' for a 8000Hz signal")
        self.mode = mode

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        scores = _pesq_ops.perceptual_evaluation_speech_quality(
            preds, target, self.fs, self.mode, implementation=self.implementation
        )
        self._accumulate(scores.to(self.sum_metric.device))
