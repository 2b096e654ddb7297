"""UQI, SpectralDistortionIndex, ERGAS and SpectralAngleMapper (counterpart
of ``metrics_tpu/image/quality.py``): image batches in ``cat`` states, the
functional at compute."""
from __future__ import annotations

from typing import Any, Optional, Sequence, Union

from torch import Tensor

from metrics_tpu_torch.image.base import _ImagePairMetric
from metrics_tpu_torch.ops.image.d_lambda import (
    _spectral_distortion_index_check_inputs,
    _spectral_distortion_index_compute,
)
from metrics_tpu_torch.ops.image.ergas import _ergas_check_inputs, _ergas_compute
from metrics_tpu_torch.ops.image.sam import _sam_check_inputs, _sam_compute
from metrics_tpu_torch.ops.image.uqi import _uqi_check_inputs, _uqi_compute


class UniversalImageQualityIndex(_ImagePairMetric):
    """UQI.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import UniversalImageQualityIndex
        >>> imgs = torch.linspace(0.0, 1.0, 2 * 1 * 16 * 16).reshape(2, 1, 16, 16)
        >>> uqi = UniversalImageQualityIndex(device="cpu")
        >>> uqi.update(imgs, imgs)
        >>> round(float(uqi.compute()), 4)
        1.0
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        kernel_size: Sequence[int] = (11, 11),
        sigma: Sequence[float] = (1.5, 1.5),
        reduction: Optional[str] = "elementwise_mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.kernel_size = kernel_size
        self.sigma = sigma
        self.reduction = reduction

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        preds, target = _uqi_check_inputs(preds, target)
        self._append(preds, target)

    def compute(self) -> Tensor:
        preds, target = self._cat_states()
        return _uqi_compute(preds, target, self.kernel_size, self.sigma, self.reduction)


class SpectralDistortionIndex(_ImagePairMetric):
    """D-lambda.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SpectralDistortionIndex
        >>> imgs = torch.linspace(0.0, 1.0, 1 * 3 * 16 * 16).reshape(1, 3, 16, 16)
        >>> sdi = SpectralDistortionIndex(device="cpu")
        >>> sdi.update(imgs, imgs)
        >>> round(float(sdi.compute()), 4)
        0.0
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, p: int = 1, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(p, int) or p <= 0:
            raise ValueError(f"Expected `p` to be a positive integer. Got p: {p}.")
        self.p = p
        if reduction not in ("elementwise_mean", "sum", "none"):
            raise ValueError(f"Expected argument `reduction` be one of ['elementwise_mean','sum','none'] but got {reduction}")
        self.reduction = reduction

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        preds, target = _spectral_distortion_index_check_inputs(preds, target)
        self._append(preds, target)

    def compute(self) -> Tensor:
        preds, target = self._cat_states()
        return _spectral_distortion_index_compute(preds, target, self.p, self.reduction)


class ErrorRelativeGlobalDimensionlessSynthesis(_ImagePairMetric):
    """ERGAS.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ErrorRelativeGlobalDimensionlessSynthesis
        >>> target = torch.ones(1, 1, 2, 2)
        >>> ergas = ErrorRelativeGlobalDimensionlessSynthesis(device="cpu")
        >>> ergas.update(target * 1.1, target)
        >>> round(float(ergas.compute()), 4)
        40.0
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
        ratio: Union[int, float] = 4,
        reduction: Optional[str] = "elementwise_mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.ratio = ratio
        self.reduction = reduction

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        preds, target = _ergas_check_inputs(preds, target)
        self._append(preds, target)

    def compute(self) -> Tensor:
        preds, target = self._cat_states()
        return _ergas_compute(preds, target, self.ratio, self.reduction)


class SpectralAngleMapper(_ImagePairMetric):
    """SAM, in radians.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SpectralAngleMapper
        >>> sam = SpectralAngleMapper(device="cpu")
        >>> sam.update(torch.tensor([[[[1.0]], [[0.0]]]]), torch.tensor([[[[0.0]], [[1.0]]]]))
        >>> round(float(sam.compute()), 4)
        1.5708
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.reduction = reduction

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        preds, target = _sam_check_inputs(preds, target)
        self._append(preds, target)

    def compute(self) -> Tensor:
        preds, target = self._cat_states()
        return _sam_compute(preds, target, self.reduction)
