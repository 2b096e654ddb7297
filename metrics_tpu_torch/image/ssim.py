"""StructuralSimilarityIndexMeasure and MultiScaleStructuralSimilarityIndexMeasure
(counterpart of ``metrics_tpu/image/ssim.py``): image batches in ``cat``
states, the functional at compute."""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

from torch import Tensor

from metrics_tpu_torch.image.base import _ImagePairMetric
from metrics_tpu_torch.ops.image.ssim import (
    _MS_SSIM_BETAS,
    _multiscale_ssim_compute,
    _ssim_check_inputs,
    _ssim_compute,
)


class StructuralSimilarityIndexMeasure(_ImagePairMetric):
    """SSIM.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import StructuralSimilarityIndexMeasure
        >>> imgs = torch.linspace(0.0, 1.0, 1 * 1 * 16 * 16).reshape(1, 1, 16, 16)
        >>> ssim = StructuralSimilarityIndexMeasure(data_range=1.0, device="cpu")
        >>> ssim.update(imgs, imgs)
        >>> round(float(ssim.compute()), 4)
        1.0
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        gaussian_kernel: bool = True,
        sigma: Union[float, Sequence[float]] = 1.5,
        kernel_size: Union[int, Sequence[int]] = 11,
        reduction: Optional[str] = "elementwise_mean",
        data_range: Optional[float] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        return_full_image: bool = False,
        return_contrast_sensitivity: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.gaussian_kernel = gaussian_kernel
        self.sigma = sigma
        self.kernel_size = kernel_size
        self.reduction = reduction
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.return_full_image = return_full_image
        self.return_contrast_sensitivity = return_contrast_sensitivity

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        preds, target = _ssim_check_inputs(preds, target)
        self._append(preds, target)

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        preds, target = self._cat_states()
        return _ssim_compute(
            preds, target, self.gaussian_kernel, self.sigma, self.kernel_size, self.reduction, self.data_range,
            self.k1, self.k2, self.return_full_image, self.return_contrast_sensitivity,
        )


class MultiScaleStructuralSimilarityIndexMeasure(_ImagePairMetric):
    """MS-SSIM, the JAX package's per-image definition.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MultiScaleStructuralSimilarityIndexMeasure
        >>> imgs = torch.linspace(0.0, 1.0, 1 * 1 * 192 * 192).reshape(1, 1, 192, 192)
        >>> ms_ssim = MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, device="cpu")
        >>> ms_ssim.update(imgs, imgs)
        >>> round(float(ms_ssim.compute()), 4)
        1.0
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        gaussian_kernel: bool = True,
        kernel_size: Union[int, Sequence[int]] = 11,
        sigma: Union[float, Sequence[float]] = 1.5,
        reduction: Optional[str] = "elementwise_mean",
        data_range: Optional[float] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        betas: Tuple[float, ...] = _MS_SSIM_BETAS,
        normalize: Optional[str] = "relu",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not (isinstance(kernel_size, (Sequence, int))):
            raise ValueError("Argument `kernel_size` expected to be an sequence or an int")
        if not (isinstance(sigma, (Sequence, float))):
            raise ValueError("Argument `sigma` expected to be an sequence or a float")
        if not isinstance(betas, tuple):
            raise ValueError("Argument `betas` is expected to be of a type tuple.")
        if not all(isinstance(beta, float) for beta in betas):
            raise ValueError("Argument `betas` is expected to be a tuple of floats.")
        if normalize is not None and normalize not in ("relu", "simple"):
            raise ValueError("Argument `normalize` must be None, 'relu' or 'simple'")
        self.gaussian_kernel = gaussian_kernel
        self.kernel_size = kernel_size
        self.sigma = sigma
        self.reduction = reduction
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.betas = betas
        self.normalize = normalize

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        preds, target = _ssim_check_inputs(preds, target)
        self._append(preds, target)

    def compute(self) -> Tensor:
        preds, target = self._cat_states()
        return _multiscale_ssim_compute(
            preds, target, self.gaussian_kernel, self.sigma, self.kernel_size, self.reduction, self.data_range,
            self.k1, self.k2, self.betas, self.normalize,
        )
