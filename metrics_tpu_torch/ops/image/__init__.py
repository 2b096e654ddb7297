"""Functional image metrics (counterpart of ``metrics_tpu/ops/image``)."""
from metrics_tpu_torch.ops.image.d_lambda import spectral_distortion_index
from metrics_tpu_torch.ops.image.ergas import error_relative_global_dimensionless_synthesis
from metrics_tpu_torch.ops.image.gradients import image_gradients
from metrics_tpu_torch.ops.image.psnr import peak_signal_noise_ratio
from metrics_tpu_torch.ops.image.sam import spectral_angle_mapper
from metrics_tpu_torch.ops.image.ssim import (
    multiscale_structural_similarity_index_measure,
    structural_similarity_index_measure,
)
from metrics_tpu_torch.ops.image.uqi import universal_image_quality_index

__all__ = [
    "error_relative_global_dimensionless_synthesis",
    "image_gradients",
    "multiscale_structural_similarity_index_measure",
    "peak_signal_noise_ratio",
    "spectral_angle_mapper",
    "spectral_distortion_index",
    "structural_similarity_index_measure",
    "universal_image_quality_index",
]
