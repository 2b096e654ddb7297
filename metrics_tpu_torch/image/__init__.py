"""Image metrics (counterpart of ``metrics_tpu/image``)."""
from metrics_tpu_torch.image.fid import FrechetInceptionDistance
from metrics_tpu_torch.image.inception import InceptionScore
from metrics_tpu_torch.image.kid import KernelInceptionDistance
from metrics_tpu_torch.image.lpip import LearnedPerceptualImagePatchSimilarity
from metrics_tpu_torch.image.psnr import PeakSignalNoiseRatio
from metrics_tpu_torch.image.quality import (
    ErrorRelativeGlobalDimensionlessSynthesis,
    SpectralAngleMapper,
    SpectralDistortionIndex,
    UniversalImageQualityIndex,
)
from metrics_tpu_torch.image.ssim import (
    MultiScaleStructuralSimilarityIndexMeasure,
    StructuralSimilarityIndexMeasure,
)

__all__ = [
    "ErrorRelativeGlobalDimensionlessSynthesis",
    "FrechetInceptionDistance",
    "InceptionScore",
    "KernelInceptionDistance",
    "LearnedPerceptualImagePatchSimilarity",
    "MultiScaleStructuralSimilarityIndexMeasure",
    "PeakSignalNoiseRatio",
    "SpectralAngleMapper",
    "SpectralDistortionIndex",
    "StructuralSimilarityIndexMeasure",
    "UniversalImageQualityIndex",
]
