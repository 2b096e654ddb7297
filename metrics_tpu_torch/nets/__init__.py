"""Frozen feature-extractor networks for the model-based image metrics
(FID, IS, KID, LPIPS): counterpart of ``metrics_tpu/nets``, as torch modules."""
from metrics_tpu_torch.nets.inception import InceptionV3FeatureExtractor, load_inception_torch_state_dict
from metrics_tpu_torch.nets.lpips import LPIPSNet, load_lpips_torch_state_dict

__all__ = [
    "InceptionV3FeatureExtractor",
    "LPIPSNet",
    "load_inception_torch_state_dict",
    "load_lpips_torch_state_dict",
]
