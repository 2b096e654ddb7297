"""Feature-extractor resolution shared by FID, IS and KID (counterpart of
``metrics_tpu/image/_extractor.py``).

An int (or tap name) builds the port's InceptionV3 with weights from, in
order: the ``variables`` argument (the module's state dict), a torch
checkpoint at ``$METRICS_TPU_INCEPTION_WEIGHTS`` (the route the JAX package
reads), or seeded random weights with a loud warning. A callable
``imgs -> [N, d]`` is used as it is.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Optional

import torch

from metrics_tpu_torch.utils.prints import rank_zero_warn

_WEIGHTS_ENV = "METRICS_TPU_INCEPTION_WEIGHTS"


def _load_env_weights() -> Optional[dict]:
    path = os.environ.get(_WEIGHTS_ENV)
    if not path or not os.path.exists(path):
        return None
    from metrics_tpu_torch.nets.inception import load_inception_torch_state_dict

    return load_inception_torch_state_dict(torch.load(path, map_location="cpu"))


def resolve_feature_extractor(
    feature: Any,
    metric_name: str,
    valid_features: tuple,
    variables: Optional[dict] = None,
    device: Optional[torch.device] = None,
) -> Callable:
    """A callable ``imgs -> [N, d]``, wrapped in a
    :class:`~metrics_tpu_torch.ops.kernels.BucketedFeatureExtractor` unless
    it opts out with ``row_independent = False``. A built InceptionV3 lives
    on ``device``."""
    from metrics_tpu_torch.ops.kernels.features import maybe_bucketed

    if callable(feature):
        return maybe_bucketed(feature, True)
    if not isinstance(feature, (int, str)):
        raise TypeError("Got unknown input to argument `feature`")
    if feature not in valid_features:
        raise ValueError(
            f"Integer input to argument `feature` must be one of {valid_features}, but got {feature}."
        )
    from metrics_tpu_torch.nets.inception import InceptionV3FeatureExtractor

    if variables is None:
        variables = _load_env_weights()
    if variables is None:
        rank_zero_warn(
            f"Metric `{metric_name}` is using a randomly initialized InceptionV3: no `variables` were"
            f" given and ${_WEIGHTS_ENV} does not point to a checkpoint. Scores will NOT be comparable"
            " to published numbers; pass converted weights for that.",
            UserWarning,
        )
    return maybe_bucketed(InceptionV3FeatureExtractor(feature, variables=variables, device=device), True)


def move_extractor(extractor: Any, device: torch.device) -> None:
    """Move a built net (bucketed or not) to ``device``; a user's callable is left alone."""
    inner = getattr(extractor, "__wrapped__", extractor)
    if hasattr(inner, "module") and hasattr(inner, "to"):
        inner.to(device)
