"""Spectral Distortion Index, D-lambda (counterpart of
``metrics_tpu/ops/image/d_lambda.py``).

All C*(C+1)/2 channel pairs are stacked into one (B, P, H, W) pair of
tensors and scored by one depthwise convolution, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.ops.image.helper import _check_image_pair
from metrics_tpu_torch.ops.image.uqi import _uqi_map
from metrics_tpu_torch.utils.compute import reduce


def _spectral_distortion_index_check_inputs(preds: Tensor, target: Tensor):
    return _check_image_pair(preds, target, names=("ms", "fused"))


def _pairwise_uqi_matrix(x: Tensor) -> Tensor:
    """(C, C) symmetric matrix of UQI between every channel pair of ``x``."""
    length = x.shape[1]
    idx_k, idx_r = (torch.as_tensor(i, device=x.device) for i in np.triu_indices(length))
    # every unique pair stacked in the channel dim: one conv for the whole matrix
    pair_vals = _uqi_map(x.index_select(1, idx_k), x.index_select(1, idx_r)).mean(dim=(0, 2, 3))
    mat = torch.zeros((length, length), dtype=pair_vals.dtype, device=x.device)
    mat[idx_k, idx_r] = pair_vals
    mat[idx_r, idx_k] = pair_vals
    return mat


def _spectral_distortion_index_compute(
    preds: Tensor,
    target: Tensor,
    p: int = 1,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    length = preds.shape[1]
    m1 = _pairwise_uqi_matrix(target)
    m2 = _pairwise_uqi_matrix(preds)

    diff = torch.abs(m1 - m2) ** p
    if length == 1:
        output = diff ** (1.0 / p)
    else:
        output = (torch.sum(diff) / (length * (length - 1))) ** (1.0 / p)
    return reduce(output, reduction)


def spectral_distortion_index(
    preds: Tensor,
    target: Tensor,
    p: int = 1,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """Spectral Distortion Index.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import spectral_distortion_index
        >>> imgs = torch.linspace(0.0, 1.0, 1 * 3 * 16 * 16).reshape(1, 3, 16, 16)
        >>> round(float(spectral_distortion_index(imgs, imgs)), 4)
        0.0
    """
    if not isinstance(p, int) or p <= 0:
        raise ValueError(f"Expected `p` to be a positive integer. Got p: {p}.")
    preds, target = _spectral_distortion_index_check_inputs(preds, target)
    return _spectral_distortion_index_compute(preds, target, p, reduction)
