"""Shared image helpers: separable gaussian kernels and the depthwise conv.

Counterpart of ``metrics_tpu/ops/image/helper.py``. The kernels are built on
the host from the constructor's constants, in float32 and in the JAX
package's expression order, then moved to the input's device. The depthwise
convolution is one ``F.conv2d``/``F.conv3d`` with ``groups=C``, run with
cuDNN's TF32 off (:func:`cudnn_float32`): the JAX package convolves in
float32, and TF32 would keep about three digits.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor


@contextmanager
def cudnn_float32() -> Iterator[None]:
    """cuDNN convolutions in full float32 for the block (no TF32), every other
    cuDNN setting as the caller left it; restored on exit."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                     allow_tf32=False):
        yield


def _gaussian(kernel_size: int, sigma: float, dtype: torch.dtype = torch.float32) -> Tensor:
    """1D gaussian window of length ``kernel_size``, normalized to sum 1: (1, k)."""
    dist = torch.arange((1 - kernel_size) / 2, (1 + kernel_size) / 2, dtype=dtype)
    gauss = torch.exp(-((dist / sigma) ** 2) / 2)
    return (gauss / gauss.sum())[None, :]


def _gaussian_kernel_2d(channel: int, kernel_size: Sequence[int], sigma: Sequence[float], dtype: torch.dtype) -> Tensor:
    """Depthwise 2D gaussian kernel, (C, 1, kh, kw), on the host."""
    kernel_x = _gaussian(kernel_size[0], sigma[0], dtype)
    kernel_y = _gaussian(kernel_size[1], sigma[1], dtype)
    kernel = kernel_x.T @ kernel_y
    return kernel.expand(channel, 1, kernel_size[0], kernel_size[1])


def _gaussian_kernel_3d(channel: int, kernel_size: Sequence[int], sigma: Sequence[float], dtype: torch.dtype) -> Tensor:
    """Depthwise 3D gaussian kernel, (C, 1, kd, kh, kw), on the host."""
    kernel_x = _gaussian(kernel_size[0], sigma[0], dtype)
    kernel_y = _gaussian(kernel_size[1], sigma[1], dtype)
    kernel_z = _gaussian(kernel_size[2], sigma[2], dtype)
    kernel_xy = kernel_x.T @ kernel_y
    kernel = kernel_xy[:, :, None] * kernel_z[0][None, None, :]
    return kernel.expand(channel, 1, *kernel.shape)


def _uniform_kernel_2d(channel: int, kernel_size: Sequence[int], dtype: torch.dtype) -> Tensor:
    kernel = torch.ones(tuple(kernel_size), dtype=dtype) / float(np.prod(kernel_size))
    return kernel.expand(channel, 1, *kernel_size)


def _depthwise_conv(x: Tensor, kernel: Tensor) -> Tensor:
    """Depthwise (per-channel) valid conv: x (N, C, *spatial), kernel (C, 1, *k)."""
    weight = kernel.to(device=x.device, dtype=x.dtype).contiguous()
    conv = F.conv2d if x.ndim == 4 else F.conv3d
    with cudnn_float32():
        return conv(x, weight, groups=x.shape[1])


def _reflect_index(n: int, pad: int) -> np.ndarray:
    """numpy's ``mode="reflect"`` as indices into a length-``n`` axis padded by
    ``pad`` on both sides, repeating the reflection when ``pad >= n``."""
    idx = np.arange(-pad, n + pad)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    m = np.abs(idx) % period
    return np.where(m >= n, period - m, m)


def _reflection_pad(x: Tensor, pads: Sequence[int]) -> Tensor:
    """Reflection-pad the trailing spatial dims by ``pads`` on both sides, as
    ``jnp.pad(mode="reflect")``: ``F.pad`` where every pad is shorter than its
    axis, else a gather by the reflected index (built on the host), which
    reflects again where ``F.pad`` would raise."""
    spatial = x.shape[2:]
    if all(p < n for p, n in zip(pads, spatial)):
        flat = [q for p in reversed(pads) for q in (p, p)]
        return F.pad(x, flat, mode="reflect")
    for axis, (p, n) in enumerate(zip(pads, spatial), start=2):
        if p:
            x = x.index_select(axis, torch.as_tensor(_reflect_index(n, p), device=x.device))
    return x


def _check_image_pair(preds: Tensor, target: Tensor, allowed_ndims=(4,), min_channels: int = 1,
                      names=("preds", "target")) -> Tuple[Tensor, Tensor]:
    """Shared validator for (preds, target) image metrics: same dtype and
    shape, allowed rank, minimum channel count (the JAX package's texts)."""
    if preds.dtype != target.dtype:
        raise TypeError(
            f"Expected `{names[0]}` and `{names[1]}` to have the same data type."
            f" Got {names[0]}: {preds.dtype} and {names[1]}: {target.dtype}."
        )
    if preds.shape != target.shape:
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, got {tuple(preds.shape)} and"
            f" {tuple(target.shape)}."
        )
    if preds.ndim not in allowed_ndims:
        expected = " or ".join("BxCxHxW" if n == 4 else "BxCxDxHxW" for n in allowed_ndims)
        raise ValueError(
            f"Expected `preds` and `target` to have {expected} shape."
            f" Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    if preds.shape[1] < min_channels:
        raise ValueError(
            "Expected channel dimension of `preds` and `target` to be larger than 1."
            f" Got preds: {preds.shape[1]} and target: {target.shape[1]}."
        )
    return preds, target


def _windowed_moments(preds: Tensor, target: Tensor, kernel: Tensor, pads: Sequence[int]):
    """Windowed first and second moments by ONE depthwise conv over the
    stacked ``[p, t, p*p, t*t, p*t]`` (the JAX package's ``_windowed_moments``).
    Each stage's inputs are freed as soon as the next holds what it needs, so
    the peak is the stack and its convolution. Returns ``(mu_p, mu_t,
    sigma_pp, sigma_tt, sigma_pt)`` maps at the padded size less the halo."""
    preds_p = _reflection_pad(preds, pads)
    target_p = _reflection_pad(target, pads)
    stacked = torch.cat((preds_p, target_p, preds_p * preds_p, target_p * target_p, preds_p * target_p))
    del preds_p, target_p
    outputs = _depthwise_conv(stacked, kernel)
    del stacked
    b = preds.shape[0]
    mu_p, mu_t, s_pp, s_tt, s_pt = (outputs[i * b: (i + 1) * b] for i in range(5))
    return mu_p, mu_t, s_pp - mu_p ** 2, s_tt - mu_t ** 2, s_pt - mu_p * mu_t


def _avg_pool(x: Tensor, window: int = 2) -> Tensor:
    """Non-overlapping average pool over all spatial dims (N, C, *spatial), floor mode."""
    pool = F.avg_pool2d if x.ndim == 4 else F.avg_pool3d
    return pool(x, window)
