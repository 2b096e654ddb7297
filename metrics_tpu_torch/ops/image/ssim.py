"""SSIM and Multi-Scale SSIM (counterpart of ``metrics_tpu/ops/image/ssim.py``).

The five windowed statistics come from one depthwise convolution over the
stacked ``[p, t, p*p, t*t, p*t]`` (``helper._windowed_moments``). MS-SSIM
keeps the JAX package's per-image definition (each image's product over the
scales, reduced at the end; the pinned reference reduces each scale first)
and its size guard on the effective kernel.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.ops.image.helper import (
    _avg_pool,
    _check_image_pair,
    _gaussian_kernel_2d,
    _gaussian_kernel_3d,
    _uniform_kernel_2d,
    _windowed_moments,
)
from metrics_tpu_torch.utils.compute import reduce


def _ssim_check_inputs(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    return _check_image_pair(preds, target, allowed_ndims=(4, 5))


def _normalize_kernel_args(
    ndim: int, kernel_size: Union[int, Sequence[int]], sigma: Union[float, Sequence[float]]
) -> Tuple[Sequence[int], Sequence[float]]:
    nd = 3 if ndim == 5 else 2
    if not isinstance(kernel_size, Sequence):
        kernel_size = nd * [kernel_size]
    if not isinstance(sigma, Sequence):
        sigma = nd * [sigma]
    if len(kernel_size) != nd or len(sigma) != nd:
        raise ValueError(
            f"`kernel_size` and `sigma` must have {nd} elements for {ndim}D input,"
            f" got kernel_size={list(kernel_size)} sigma={list(sigma)}."
        )
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {list(kernel_size)}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {list(sigma)}.")
    return list(kernel_size), list(sigma)


def _effective_kernel(gaussian_kernel: bool, kernel_size: Sequence[int], sigma: Sequence[float]) -> list:
    """The gaussian's support follows sigma, not ``kernel_size``."""
    return [int(3.5 * s + 0.5) * 2 + 1 for s in sigma] if gaussian_kernel else list(kernel_size)


def _ssim_compute(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    is_3d = preds.ndim == 5
    kernel_size, sigma = _normalize_kernel_args(preds.ndim, kernel_size, sigma)

    if data_range is None:
        # on the device: no read to the host
        data_range = torch.maximum(preds.max() - preds.min(), target.max() - target.min())
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    channel = preds.shape[1]
    eff_kernel = _effective_kernel(gaussian_kernel, kernel_size, sigma)
    pads = [(k - 1) // 2 for k in eff_kernel]
    if gaussian_kernel:
        make = _gaussian_kernel_3d if is_3d else _gaussian_kernel_2d
        kernel = make(channel, eff_kernel, sigma, preds.dtype)
    else:
        kernel = _uniform_kernel_2d(channel, kernel_size, preds.dtype)

    mu_pred, mu_target, sigma_pred_sq, sigma_target_sq, sigma_pred_target = _windowed_moments(
        preds, target, kernel, pads
    )
    mu_pred_sq = mu_pred ** 2
    mu_target_sq = mu_target ** 2
    mu_pred_target = mu_pred * mu_target
    del mu_pred, mu_target

    upper = 2 * sigma_pred_target + c2
    lower = sigma_pred_sq + sigma_target_sq + c2
    del sigma_pred_target, sigma_pred_sq, sigma_target_sq

    ssim_full = ((2 * mu_pred_target + c1) * upper) / ((mu_pred_sq + mu_target_sq + c1) * lower)
    del mu_pred_target, mu_pred_sq, mu_target_sq

    # the conv is VALID on the padded input: trim the kernel half-width from each border
    slc = (...,) + tuple(slice(p, -p if p else None) for p in pads)
    ssim_idx = ssim_full[slc]

    per_image = ssim_idx.reshape(ssim_idx.shape[0], -1).mean(-1)
    if return_contrast_sensitivity:
        cs = (upper / lower)[slc]
        return reduce(per_image, reduction), reduce(cs.reshape(cs.shape[0], -1).mean(-1), reduction)
    if return_full_image:
        return reduce(per_image, reduction), reduce(ssim_full, reduction)
    return reduce(per_image, reduction)


def structural_similarity_index_measure(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """SSIM of (N, C, H, W) or (N, C, D, H, W) batches.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import structural_similarity_index_measure
        >>> imgs = torch.linspace(0.0, 1.0, 1 * 1 * 16 * 16).reshape(1, 1, 16, 16)
        >>> round(float(structural_similarity_index_measure(imgs, imgs, data_range=1.0)), 4)
        1.0
    """
    preds, target = _ssim_check_inputs(preds, target)
    return _ssim_compute(
        preds, target, gaussian_kernel, sigma, kernel_size, reduction, data_range, k1, k2,
        return_full_image, return_contrast_sensitivity,
    )


_MS_SSIM_BETAS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _multiscale_ssim_compute(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = _MS_SSIM_BETAS,
    normalize: Optional[str] = None,
) -> Tensor:
    kernel_size_l, sigma_l = _normalize_kernel_args(preds.ndim, kernel_size, sigma)
    # the size guard on the EFFECTIVE kernel at the smallest scale
    eff_kernel = _effective_kernel(gaussian_kernel, kernel_size_l, sigma_l)
    _betas_div = 2 ** max(0, len(betas) - 1)
    for axis, k in zip((-2, -1), eff_kernel[:2]):
        if preds.shape[axis] // _betas_div <= k - 1:
            raise ValueError(
                f"For a given number of `betas` parameters {len(betas)} and kernel size {k},"
                f" the image height and width must be larger than {(k - 1) * _betas_div}."
            )

    # per-image statistics at every scale; the reduction comes last
    sim_list = []
    cs_list = []
    for _ in range(len(betas)):
        sim, cs = _ssim_compute(
            preds, target, gaussian_kernel, sigma, kernel_size, "none", data_range, k1, k2,
            return_contrast_sensitivity=True,
        )
        if normalize == "relu":
            sim = torch.clamp(sim, min=0.0)
            cs = torch.clamp(cs, min=0.0)
        sim_list.append(sim)
        cs_list.append(cs)
        preds = _avg_pool(preds, 2)
        target = _avg_pool(target, 2)

    sim_stack = torch.stack(sim_list)  # (S, B)
    cs_stack = torch.stack(cs_list)
    if normalize == "simple":
        sim_stack = (sim_stack + 1) / 2
        cs_stack = (cs_stack + 1) / 2

    betas_arr = torch.tensor(betas, dtype=sim_stack.dtype).to(sim_stack.device)
    sim_stack = sim_stack ** betas_arr[:, None]
    cs_stack = cs_stack ** betas_arr[:, None]
    per_image = torch.prod(torch.cat((cs_stack[:-1], sim_stack[-1:]), dim=0), dim=0)
    return reduce(per_image, reduction)


def multiscale_structural_similarity_index_measure(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = _MS_SSIM_BETAS,
    normalize: Optional[str] = None,
) -> Tensor:
    """Multi-scale SSIM.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import multiscale_structural_similarity_index_measure
        >>> imgs = torch.linspace(0.0, 1.0, 1 * 1 * 192 * 192).reshape(1, 1, 192, 192)
        >>> round(float(multiscale_structural_similarity_index_measure(imgs, imgs, data_range=1.0)), 4)
        1.0
    """
    if not isinstance(betas, tuple):
        raise ValueError("Argument `betas` is expected to be of a type tuple.")
    if not all(isinstance(beta, float) for beta in betas):
        raise ValueError("Argument `betas` is expected to be a tuple of floats.")
    if normalize is not None and normalize not in ("relu", "simple"):
        raise ValueError("Argument `normalize` must be None, 'relu' or 'simple'")
    preds, target = _ssim_check_inputs(preds, target)
    return _multiscale_ssim_compute(
        preds, target, gaussian_kernel, sigma, kernel_size, reduction, data_range, k1, k2, betas, normalize
    )
