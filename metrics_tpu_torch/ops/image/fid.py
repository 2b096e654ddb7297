"""Frechet distance between feature Gaussians, with the matrix square root on
the device (counterpart of ``metrics_tpu/ops/image/fid.py``).

``trace(sqrtm(S1 @ S2))`` for covariance matrices (symmetric PSD) is the sum
of the square roots of the eigenvalues of the symmetric ``S1^1/2 S2 S1^1/2``
(similar to the product), from ``torch.linalg.eigh``; tiny negative
eigenvalues are clamped to 0. On CUDA, ``eigh`` checks its ``info`` on the
host, a synchronisation: a CUDA graph cannot capture it, so FID's compiled
compute reverts to eager on the card at its probe (on the CPU the probe sees
only ``aten._linalg_eigh`` and captures, as the JAX engine compiles it).
:func:`_compute_fid` works in float64 (see there).
"""
from __future__ import annotations

import torch
from torch import Tensor


def sqrtm_psd(mat: Tensor) -> Tensor:
    """Matrix square root of a symmetric PSD matrix via eigendecomposition.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.image.fid import sqrtm_psd
        >>> sqrtm_psd(torch.tensor([[4.0, 0.0], [0.0, 9.0]])).round(decimals=4).tolist()
        [[2.0, 0.0], [0.0, 3.0]]
    """
    vals, vecs = torch.linalg.eigh(mat)
    vals = torch.clamp(vals, min=0.0)
    return (vecs * torch.sqrt(vals)) @ vecs.T


def trace_sqrtm_product(sigma1: Tensor, sigma2: Tensor) -> Tensor:
    """``trace(sqrtm(sigma1 @ sigma2))`` for symmetric PSD inputs.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.image.fid import trace_sqrtm_product
        >>> a = torch.tensor([[2.0, 0.0], [0.0, 2.0]])
        >>> b = torch.tensor([[8.0, 0.0], [0.0, 2.0]])
        >>> round(float(trace_sqrtm_product(a, b)), 4)
        6.0
    """
    s1_half = sqrtm_psd(sigma1)
    inner = s1_half @ sigma2 @ s1_half
    inner = (inner + inner.T) / 2  # enforce symmetry against rounding drift
    if inner.is_cuda:
        # the engines' probe refuses eigh on CUDA, so this always runs eager:
        # eigvalsh skips the eigenvectors that eigh would compute for nothing
        vals = torch.linalg.eigvalsh(inner)
    else:
        # eigh's eigenvalues, not eigvalsh's: under a TorchDispatchMode (the
        # probe, which captures on the CPU) eigvalsh computes the
        # eigenvectors too and its eigenvalues move in the last bits, while
        # eigh gives the same bits either way, so a probed compute equals
        # the eager one
        vals = torch.linalg.eigh(inner)[0]
    return torch.sum(torch.sqrt(torch.clamp(vals, min=0.0)))


def _compute_fid(mu1: Tensor, sigma1: Tensor, mu2: Tensor, sigma2: Tensor) -> Tensor:
    """``|mu1-mu2|^2 + tr(S1 + S2 - 2 sqrtm(S1 S2))``, computed in float64 and
    returned in the inputs' dtype.

    The trace term sums the square roots of every eigenvalue. Where the
    covariance is nearly singular (features that span few directions), a
    float32 eigendecomposition leaves eigenvalues of rounding noise, about
    1e-7 of the largest, whose square roots add up: on 2048-wide InceptionV3
    features of a seeded stream the float32 result was 3.0e-2 from float64
    (NVIDIA H100, ``chip_smoke.py`` phase 12). The JAX package computes this
    in float32; the port upcasts here, as the pinned reference casts to
    float64 at epoch end (the states stay float32)."""
    dtype = mu1.dtype
    mu1, sigma1, mu2, sigma2 = (x.to(torch.float64) for x in (mu1, sigma1, mu2, sigma2))
    diff = mu1 - mu2
    tr_covmean = trace_sqrtm_product(sigma1, sigma2)
    return (diff @ diff + torch.trace(sigma1) + torch.trace(sigma2) - 2 * tr_covmean).to(dtype)


def welford_combine(a, b):
    """Chan's parallel combine of two (n, mean, M2) moment triples, M2 being
    the centered second moment ``sum((x-mean)(x-mean)^T)``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.image.fid import welford_update, welford_combine
        >>> x = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
        >>> triple = welford_update(torch.tensor(0.0), torch.zeros(2), torch.zeros(2, 2), x)
        >>> n, mean, m2 = welford_combine(triple, triple)
        >>> float(n), mean.tolist()
        (4.0, [2.0, 3.0])
    """
    n_a, mean_a, m2_a = a
    n_b, mean_b, m2_b = b
    n = n_a + n_b
    safe_n = torch.clamp(n, min=1.0)
    delta = mean_b - mean_a
    mean = mean_a + delta * (n_b / safe_n)
    m2 = m2_a + m2_b + torch.outer(delta, delta) * (n_a * n_b / safe_n)
    return n, mean, m2


def welford_update(n: Tensor, mean: Tensor, m2: Tensor, x: Tensor):
    """Fold a feature batch ``x: [N, D]`` into the (n, mean, M2) triple.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.image.fid import welford_update
        >>> x = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
        >>> n, mean, m2 = welford_update(torch.tensor(0.0), torch.zeros(2), torch.zeros(2, 2), x)
        >>> float(n), mean.tolist()
        (2.0, [2.0, 3.0])
    """
    # a fill on the device, not a copy from the host: a graph can capture it
    n_b = torch.full((), x.shape[0], dtype=torch.float32, device=x.device)
    mean_b = x.mean(dim=0)
    diff = x - mean_b
    return welford_combine((n, mean, m2), (n_b, mean_b, diff.T @ diff))


def _mean_cov_from_moments(n: Tensor, mean: Tensor, m2: Tensor):
    """Mean and unbiased covariance from a Welford triple."""
    return mean, m2 / torch.clamp(n - 1.0, min=1.0)


def frechet_distance(features_real: Tensor, features_fake: Tensor) -> Tensor:
    """FID directly from two ``[N, D]`` feature matrices.

    Example:
        >>> import numpy as np, torch
        >>> from metrics_tpu_torch.ops.image.fid import frechet_distance
        >>> real = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 4)).astype(np.float32))
        >>> fake = torch.from_numpy(np.random.default_rng(1).normal(loc=0.5, size=(64, 4)).astype(np.float32))
        >>> round(float(frechet_distance(real, fake)), 3)
        0.904
    """
    mu1 = features_real.mean(dim=0)
    mu2 = features_fake.mean(dim=0)
    d1 = features_real - mu1
    d2 = features_fake - mu2
    cov1 = d1.T @ d1 / (features_real.shape[0] - 1)
    cov2 = d2.T @ d2 / (features_fake.shape[0] - 1)
    return _compute_fid(mu1, cov1, mu2, cov2)
