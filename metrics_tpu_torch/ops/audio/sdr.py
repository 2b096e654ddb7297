"""Signal-to-Distortion Ratio and scale-invariant SDR (counterpart of
``metrics_tpu/ops/audio/sdr.py``).

SDR projects the prediction on the span of ``filter_length`` delays of the
target: the target's autocorrelation and its cross-correlation with the
prediction come from one zero-padded real FFT each (``torch.fft``), then the
symmetric Toeplitz system is solved either directly
(``torch.linalg.solve_ex`` on the materialised (L, L) matrix, with
``check_errors=False``: ``torch.linalg.solve`` reads the solver's status back
to the host, which a CUDA graph capture refuses, and a singular system gives
NaN silently, as the JAX package's solve does) or by ``use_cg_iter`` steps of
conjugate gradients whose Toeplitz matvec is an FFT convolution. A CUDA
graph capture refuses the batched LU solve itself, so on the card a compiled
update with the direct solve stays eager (the engines' probe says why); the
conjugate-gradient route captures.

Dtype: the JAX package computes in float32 unless x64 is on. Here the math
runs in float64 only for float64 inputs and in float32 otherwise, and the
result is float32 unless the input was float64.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape


def _symmetric_toeplitz(vector: Tensor) -> Tensor:
    """Symmetric Toeplitz matrix from its first row: out[..., i, j] = v[|i-j|]."""
    v_len = vector.shape[-1]
    ar = torch.arange(v_len, device=vector.device)
    idx = (ar[:, None] - ar[None, :]).abs()
    return vector[..., idx]


def _compute_autocorr_crosscorr(target: Tensor, preds: Tensor, corr_len: int) -> Tuple[Tensor, Tensor]:
    """FFT autocorrelation of the target and its cross-correlation with the
    prediction, the first ``corr_len`` lags of each."""
    n_fft = 2 ** math.ceil(math.log2(preds.shape[-1] + target.shape[-1] - 1))
    t_fft = torch.fft.rfft(target, n=n_fft, dim=-1)
    r_0 = torch.fft.irfft(t_fft.real ** 2 + t_fft.imag ** 2, n=n_fft, dim=-1)[..., :corr_len]
    p_fft = torch.fft.rfft(preds, n=n_fft, dim=-1)
    b = torch.fft.irfft(torch.conj(t_fft) * p_fft, n=n_fft, dim=-1)[..., :corr_len]
    return r_0, b


def _toeplitz_matvec(r_0: Tensor, x: Tensor) -> Tensor:
    """``T(r_0) @ x`` through the circulant embedding of the Toeplitz matrix
    (first column ``[r0, r1 .. r_{l-1}, 0, r_{l-1} .. r1]``), as an FFT
    convolution: no (L, L) matrix."""
    l = r_0.shape[-1]
    c = torch.cat([r_0, torch.zeros_like(r_0[..., :1]), torch.flip(r_0[..., 1:], dims=(-1,))], dim=-1)
    n = c.shape[-1]
    prod = torch.fft.irfft(torch.fft.rfft(c, dim=-1) * torch.fft.rfft(x, n=n, dim=-1), n=n, dim=-1)
    return prod[..., :l]


def _toeplitz_conjugate_gradient(r_0: Tensor, b: Tensor, n_iter: int = 10) -> Tensor:
    """``n_iter`` conjugate-gradient steps on ``T(r_0) x = b`` from x = 0; a
    zero denominator divides by 1 instead, as in the JAX package's scan."""
    x = torch.zeros_like(b)
    r, p = b, b
    rs = torch.sum(b * b, dim=-1, keepdim=True)
    for _ in range(n_iter):
        ap = _toeplitz_matvec(r_0, p)
        denom = torch.sum(p * ap, dim=-1, keepdim=True)
        alpha = rs / torch.where(denom == 0, torch.ones_like(denom), denom)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.sum(r * r, dim=-1, keepdim=True)
        beta = rs_new / torch.where(rs == 0, torch.ones_like(rs), rs)
        p = r + beta * p
        rs = rs_new
    return x


def signal_distortion_ratio(
    preds: Tensor,
    target: Tensor,
    use_cg_iter: Optional[int] = None,
    filter_length: int = 512,
    zero_mean: bool = False,
    load_diag: Optional[float] = None,
) -> Tensor:
    """SDR in dB over the last (time) axis.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import signal_distortion_ratio
        >>> t = torch.arange(8000, dtype=torch.float32) / 8000
        >>> target = torch.sin(2 * torch.pi * 440 * t) * torch.sin(2 * torch.pi * 3 * t)
        >>> preds = target + 0.1 * torch.sin(2 * torch.pi * 1234 * t)
        >>> round(float(signal_distortion_ratio(preds, target, filter_length=64)), 2)
        16.99
    """
    _check_same_shape(preds, target)
    orig_dtype = preds.dtype
    wide = torch.float64 if orig_dtype == torch.float64 else torch.float32
    preds = preds.to(wide)
    target = target.to(wide)

    if zero_mean:
        preds = preds - preds.mean(dim=-1, keepdim=True)
        target = target - target.mean(dim=-1, keepdim=True)

    target = target / torch.clamp(torch.linalg.vector_norm(target, dim=-1, keepdim=True), min=1e-6)
    preds = preds / torch.clamp(torch.linalg.vector_norm(preds, dim=-1, keepdim=True), min=1e-6)

    r_0, b = _compute_autocorr_crosscorr(target, preds, corr_len=filter_length)
    if load_diag is not None:
        r_0 = torch.cat([r_0[..., :1] + load_diag, r_0[..., 1:]], dim=-1)

    if use_cg_iter is not None:
        sol = _toeplitz_conjugate_gradient(r_0, b, n_iter=use_cg_iter)
    else:
        r = _symmetric_toeplitz(r_0)
        sol = torch.linalg.solve_ex(r, b[..., None], check_errors=False)[0][..., 0]

    coh = torch.einsum("...l,...l->...", b, sol)
    ratio = coh / (1 - coh)
    return 10.0 * torch.log10(ratio)


def scale_invariant_signal_distortion_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    """SI-SDR in dB over the last (time) axis.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import scale_invariant_signal_distortion_ratio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(scale_invariant_signal_distortion_ratio(preds, target)), 4)
        18.403
    """
    _check_same_shape(preds, target)
    eps = torch.finfo(preds.dtype).eps

    if zero_mean:
        target = target - target.mean(dim=-1, keepdim=True)
        preds = preds - preds.mean(dim=-1, keepdim=True)

    alpha = (torch.sum(preds * target, dim=-1, keepdim=True) + eps) / (
        torch.sum(target ** 2, dim=-1, keepdim=True) + eps
    )
    target_scaled = alpha * target
    noise = target_scaled - preds
    val = (torch.sum(target_scaled ** 2, dim=-1) + eps) / (torch.sum(noise ** 2, dim=-1) + eps)
    return 10 * torch.log10(val)
