"""Short-Time Objective Intelligibility (counterpart of
``metrics_tpu/ops/audio/stoi.py``): the published algorithm (Taal et al.
2011, and the extended variant of Jensen & Taal 2016) with pystoi's
constants: fs = 10 kHz, 256-sample Hann frames at 50% overlap, a 512-point
FFT, 15 one-third octave bands from 150 Hz, 30-frame segments, a -15 dB
clipping bound and a 40 dB range for silent-frame removal.

The whole batch of utterances runs at once on a leading axis (the JAX
package ``vmap``s one utterance). Silent-frame removal keeps static shapes:
a stable sort of an integer copy of the keep-mask puts the active frames
first in their order, the rest are zeroed, and the overlap-add writes a
buffer of fixed length (each sample gets at most two addends, so the sum is
the same in any order); segments that reach past the active frames are
masked out.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape

FS = 10000
N_FRAME = 256
NFFT = 512
NUMBAND = 15
MINFREQ = 150
N_SEG = 30
BETA = -15.0
DYN_RANGE = 40.0


def _hanning_np(m: int) -> np.ndarray:
    """``jnp.hanning(m)`` as the JAX package computes it in float32:
    ``0.5 * (1 - cos(2*pi*n / (m - 1)))`` with every step rounded to
    float32, the cosine correctly rounded (from float64). XLA's float32 cosine
    is not correctly rounded everywhere, so a few entries of the JAX window
    differ from this one by one or two ulp."""
    if m <= 1:
        return np.ones(m, np.float32)
    n = np.arange(m, dtype=np.float32)
    arg = (np.float32(2 * np.pi) * n) / np.float32(m - 1)
    cos = np.cos(arg.astype(np.float64)).astype(np.float32)
    return np.float32(0.5) * (np.float32(1.0) - cos)


@lru_cache(maxsize=None)
def _hanning(m: int, device: torch.device) -> Tensor:
    """The float32 window of :func:`_hanning_np` on ``device`` (made once per
    device, so a captured step only reads it)."""
    return torch.from_numpy(_hanning_np(m)).to(device)


@lru_cache(maxsize=None)
def _stoi_window(device: torch.device) -> Tensor:
    """pystoi's frame window: ``hanning(N_FRAME + 2)[1:-1]``."""
    return torch.from_numpy(_hanning_np(N_FRAME + 2)[1:-1].copy()).to(device)


@lru_cache(maxsize=None)
def _third_octave_matrix(fs: int = FS, nfft: int = NFFT, num_bands: int = NUMBAND, min_freq: int = MINFREQ) -> np.ndarray:
    """One-third octave band matrix (J, nfft//2+1), pystoi's ``thirdoct``."""
    f = np.linspace(0, fs / 2, nfft // 2 + 1)
    k = np.arange(num_bands)
    freq_low = min_freq * 2.0 ** ((2 * k - 1) / 6.0)
    freq_high = min_freq * 2.0 ** ((2 * k + 1) / 6.0)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        fl_ii = np.argmin((f - freq_low[i]) ** 2)
        fh_ii = np.argmin((f - freq_high[i]) ** 2)
        obm[i, fl_ii:fh_ii] = 1
    return obm


@lru_cache(maxsize=None)
def _third_octave_t(device: torch.device) -> Tensor:
    """The band matrix transposed, (nfft//2+1, J) float32 on ``device``."""
    return torch.from_numpy(_third_octave_matrix().T.astype(np.float32)).to(device)


def _n_frames(length: int, frame_len: int = N_FRAME, hop: int = N_FRAME // 2) -> int:
    """pystoi's frame count, ``len(range(0, length - frame_len, hop))``: the
    exclusive stop drops the last full frame when (length - frame_len) is an
    exact multiple of the hop."""
    return max((length - frame_len - 1) // hop + 1, 0)


def _frame(x: Tensor, frame_len: int = N_FRAME, hop: int = N_FRAME // 2) -> Tensor:
    """[..., T] -> [..., M, frame_len] sliding frames, pystoi's count."""
    n_frames = _n_frames(x.shape[-1], frame_len, hop)
    idx = torch.arange(n_frames, device=x.device)[:, None] * hop + torch.arange(frame_len, device=x.device)[None, :]
    return x[..., idx]


def _remove_silent_frames(x: Tensor, y: Tensor, dyn_range: float = DYN_RANGE):
    """Drop the frames of the clean signals ``x`` (B, T) more than
    ``dyn_range`` dB below each one's loudest frame, compact the rest to the
    front and overlap-add both signals back: (x_out, y_out, n_active), the
    outputs (B, (M + 1) * hop) and ``n_active`` (B,)."""
    hop = N_FRAME // 2
    w = _stoi_window(x.device)
    x_frames = _frame(x) * w  # (B, M, N_FRAME)
    y_frames = _frame(y) * w
    energies = 20 * torch.log10(torch.linalg.vector_norm(x_frames, dim=-1) + torch.finfo(x.dtype).eps)
    mask = (energies - energies.amax(dim=-1, keepdim=True) + dyn_range) > 0  # (B, M)

    # stable compaction: active frames first, original order kept
    order = torch.argsort((~mask).to(torch.int32), dim=-1, stable=True)
    n_active = mask.sum(dim=-1)
    keep = torch.take_along_dim(mask, order, dim=-1)[..., None]
    x_sorted = torch.where(keep, torch.take_along_dim(x_frames, order[..., None], dim=-2), 0.0)
    y_sorted = torch.where(keep, torch.take_along_dim(y_frames, order[..., None], dim=-2), 0.0)

    def ola(frames: Tensor) -> Tensor:
        # frames are windowed; at 50% overlap frame m's first half lands on
        # chunk m and its second half on chunk m + 1
        batch, n = frames.shape[0], frames.shape[1]
        first = frames[..., :hop].reshape(batch, n * hop)
        second = frames[..., hop:].reshape(batch, n * hop)
        pad = first.new_zeros(batch, hop)
        return torch.cat([first, pad], dim=-1) + torch.cat([pad, second], dim=-1)

    return ola(x_sorted), ola(y_sorted), n_active


def _band_envelopes(x: Tensor) -> Tensor:
    """[B, T] signals -> (B, J, M) one-third-octave band magnitude envelopes."""
    frames = _frame(x) * _stoi_window(x.device)  # (B, M, N_FRAME)
    spec = torch.fft.rfft(frames, n=NFFT, dim=-1)  # (B, M, NFFT//2+1)
    power = spec.abs() ** 2
    return torch.sqrt(power @ _third_octave_t(x.device)).transpose(-1, -2)  # (B, J, M)


def _stoi_batch(x: Tensor, y: Tensor, extended: bool) -> Tensor:
    """STOI of each clean/degraded pair of rows of (B, T) float32 at 10 kHz."""
    eps = torch.finfo(x.dtype).eps
    batch = x.shape[0]
    # shorter than one segment of frames: NaN by shape, before any reduction
    # could meet a size-0 axis
    if _n_frames(x.shape[-1]) < N_SEG:
        return torch.full((batch,), float("nan"), dtype=x.dtype, device=x.device)
    x_sil, y_sil, n_active = _remove_silent_frames(x, y)

    x_bands = _band_envelopes(x_sil)  # (B, J, M)
    y_bands = _band_envelopes(y_sil)
    n_frames = x_bands.shape[-1]

    # every candidate segment [m - N + 1, m]; valid iff inside the active frames
    x_seg = x_bands.unfold(-1, N_SEG, 1)  # (B, J, S, N)
    y_seg = y_bands.unfold(-1, N_SEG, 1)
    last = torch.arange(n_frames - N_SEG + 1, device=x.device) + (N_SEG - 1)
    valid = last[None, :] < n_active[:, None]  # (B, S)

    def norm(a: Tensor, dim: int) -> Tensor:
        return torch.linalg.vector_norm(a, dim=dim, keepdim=True)

    if extended:
        # row and column normalisation, no clipping (Jensen & Taal 2016)
        x_n = x_seg - x_seg.mean(dim=-1, keepdim=True)
        y_n = y_seg - y_seg.mean(dim=-1, keepdim=True)
        x_n = x_n / (norm(x_n, -1) + eps)
        y_n = y_n / (norm(y_n, -1) + eps)
        x_n = x_n - x_n.mean(dim=1, keepdim=True)
        y_n = y_n - y_n.mean(dim=1, keepdim=True)
        x_n = x_n / (norm(x_n, 1) + eps)
        y_n = y_n / (norm(y_n, 1) + eps)
        seg_scores = torch.sum(x_n * y_n, dim=(1, -1)) / N_SEG  # (B, S)
    else:
        # per-band scale and clip, then the per-(band, segment) correlation
        alpha = norm(x_seg, -1) / (norm(y_seg, -1) + eps)
        y_prime = torch.minimum(alpha * y_seg, x_seg * (1 + 10 ** (-BETA / 20)))
        xn = x_seg - x_seg.mean(dim=-1, keepdim=True)
        yn = y_prime - y_prime.mean(dim=-1, keepdim=True)
        # normalised before the product, as in the JAX package
        xn = xn / (norm(xn, -1) + eps)
        yn = yn / (norm(yn, -1) + eps)
        corr = torch.sum(xn * yn, dim=-1)  # (B, J, S)
        seg_scores = corr.mean(dim=1)  # (B, S)

    n_valid = valid.sum(dim=-1)
    score = torch.sum(torch.where(valid, seg_scores, 0.0), dim=-1) / torch.clamp(n_valid, min=1)
    # all-silent or too short after the removal: NaN, not a fake 0
    return torch.where(n_valid > 0, score, float("nan"))


def short_time_objective_intelligibility(
    preds: Tensor, target: Tensor, fs: int, extended: bool = False
) -> Tensor:
    """STOI over ``[..., time]`` batches.

    At ``fs != 10000`` both signals are resampled to 10 kHz on the host with
    ``scipy.signal.resample_poly`` in float64 and come back as float32 on the
    input's device, as in the JAX package (whose only step outside a trace
    this is); the STOI math itself then runs on that device. A compiled
    update of such a metric reverts to eager at its probe (the resample reads
    the signals to the host).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import short_time_objective_intelligibility
        >>> t = torch.arange(16000, dtype=torch.float32) / 8000
        >>> target = torch.sin(2 * torch.pi * 440 * t) * torch.sin(2 * torch.pi * 3 * t)
        >>> preds = target + 0.3 * torch.sin(2 * torch.pi * 1234 * t)
        >>> round(float(short_time_objective_intelligibility(preds, target, 8000)), 3)
        0.815
    """
    _check_same_shape(preds, target)
    if fs != FS:
        from scipy.signal import resample_poly

        def resample(x: Tensor) -> Tensor:
            host = resample_poly(x.detach().to(torch.float64).cpu().numpy(), FS, fs, axis=-1)
            return torch.from_numpy(host.astype(np.float32)).to(x.device)

        preds, target = resample(preds), resample(target)

    shape = preds.shape
    flat_preds = preds.reshape(-1, shape[-1]).to(torch.float32)
    flat_target = target.reshape(-1, shape[-1]).to(torch.float32)
    vals = _stoi_batch(flat_target, flat_preds, extended)
    return vals.reshape(shape[:-1]) if len(shape) > 1 else vals[0]
