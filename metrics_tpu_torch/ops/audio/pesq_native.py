"""Native PESQ (the ITU-T P.862 perceptual model; counterpart of
``metrics_tpu/ops/audio/pesq_native.py``).

The P.862 pipeline as batched tensor code: level alignment, an IRS-style
receive filter, envelope time alignment, the bark-band power spectrum,
Zwicker's loudness, the asymmetric disturbance aggregation and the MOS
mapping (P.862.2's logistic for wideband). The frequency-warping and
threshold tables come from the Zwicker/Terhardt formulas, as in the JAX
package: this is that package's native model, not a bit-exact port of the
ITU C code, whose extension stays the default backend of
``perceptual_evaluation_speech_quality``.

A batch of utterances runs at once on a leading axis (the JAX package
``vmap``s one). Two of its idioms become gathers: the 61 rolled copies of
the degraded envelope in the delay search are one (61, M) index
``(arange(M) + s) % M``, and the roll of the degraded spectrogram by the
chosen per-utterance delay is a gather along frames, so the delay never
leaves the device. The edge padding of the split-second aggregation is a
clamped index. The tables are numpy constants, made once per device.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.ops.audio.stoi import _hanning
from metrics_tpu_torch.utils.checks import _check_arg_choice, _check_same_shape

# frame layout: 32 ms window, 50% overlap (P.862 §10.2.4)
_FRAME = {8000: 256, 16000: 512}
_NBARK = {8000: 42, 16000: 49}
_TARGET_POWER = 1e7  # P.862 calibrated listening level
_MAX_SHIFT = 30


def _bark_of_hz(f: np.ndarray) -> np.ndarray:
    """Zwicker & Terhardt critical-band rate."""
    return 13.0 * np.arctan(0.00076 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


@lru_cache(maxsize=None)
def _band_matrix(fs: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(bark-binning matrix (B, F), band widths in bark (B,), band centres Hz).

    Bands are uniform in bark over [100 Hz, fs/2], P.862's ~0.49-bark spacing
    (42 bands at 8 kHz, 49 at 16 kHz)."""
    n_fft = _FRAME[fs]
    freqs = np.fft.rfftfreq(n_fft, 1.0 / fs)
    nb = _NBARK[fs]
    z = _bark_of_hz(freqs)
    z_lo, z_hi = _bark_of_hz(np.asarray([100.0]))[0], _bark_of_hz(np.asarray([fs / 2.0]))[0]
    edges = np.linspace(z_lo, z_hi, nb + 1)
    mat = np.zeros((nb, len(freqs)), dtype=np.float32)
    for b in range(nb):
        sel = (z >= edges[b]) & (z < edges[b + 1])
        if not sel.any():  # narrow low bands: take the nearest bin
            sel = np.zeros_like(sel)
            sel[np.argmin(np.abs(z - 0.5 * (edges[b] + edges[b + 1])))] = True
        mat[b] = sel / max(sel.sum(), 1)
    centers_hz = np.asarray([freqs[mat[b] > 0].mean() for b in range(nb)], dtype=np.float32)
    widths = np.diff(edges).astype(np.float32)
    return mat, widths, centers_hz


@lru_cache(maxsize=None)
def _abs_threshold(fs: int) -> np.ndarray:
    """Absolute hearing threshold power per band (Terhardt approximation)."""
    _, _, centers = _band_matrix(fs)
    f_khz = np.maximum(centers, 20.0) / 1000.0
    thr_db = 3.64 * f_khz ** -0.8 - 6.5 * np.exp(-0.6 * (f_khz - 3.3) ** 2) + 1e-3 * f_khz ** 4
    return (10.0 ** (thr_db / 10.0)).astype(np.float32)


@lru_cache(maxsize=None)
def _receive_filter(fs: int, mode: str) -> np.ndarray:
    """Per-rfft-bin magnitude response of the receive characteristic.

    nb: IRS-like telephone band emphasis (300-3100 Hz, rising 20 dB/dec to
    1 kHz then flat); wb: P.862.2 IRF flat 50-7000 Hz with soft edges."""
    n_fft = _FRAME[fs]
    f = np.fft.rfftfreq(n_fft, 1.0 / fs)
    if mode == "nb":
        lo, hi = 300.0, 3100.0
        gain = np.clip((f / 1000.0) ** 1.0, 0.0, 1.0)  # gentle low-band tilt
    else:
        lo, hi = 50.0, 7000.0
        gain = np.ones_like(f)
    soft = 1.0 / (1.0 + np.exp(-(f - lo) / 25.0)) * (1.0 / (1.0 + np.exp((f - hi) / 150.0)))
    return (gain * soft).astype(np.float32)


@lru_cache(maxsize=None)
def _tables(fs: int, mode: str, device: torch.device) -> dict:
    """The float32 constants of one (fs, mode) on ``device``: the squared
    receive filter, the transposed band matrix, the band widths and the
    threshold at the calibrated level (each rounded as the JAX package
    rounds it: float32 operations on the float32 tables)."""
    mat, widths, _ = _band_matrix(fs)
    filt = _receive_filter(fs, mode)
    return {
        "filter_sq": torch.from_numpy(filt * filt).to(device),
        "band_t": torch.from_numpy(np.ascontiguousarray(mat.T)).to(device),
        "widths": torch.from_numpy(widths).to(device),
        "thr": torch.from_numpy(_abs_threshold(fs) * np.float32(1e4)).to(device),
    }


def _frames(x: Tensor, n: int) -> Tensor:
    """[..., T] -> [..., M, n] frames at hop n/2, the index clamped into the
    signal (at least one frame)."""
    hop = n // 2
    m = max((x.shape[-1] - n) // hop + 1, 1)
    idx = torch.arange(m, device=x.device)[:, None] * hop + torch.arange(n, device=x.device)[None, :]
    idx = torch.clamp(idx, max=x.shape[-1] - 1)
    return x[..., idx]


def _filtered_spec(x: Tensor, fs: int, mode: str) -> Tensor:
    """(B, M, F) windowed power spectrogram through the receive filter, one
    FFT pass per signal, reused by the level and time alignment and the bark
    binning."""
    n = _FRAME[fs]
    frames = _frames(x, n) * _hanning(n, x.device)
    spec = torch.fft.rfft(frames, dim=-1).abs() ** 2
    return spec * _tables(fs, mode, x.device)["filter_sq"]


def _active_frames(spec: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-frame power (B, M) and the active frames: above 1e-4 of the loudest."""
    frame_pow = torch.sum(spec, dim=-1)
    active = frame_pow > 1e-4 * frame_pow.amax(dim=-1, keepdim=True)
    return frame_pow, active


def _level_gain_pow(frame_pow: Tensor, active: Tensor) -> Tensor:
    """(B, 1, 1) power gain to the calibrated level (P.862 §10.1.2), from
    :func:`_active_frames`."""
    mean_pow = torch.sum(torch.where(active, frame_pow, 0.0), dim=-1) / torch.clamp(active.sum(dim=-1), min=1)
    return (_TARGET_POWER / torch.clamp(mean_pow, min=1e-20))[:, None, None]


def _align_delay_frames(spec_r: Tensor, spec_d: Tensor, max_shift: int = _MAX_SHIFT) -> Tensor:
    """(B,) integer frame delay of deg against ref by log-energy
    cross-correlation; 0 unless the peak is prominent.

    Level gains are per-signal scalars, so they shift the log envelope by a
    constant, which the mean subtraction removes."""
    er = torch.log(torch.sum(spec_r, dim=-1) + 1.0)
    ed = torch.log(torch.sum(spec_d, dim=-1) + 1.0)
    er = er - er.mean(dim=-1, keepdim=True)
    ed = ed - ed.mean(dim=-1, keepdim=True)
    m = er.shape[-1]
    shifts = torch.arange(-max_shift, max_shift + 1, device=er.device)
    # jnp.roll(ed, -s)[i] = ed[(i + s) % M]: every shift in one gather
    rolled = ed[:, torch.remainder(torch.arange(m, device=er.device)[None, :] + shifts[:, None], m)]  # (B, 61, M)
    scores = torch.sum(er[:, None, :] * rolled, dim=-1)  # (B, 61)
    # a flat correlation field (heavy noise) has an arbitrary argmax; a real
    # delay shows a prominent peak over the best score outside +-2 of it
    best_idx = torch.argmax(scores, dim=-1)
    peak = torch.take_along_dim(scores, best_idx[:, None], dim=-1)[:, 0]
    best_shift = shifts[best_idx]
    outside = (shifts[None, :] - best_shift[:, None]).abs() > 2
    runner_up = torch.where(outside, scores, float("-inf")).amax(dim=-1)
    coef = peak / torch.clamp(torch.linalg.vector_norm(er, dim=-1) * torch.linalg.vector_norm(ed, dim=-1), min=1e-20)
    prominent = (peak > 1.4 * torch.clamp(runner_up, min=1e-20)) & (coef > 0.15)
    return torch.where(prominent, best_shift, 0)


def _loudness(p: Tensor, thr: Tensor) -> Tensor:
    """Zwicker intensity -> loudness per band (P.862 §10.2.8), gamma = 0.23."""
    gamma = 0.23
    sl = (thr / 0.5) ** gamma
    ratio = p / torch.clamp(thr, min=1e-20)
    loud = sl * ((0.5 + 0.5 * ratio) ** gamma - 1.0)
    return torch.clamp(loud, min=0.0)


def _pesq_parts(ref: Tensor, deg: Tensor, fs: int, mode: str) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Raw MOS (B,) of (B, T) reference/degraded pairs, with the chosen frame
    delay (B,) and the active-frame counts of both signals (B,) each."""
    ref = ref.to(torch.float32)
    deg = deg.to(torch.float32)
    tables = _tables(fs, mode, ref.device)
    spec_r = _filtered_spec(ref, fs, mode)  # (B, M, F)
    spec_d = _filtered_spec(deg, fs, mode)
    pow_r, active_r = _active_frames(spec_r)
    pow_d, active_d = _active_frames(spec_d)
    spec_r = spec_r * _level_gain_pow(pow_r, active_r)
    spec_d = spec_d * _level_gain_pow(pow_d, active_d)
    delay = _align_delay_frames(spec_r, spec_d)
    m = spec_r.shape[1]
    frames = torch.remainder(torch.arange(m, device=ref.device)[None, :] + delay[:, None], m)  # jnp.roll(-delay)
    spec_d = torch.take_along_dim(spec_d, frames[..., None], dim=1)

    pr = spec_r @ tables["band_t"]  # (B, M, NB)
    pd = spec_d @ tables["band_t"]

    # per-frame partial gain compensation (§10.2.6): a linear frequency
    # response of the system under test is not distortion; bounded [3e-4, 5]
    num = torch.sum(pr * pd, dim=-1)
    den = torch.sum(pd * pd, dim=-1)
    g = torch.clamp(num / torch.clamp(den, min=1e-20), 3e-4, 5.0)
    pd = pd * g[..., None]

    lr = _loudness(pr, tables["thr"])
    ld = _loudness(pd, tables["thr"])

    # disturbance with the dead zone: |d| reduced by 0.25 * min(lr, ld)
    raw = ld - lr
    dead = 0.25 * torch.minimum(lr, ld)
    disturb = torch.sign(raw) * torch.clamp(raw.abs() - dead, min=0.0)

    # asymmetry: additive (coding) noise hurts more than attenuation
    asym = ((pd + 50.0) / (pr + 50.0)) ** 1.2
    asym = torch.where(asym < 3.0, 0.0, torch.clamp(asym, max=12.0))

    w = tables["widths"]
    w_sum = torch.sum(w)
    # frame disturbances: weighted L2 over bands (symmetric), L1 (asymmetric)
    d_frame = torch.sqrt(torch.sum(w * disturb ** 2, dim=-1) / w_sum)
    da_frame = torch.sum(w * disturb.abs() * asym, dim=-1) / w_sum

    # frames weighted by (audible energy)^0.04, silent frames soft-gated
    frame_e = torch.sum(pr, dim=-1)
    weight = (frame_e / (frame_e.mean(dim=-1, keepdim=True) + 1e-20) + 1e-2) ** 0.04
    d_frame = d_frame * weight
    da_frame = da_frame * weight

    # split-second aggregation (§10.2.11): L6 inside 20-frame windows, L2
    # over windows; the last window padded with the edge frame
    win = 20
    n_win = -(-m // win)
    edge = torch.clamp(torch.arange(n_win * win, device=ref.device), max=m - 1)

    def chunked(d: Tensor, p_in: float, p_out: float) -> Tensor:
        dp = d[:, edge].reshape(d.shape[0], n_win, win)
        inner = torch.mean(dp.abs() ** p_in, dim=-1) ** (1.0 / p_in)
        return torch.mean(inner ** p_out, dim=-1) ** (1.0 / p_out)

    d_sym = chunked(d_frame, 6.0, 2.0)
    d_asym = chunked(da_frame, 6.0, 2.0)

    raw_mos = 4.5 - 0.1 * d_sym - 0.0309 * d_asym
    if mode == "wb":  # P.862.2 output mapping
        raw_mos = 0.999 + 4.0 / (1.0 + torch.exp(-1.3669 * raw_mos + 3.8224))
    return torch.clamp(raw_mos, 1.0, 4.64), delay, active_r.sum(dim=-1), active_d.sum(dim=-1)


def pesq_native(preds: Tensor, target: Tensor, fs: int, mode: str) -> Tensor:
    """Batched native PESQ: ``[..., time]`` -> ``[...]`` MOS scores.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.audio.pesq_native import pesq_native
        >>> t = torch.arange(16000, dtype=torch.float32) / 8000
        >>> target = torch.sin(2 * torch.pi * 440 * t) * torch.sin(2 * torch.pi * 3 * t)
        >>> preds = target + 0.1 * torch.sin(2 * torch.pi * 1234 * t)
        >>> round(float(pesq_native(preds, target, 8000, "nb")), 2)
        4.25
    """
    _check_arg_choice(fs, "fs", (8000, 16000))
    _check_arg_choice(mode, "mode", ("wb", "nb"))
    if fs == 8000 and mode == "wb":
        raise ValueError("Expected argument `mode` to be 'nb' for a 8000Hz signal")
    _check_same_shape(preds, target)
    if preds.ndim == 1:
        return _pesq_parts(target[None], preds[None], fs, mode)[0][0]
    flat_p = preds.reshape(-1, preds.shape[-1])
    flat_t = target.reshape(-1, target.shape[-1])
    return _pesq_parts(flat_t, flat_p, fs, mode)[0].reshape(preds.shape[:-1])
