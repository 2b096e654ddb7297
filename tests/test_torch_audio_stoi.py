"""STOI and ESTOI of the port (``metrics_tpu_torch/ops/audio/stoi.py``)
against the JAX package's on the CPU: the window, the band matrix, the
silent-frame removal, both branches, 8 and 16 kHz through the host
resample, the NaN cases and the float64 numpy oracle of the JAX tests; then
the bfloat16 grid of ``tests/audio/test_precision_grids.py`` over every
audio functional but PESQ (which is in ``tests/test_torch_audio_pesq.py``).

Inputs come from seeded numpy generators; the JAX references are jitted.
Tolerances, each with its reason:

- ``STOI_ATOL = 1e-5`` for STOI and ESTOI in [-1, 1]: sums over bands,
  frames and segments in another order than XLA's, and a frame window a few
  entries of which differ from XLA's by an ulp or two
  (:func:`test_hanning_window_against_jax`);
- ``ORACLE_ATOL = 2e-3`` against the float64 numpy oracle, the JAX test's
  own bound (``tests/audio/test_audio.py:242``);
- the bfloat16 grid's own bands (``tests/audio/test_precision_grids.py:29-38``),
  against the port's float32 value and against the JAX package's bfloat16 one;
- bit for bit: the band matrix, the silent-frame counts, the NaN cases.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import resample_poly

import metrics_tpu as mj
import metrics_tpu_torch as mt
from metrics_tpu.ops.audio import stoi as jstoi
from metrics_tpu_torch.ops.audio import stoi as tstoi
from tests.audio.test_audio import _np_stoi
from tests.helpers.torch_port import assert_bitwise, assert_close, one_torch_thread

pytestmark = [pytest.mark.filterwarnings("ignore"), pytest.mark.usefixtures("one_torch_thread")]

STOI_ATOL = 1e-5
ORACLE_ATOL = 2e-3


def _pair(seed, shape, noise=0.3):
    rng = np.random.default_rng(seed)
    t = rng.normal(size=shape).astype(np.float32)
    p = (t + noise * rng.normal(size=shape)).astype(np.float32)
    return p, t


def _jax_all(cases):
    """Each case's JAX value, ``fn(*arrays)`` for every ``(fn, arrays)``, from
    one jitted function (one compile for a group of cases, not one each)."""
    fns = [fn for fn, _ in cases]
    inputs = [[jnp.asarray(a) for a in arrays] for _, arrays in cases]
    out = jax.jit(lambda ins: [fn(*a) for fn, a in zip(fns, ins)])(inputs)
    return [jax.tree_util.tree_map(np.asarray, o) for o in out]


def _close(got, want, atol=STOI_ATOL, msg=""):
    g, w = got.numpy(), np.asarray(want)
    assert g.dtype == w.dtype, f"{msg}: {g.dtype} != {w.dtype}"
    assert_close(g.astype(np.float64), w.astype(np.float64), rtol=0.0, atol=atol, msg=msg)


# --------------------------------------------------------------------------- #
# STOI
# --------------------------------------------------------------------------- #
def test_hanning_window_against_jax():
    for m in (256, 258, 512):
        got = tstoi._hanning_np(m)
        want = np.asarray(jnp.hanning(m))
        diff = got.view(np.int32) - want.view(np.int32)
        # the same float32 formula; XLA's float32 cosine is not correctly
        # rounded in a few entries, which move the window by at most two ulp
        assert np.abs(diff).max() <= 2 and np.count_nonzero(diff) <= 4, (m, np.flatnonzero(diff))
    assert_bitwise(tstoi._stoi_window(torch.device("cpu")), tstoi._hanning_np(258)[1:-1])


def test_third_octave_matrix_is_the_jax_one():
    assert_bitwise(tstoi._third_octave_matrix(), jstoi._third_octave_matrix())


def _speechy(seed, n, fs=10000, silence=True):
    """A tone with noise and, optionally, a near-silent stretch (the
    silent-frame removal path), and a degraded copy."""
    rng = np.random.default_rng(seed)
    t = np.sin(2 * np.pi * 440 * np.arange(n) / fs) + 0.1 * rng.normal(size=n)
    if silence:
        t[n // 4: n // 4 + 3000] = 1e-6 * rng.normal(size=3000)
    p = t + 0.5 * rng.normal(size=n)
    return p.astype(np.float32), t.astype(np.float32)


def _stoi_jax(extended):
    return lambda p, t: mj.ops.short_time_objective_intelligibility(p, t, 10000, extended=extended)


STOI_PAIRS = [_speechy(20 + i, 20000) for i in range(3)]
STOI_P = np.stack([a for a, _ in STOI_PAIRS])
STOI_T = np.stack([b for _, b in STOI_PAIRS])
RESAMPLED = [(8000, False), (16000, False), (16000, True)]
SILENT = np.zeros(8000, np.float32)
SILENT[1000:1256] = 1.0  # one loud frame: long enough by shape, too few active frames


def _resampled(fs):
    """The inputs at ``fs`` and the JAX package's own resample step of them
    (scipy, float64, back to float32)."""
    p, t = _pair(31, (2, 2 * fs), noise=0.4)
    return p, t, [resample_poly(x.astype(np.float64), 10000, fs, axis=-1).astype(np.float32) for x in (p, t)]


@pytest.fixture(scope="module")
def stoi_refs():
    """The JAX package's STOI at 10 kHz of every case, from one jitted function."""
    cases = [(_stoi_jax(ext), (STOI_P, STOI_T)) for ext in (False, True)]
    cases += [(_stoi_jax(ext), tuple(_resampled(fs)[2])) for fs, ext in RESAMPLED]
    cases.append((_stoi_jax(False), (SILENT, SILENT)))
    out = _jax_all(cases)
    return {"oracle": out[:2], "resampled": dict(zip(RESAMPLED, out[2:5])), "silent": out[5]}


@pytest.mark.parametrize("extended", [False, True])
def test_stoi_matches_jax_and_the_numpy_oracle(extended, stoi_refs):
    got = mt.ops.short_time_objective_intelligibility(torch.from_numpy(STOI_P), torch.from_numpy(STOI_T), 10000, extended)
    _close(got, stoi_refs["oracle"][int(extended)])
    oracle = [_np_stoi(STOI_T[i].astype(np.float64), STOI_P[i].astype(np.float64), extended=extended) for i in range(3)]
    assert_close(got.numpy().astype(np.float64), np.asarray(oracle), rtol=0.0, atol=ORACLE_ATOL)


def test_silent_frame_removal_matches_jax():
    p, t = _speechy(30, 12000)
    x, y, n = tstoi._remove_silent_frames(torch.from_numpy(t)[None], torch.from_numpy(p)[None])
    jx, jy, jn = jax.jit(jstoi._remove_silent_frames)(jnp.asarray(t), jnp.asarray(p))
    assert int(n[0]) == int(jn) < tstoi._n_frames(12000)
    assert_close(x[0].numpy(), np.asarray(jx), rtol=0.0, atol=1e-6)
    assert_close(y[0].numpy(), np.asarray(jy), rtol=0.0, atol=1e-6)


@pytest.mark.parametrize("fs,extended", RESAMPLED)
def test_stoi_resamples_on_the_host_as_jax_does(fs, extended, stoi_refs):
    p, t, _ = _resampled(fs)
    got = mt.ops.short_time_objective_intelligibility(torch.from_numpy(p), torch.from_numpy(t), fs, extended)
    _close(got, stoi_refs["resampled"][(fs, extended)])


def test_stoi_nan_cases(stoi_refs):
    rng = np.random.default_rng(32)
    for n in (200, 2000):  # shorter than one frame; than one segment
        clip = torch.from_numpy(rng.normal(size=n).astype(np.float32))
        assert np.isnan(float(mt.ops.short_time_objective_intelligibility(clip, clip, 10000)))
    got = mt.ops.short_time_objective_intelligibility(torch.from_numpy(SILENT), torch.from_numpy(SILENT), 10000)
    assert np.isnan(float(got)) and np.isnan(float(stoi_refs["silent"]))


def test_stoi_one_dimensional_input_gives_a_scalar():
    p, t = _pair(33, (8000,), noise=0.2)
    got = mt.ops.short_time_objective_intelligibility(torch.from_numpy(p), torch.from_numpy(t), 10000)
    assert got.shape == ()


# --------------------------------------------------------------------------- #
# bfloat16 (the grid of tests/audio/test_precision_grids.py)
# --------------------------------------------------------------------------- #
_rng = np.random.default_rng(77)
_T1 = _rng.normal(size=(2000,)).astype(np.float32)
_P1 = _T1 + 0.3 * _rng.normal(size=(2000,)).astype(np.float32)
_T2 = _rng.normal(size=(4, 2000)).astype(np.float32)
_P2 = _T2 + 0.3 * _rng.normal(size=(4, 2000)).astype(np.float32)
_MIX_T = _rng.normal(size=(2, 3, 1500)).astype(np.float32)
_MIX_P = _MIX_T[:, ::-1] + 0.2 * _rng.normal(size=(2, 3, 1500)).astype(np.float32)
_LONG_T = _rng.normal(size=(8000,)).astype(np.float32)
_LONG_P = _LONG_T + 0.2 * _rng.normal(size=(8000,)).astype(np.float32)


def _cases(ops):
    return [
        ("snr-1d", lambda p, t: ops.signal_noise_ratio(p, t), _P1, _T1, 0.5),
        ("snr-2d", lambda p, t: ops.signal_noise_ratio(p, t), _P2, _T2, 0.5),
        ("si_snr", lambda p, t: ops.scale_invariant_signal_noise_ratio(p, t), _P2, _T2, 0.5),
        ("si_sdr", lambda p, t: ops.scale_invariant_signal_distortion_ratio(p, t), _P2, _T2, 0.5),
        ("si_sdr-zero_mean", lambda p, t: ops.scale_invariant_signal_distortion_ratio(p, t, zero_mean=True),
         _P2, _T2, 0.5),
        ("sdr", lambda p, t: ops.signal_distortion_ratio(p, t), _P2, _T2, 1.5),
        ("pit", lambda p, t: ops.permutation_invariant_training(p, t, ops.scale_invariant_signal_noise_ratio)[0],
         _MIX_P, _MIX_T, 0.5),
        ("stoi", lambda p, t: ops.short_time_objective_intelligibility(p, t, 10000), _LONG_P, _LONG_T, 0.05),
    ]


@pytest.fixture(scope="module")
def bf16_refs():
    """The JAX package's bfloat16 value of every grid case, from one jitted function."""
    cases = [(fn, (p.astype(jnp.bfloat16), t.astype(jnp.bfloat16))) for _, fn, p, t, _ in _cases(mj.ops)]
    return [np.asarray(v, np.float32) for v in _jax_all(cases)]


@pytest.mark.parametrize("case", range(8), ids=[c[0] for c in _cases(mt.ops)])
def test_bf16_tracks_f32_as_in_the_jax_grid(case, bf16_refs):
    name, fn, p, t, tol = _cases(mt.ops)[case]
    f32 = fn(torch.from_numpy(p.copy()), torch.from_numpy(t)).double().numpy()
    bf16 = fn(torch.from_numpy(p.copy()).bfloat16(), torch.from_numpy(t).bfloat16()).double().numpy()
    assert np.isfinite(bf16).all(), name
    np.testing.assert_allclose(bf16, f32, atol=tol, rtol=0.05, err_msg=name)
    # and the JAX package's bfloat16 value, within the same band
    np.testing.assert_allclose(bf16, bf16_refs[case].astype(np.float64), atol=tol, rtol=0.05, err_msg=name)
    if case < 6:  # mixed precision: a bfloat16 model output against a float32 target
        assert torch.isfinite(fn(torch.from_numpy(p.copy()).bfloat16(), torch.from_numpy(t)).float()).all(), name


def test_stoi_class_at_16k_is_the_mean_of_the_functional():
    metric = mt.ShortTimeObjectiveIntelligibility(16000, extended=True, device="cpu")
    values = []
    for seed in range(3):
        p, t = _pair(40 + seed, (2, 16000))
        metric.update(torch.from_numpy(p), torch.from_numpy(t))
        values.append(mt.ops.short_time_objective_intelligibility(torch.from_numpy(p), torch.from_numpy(t), 16000, True))
    assert int(metric.total) == 6
    assert_close(metric.compute().numpy(), torch.cat(values).mean().numpy(), rtol=1e-6, atol=1e-7)
