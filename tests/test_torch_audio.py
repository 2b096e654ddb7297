"""The audio functionals of the port (``metrics_tpu_torch/ops/audio``)
against the JAX package's on the CPU, with the helpers under them: SNR,
SI-SNR and SI-SDR (``zero_mean``), SDR (``filter_length``, ``zero_mean``,
``load_diag``, ``use_cg_iter``; float64 against scipy's Toeplitz solver),
PIT (S = 2, 3 and 8, ``eval_func``, the Hungarian route against the
exhaustive one, ``pit_permutate``), the validation errors, and the audio
classes' construction and docstrings. STOI and the bfloat16 grid are in
``tests/test_torch_audio_stoi.py``, PESQ in ``tests/test_torch_audio_pesq.py``.

Inputs come from seeded numpy generators. The JAX references are jitted
(one compile a case) where they trace. ``RTOL = 1e-5`` relative for the dB
values: float32 sums over the time axis (SDR's through its FFTs, pocketfft
here against XLA's, and its solve) run in another order than XLA's.
Permutations, ``pit_permutate`` and the Toeplitz matrix compare bit for bit.
"""
import doctest
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import solve_toeplitz

import metrics_tpu as mj
import metrics_tpu_torch as mt
from metrics_tpu_torch.ops.audio import pit as tpit
from metrics_tpu_torch.utils.checks import _checks_off
from tests.helpers.torch_port import assert_bitwise, assert_close, one_torch_thread

pytestmark = [pytest.mark.filterwarnings("ignore"), pytest.mark.usefixtures("one_torch_thread")]

RTOL = 1e-5


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


def _close(got, want, rtol=RTOL, atol=0.0, msg=""):
    g, w = got.numpy(), np.asarray(want)
    assert g.dtype == w.dtype, f"{msg}: {g.dtype} != {w.dtype}"
    assert_close(g.astype(np.float64), w.astype(np.float64), rtol=rtol, atol=atol, msg=msg)


# --------------------------------------------------------------------------- #
# SNR, SI-SNR, SI-SDR
# --------------------------------------------------------------------------- #
SHAPES = [(2000,), (4, 2000), (2, 3, 500)]
DB_CASES = [(name, zero_mean, shape) for name in ("signal_noise_ratio", "scale_invariant_signal_distortion_ratio")
            for zero_mean in (False, True) for shape in SHAPES]
DB_CASES += [("scale_invariant_signal_noise_ratio", None, shape) for shape in SHAPES]


def _db_inputs(case):
    name, zero_mean, shape = case
    p, t = _pair(2 if zero_mean is None else 1, shape)
    kwargs = {} if zero_mean is None else {"zero_mean": zero_mean}
    return p, t, kwargs


@pytest.fixture(scope="module")
def db_refs():
    cases = []
    for case in DB_CASES:
        p, t, kwargs = _db_inputs(case)
        cases.append(((lambda fn, kw: lambda a, b: fn(a, b, **kw))(getattr(mj.ops, case[0]), kwargs), (p, t)))
    return dict(zip(DB_CASES, _jax_all(cases)))


@pytest.mark.parametrize("case", DB_CASES, ids=str)
def test_snr_si_snr_and_si_sdr_match_jax(case, db_refs):
    p, t, kwargs = _db_inputs(case)
    got = getattr(mt.ops, case[0])(torch.from_numpy(p), torch.from_numpy(t), **kwargs)
    want = db_refs[case]
    assert got.shape == want.shape
    _close(got, want, msg=str(case))


def test_eps_follows_the_input_dtype():
    # identical signals: (sum + eps) / (0 + eps), so the value shows which eps was added
    x = np.linspace(-1.0, 1.0, 64).astype(np.float32)
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        val = mt.ops.signal_noise_ratio(torch.from_numpy(x).to(dtype), torch.from_numpy(x).to(dtype))
        eps = torch.finfo(dtype).eps
        want = 10 * np.log10((np.sum(x.astype(np.float64) ** 2) + eps) / eps)
        assert val.dtype == dtype
        assert_close(val.double().numpy(), want, rtol=2e-2 if dtype == torch.bfloat16 else 1e-5)


# --------------------------------------------------------------------------- #
# SDR
# --------------------------------------------------------------------------- #
SDR_CASES = [
    dict(filter_length=64), dict(filter_length=128), dict(filter_length=64, zero_mean=True),
    dict(filter_length=64, load_diag=1e-3), dict(filter_length=64, use_cg_iter=10),
    dict(filter_length=128, use_cg_iter=30, load_diag=1e-2),
]


@pytest.fixture(scope="module")
def sdr_refs():
    p, t = _pair(3, (4, 2000))
    return _jax_all([((lambda kw: lambda a, b: mj.ops.signal_distortion_ratio(a, b, **kw))(kw), (p, t))
                     for kw in SDR_CASES])


@pytest.mark.parametrize("case", range(len(SDR_CASES)), ids=[str(kw) for kw in SDR_CASES])
def test_sdr_matches_jax(case, sdr_refs):
    p, t = _pair(3, (4, 2000))
    got = mt.ops.signal_distortion_ratio(torch.from_numpy(p), torch.from_numpy(t), **SDR_CASES[case])
    _close(got, sdr_refs[case], msg=str(SDR_CASES[case]))


def test_sdr_helpers_match_jax():
    from metrics_tpu.ops.audio import sdr as jsdr
    from metrics_tpu_torch.ops.audio import sdr as tsdr

    rng = np.random.default_rng(4)
    r0 = rng.normal(size=(3, 16)).astype(np.float32)
    x = rng.normal(size=(3, 16)).astype(np.float32)
    toeplitz = np.asarray(jax.jit(jsdr._symmetric_toeplitz)(jnp.asarray(r0)))
    assert_bitwise(tsdr._symmetric_toeplitz(torch.from_numpy(r0)), toeplitz)
    got = tsdr._toeplitz_matvec(torch.from_numpy(r0), torch.from_numpy(x))
    want = jax.jit(jsdr._toeplitz_matvec)(jnp.asarray(r0), jnp.asarray(x))
    assert_close(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the matvec is the dense product
    dense = np.einsum("bij,bj->bi", toeplitz.astype(np.float64), x)
    assert_close(got.numpy(), dense, rtol=1e-5, atol=1e-5)


def _np_sdr64(preds, target, filter_length):
    """SDR in float64 with scipy's Levinson solver (``tests/audio/test_audio.py:60-78``)."""
    out = []
    for p, t in zip(preds.reshape(-1, preds.shape[-1]), target.reshape(-1, target.shape[-1])):
        t = t / max(np.linalg.norm(t), 1e-6)
        p = p / max(np.linalg.norm(p), 1e-6)
        n_fft = 2 ** int(np.ceil(np.log2(2 * p.shape[-1] - 1)))
        t_fft = np.fft.rfft(t, n=n_fft)
        r = np.fft.irfft(np.abs(t_fft) ** 2, n=n_fft)[:filter_length]
        b = np.fft.irfft(np.conj(t_fft) * np.fft.rfft(p, n=n_fft), n=n_fft)[:filter_length]
        coh = b @ solve_toeplitz(r, b)
        out.append(10 * np.log10(coh / (1 - coh)))
    return np.asarray(out).reshape(preds.shape[:-1])


def test_sdr_computes_float64_inputs_in_float64():
    p, t = _pair(5, (3, 1000))
    p64, t64 = p.astype(np.float64), t.astype(np.float64)
    got = mt.ops.signal_distortion_ratio(torch.from_numpy(p64), torch.from_numpy(t64), filter_length=128)
    assert got.dtype == torch.float64
    # float64 through the whole chain: 1e-9 of scipy's Levinson solve
    assert_close(got.numpy(), _np_sdr64(p64, t64, 128), rtol=1e-9, atol=0.0)
    bf = mt.ops.signal_distortion_ratio(torch.from_numpy(p).bfloat16(), torch.from_numpy(t).bfloat16(), filter_length=128)
    assert bf.dtype == torch.float32


def test_sdr_solve_is_solve_ex_without_the_status_check():
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func._overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    p, t = _pair(6, (2, 200))
    with Ops():
        mt.ops.signal_distortion_ratio(torch.from_numpy(p), torch.from_numpy(t), filter_length=16)
    assert "_linalg_solve_ex" in seen and "_linalg_check_errors" not in seen and "_local_scalar_dense" not in seen


# --------------------------------------------------------------------------- #
# PIT
# --------------------------------------------------------------------------- #
def _mix(seed, b, s, n):
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(b, s, n)).astype(np.float32)
    perm = np.stack([rng.permutation(s) for _ in range(b)])
    p = np.take_along_axis(t, perm[:, :, None], axis=1) + 0.5 * rng.normal(size=(b, s, n)).astype(np.float32)
    return p.astype(np.float32), t


PIT_CASES = [(spk, eval_func, metric) for spk in (2, 3) for eval_func in ("max", "min")
             for metric in ("scale_invariant_signal_noise_ratio", "signal_noise_ratio")]
PIT_KW = _mix(12, 4, 2, 300)  # the keyword forwarded to the metric (zero_mean)
PIT_TIES = np.ones((2, 3, 50), np.float32) * np.arange(1, 51, dtype=np.float32)


@pytest.fixture(scope="module")
def pit_refs():
    def pit(metric, eval_func="max", **kw):
        return lambda a, b: mj.ops.permutation_invariant_training(a, b, getattr(mj.ops, metric), eval_func, **kw)

    cases = [(pit(metric, eval_func), _mix(10 + spk, 5, spk, 400)) for spk, eval_func, metric in PIT_CASES]
    cases.append((pit("signal_noise_ratio", zero_mean=True), PIT_KW))
    cases += [(pit("signal_noise_ratio", eval_func), (PIT_TIES, PIT_TIES)) for eval_func in ("max", "min")]
    out = _jax_all(cases)
    return {"cases": dict(zip(PIT_CASES, out)), "keyword": out[len(PIT_CASES)], "ties": out[len(PIT_CASES) + 1:]}


@pytest.mark.parametrize("case", PIT_CASES, ids=str)
def test_pit_matches_jax(case, pit_refs):
    spk, eval_func, metric = case
    p, t = _mix(10 + spk, 5, spk, 400)
    got = mt.ops.permutation_invariant_training(torch.from_numpy(p), torch.from_numpy(t), getattr(mt.ops, metric),
                                                eval_func)
    want = pit_refs["cases"][case]
    _close(got[0], want[0], msg="best metric")
    assert_bitwise(got[1], want[1], "permutation")


def test_pit_forwards_keywords_to_the_metric(pit_refs):
    p, t = PIT_KW
    got = mt.ops.permutation_invariant_training(torch.from_numpy(p), torch.from_numpy(t), mt.ops.signal_noise_ratio,
                                                zero_mean=True)
    want = pit_refs["keyword"]
    _close(got[0], want[0])
    assert_bitwise(got[1], want[1])


def test_pit_with_eight_speakers_takes_the_hungarian_route_eagerly():
    p, t = _mix(13, 3, 8, 200)
    tp, tt = torch.from_numpy(p), torch.from_numpy(t)
    eager = mt.ops.permutation_invariant_training(tp, tt, mt.ops.scale_invariant_signal_noise_ratio)
    with _checks_off():  # as under the engines' probe: the exhaustive table (8! rows)
        exhaustive = mt.ops.permutation_invariant_training(tp, tt, mt.ops.scale_invariant_signal_noise_ratio)
    assert tpit._permutation_table(8, torch.device("cpu")).shape == (40320, 8)
    assert_bitwise(eager[1], exhaustive[1], "Hungarian against exhaustive")
    assert_close(eager[0].numpy(), exhaustive[0].numpy(), rtol=1e-6, atol=1e-6)
    want = mj.ops.permutation_invariant_training(jnp.asarray(p), jnp.asarray(t), mj.ops.scale_invariant_signal_noise_ratio)
    assert_bitwise(eager[1], want[1], "Hungarian against the JAX package's (eager: its Hungarian route)")
    _close(eager[0], want[0])


def test_pit_ties_take_the_first_permutation(pit_refs):
    for eval_func, want in zip(("max", "min"), pit_refs["ties"]):
        got = mt.ops.permutation_invariant_training(torch.from_numpy(PIT_TIES), torch.from_numpy(PIT_TIES),
                                                    mt.ops.signal_noise_ratio, eval_func)
        assert_bitwise(got[1], want[1])
        assert got[1].tolist() == [[0, 1, 2]] * 2


def test_pit_permutate_matches_jax():
    rng = np.random.default_rng(14)
    preds = rng.normal(size=(3, 4, 2, 10)).astype(np.float32)
    perm = np.stack([rng.permutation(4) for _ in range(3)]).astype(np.int32)
    got = mt.ops.pit_permutate(torch.from_numpy(preds), torch.from_numpy(perm))
    assert_bitwise(got, mj.ops.pit_permutate(jnp.asarray(preds), jnp.asarray(perm)))


def test_pit_validation():
    f = mt.ops.scale_invariant_signal_distortion_ratio
    with pytest.raises(ValueError, match='eval_func can only be "max" or "min" but got med'):
        mt.ops.permutation_invariant_training(torch.zeros(2, 2, 10), torch.zeros(2, 2, 10), f, "med")
    with pytest.raises(RuntimeError, match="same shape at the batch and speaker dimensions"):
        mt.ops.permutation_invariant_training(torch.zeros(2, 2, 10), torch.zeros(2, 3, 10), f)
    with pytest.raises(ValueError, match=r"Inputs must be of shape \[batch, spk, ...\]"):
        mt.ops.permutation_invariant_training(torch.zeros(2), torch.zeros(2), f)


# --------------------------------------------------------------------------- #
# the classes: construction, defaults, docstrings
# --------------------------------------------------------------------------- #
_CLASSES = [
    ("SignalNoiseRatio", {}), ("ScaleInvariantSignalNoiseRatio", {}), ("ScaleInvariantSignalDistortionRatio", {}),
    ("SignalDistortionRatio", {}), ("PermutationInvariantTraining", {"metric_func": mt.ops.signal_noise_ratio}),
    ("ShortTimeObjectiveIntelligibility", {"fs": 16000}),
    ("PerceptualEvaluationSpeechQuality", {"fs": 16000, "mode": "wb", "implementation": "native"}),
]


@pytest.mark.parametrize("name,kwargs", _CLASSES, ids=[c[0] for c in _CLASSES])
def test_audio_classes_default_to_cuda_and_raise_without_a_card(name, kwargs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        getattr(mt, name)(**kwargs)
    metric = getattr(mt, name)(device="cpu", **kwargs)
    assert metric.sum_metric.dtype == torch.float32 and metric.sum_metric.shape == ()
    assert metric.total.dtype == torch.int32 and metric.total.shape == ()


def test_pit_class_keyword_split():
    pit = mt.PermutationInvariantTraining(mt.ops.signal_noise_ratio, eval_func="min", device="cpu",
                                          compiled_update=False, compiled_compute=False, zero_mean=True)
    assert pit.kwargs == {"zero_mean": True}
    assert pit._compiled_update is False and pit._compiled_compute is False and pit.eval_func == "min"
    p, t = _mix(15, 4, 2, 300)
    pit.update(torch.from_numpy(p), torch.from_numpy(t))
    best = jax.jit(lambda a, b: mj.ops.permutation_invariant_training(a, b, mj.ops.signal_noise_ratio, "min",
                                                                      zero_mean=True)[0])(jnp.asarray(p), jnp.asarray(t))
    _close(pit.compute(), jnp.mean(best))
    # an unknown keyword reaches the metric function, as in the JAX class
    bad = mt.PermutationInvariantTraining(mt.ops.signal_noise_ratio, device="cpu", not_a_keyword=1)
    with pytest.raises(TypeError, match="not_a_keyword"):
        bad.update(torch.from_numpy(p), torch.from_numpy(t))


def test_the_jax_class_forwards_an_engine_switch_to_the_metric():
    # found in the reference (ROADMAP queue C): the JAX class pops only its
    # five sync keywords, so `compiled_update` reaches `metric_func`
    ref = mj.PermutationInvariantTraining(mj.ops.signal_noise_ratio, compiled_update=False)
    assert ref.kwargs == {"compiled_update": False}
    with pytest.raises(TypeError, match="compiled_update"):
        ref.update(jnp.ones((2, 2, 50)), jnp.ones((2, 2, 50)))


def test_stoi_class_rejects_a_non_positive_rate():
    for fs in (0, -8000):
        with pytest.raises(ValueError, match=f"Expected argument `fs` to be a positive integer, but got {fs}"):
            mt.ShortTimeObjectiveIntelligibility(fs, device="cpu")


@pytest.mark.parametrize("name,kwargs", [
    ("SignalNoiseRatio", dict(zero_mean=True)), ("ScaleInvariantSignalDistortionRatio", dict(zero_mean=True)),
], ids=str)
def test_classes_with_options_over_a_stream_match_jax(name, kwargs):
    ref = getattr(mj, name)(**kwargs, compiled_update=False, compiled_compute=False)
    port = getattr(mt, name)(device="cpu", **kwargs)
    for seed in range(3):
        p, t = _pair(40 + seed, (2, 16000))
        ref.update(jnp.asarray(p), jnp.asarray(t))
        port.update(torch.from_numpy(p), torch.from_numpy(t))
    _close(port.compute(), ref.compute())
    assert int(port.total) == int(ref.total) == 6


AUDIO_MODULES = [f"metrics_tpu_torch.{m}" for m in (
    "ops.audio.snr", "ops.audio.sdr", "ops.audio.pit", "ops.audio.stoi", "ops.audio.pesq_native",
    "ops.audio.pesq", "audio.snr", "audio.sdr", "audio.pit", "audio.stoi", "audio.pesq",
)]


@pytest.mark.parametrize("module", AUDIO_MODULES)
def test_audio_docstring_examples(module):
    result = doctest.testmod(importlib.import_module(module), optionflags=doctest.ELLIPSIS)
    assert result.attempted > 0 and result.failed == 0, result
