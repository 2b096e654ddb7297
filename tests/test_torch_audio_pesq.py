"""PESQ of the port (``metrics_tpu_torch/ops/audio/pesq_native.py``,
``pesq.py`` and the class) against the JAX package's on the CPU: the pinned
golden degradations of ``tests/audio/test_pesq_native.py`` in both modes
(scores, chosen delays and active-frame counts), pure delays, the numpy
tables, the bfloat16 grid's case, the validation errors, and the ``"pesq"``
route's gate, without the extension and with the JAX test's stand-in module.

Inputs: the JAX test's own speech-like signals and seeded noise. The JAX
references are jitted (one compile per length). Tolerances, each with its
reason:

- ``MOS_ATOL = 1e-4`` against the JAX package's MOS: float32 FFTs
  (pocketfft here, XLA's there), band sums and the L6/L2 aggregation in
  another order, on scores in [1, 4.64];
- 2e-2 against the pinned goldens, the JAX test's own bound
  (``tests/audio/test_pesq_native.py:173-178``);
- equal: the chosen frame delays and the active-frame counts, discrete
  decisions that a last-bit difference could flip and that would move a
  score by far more than the tolerance;
- the bfloat16 grid's band, 0.15 (``tests/audio/test_precision_grids.py:38``).
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mj
import metrics_tpu_torch as mt
from metrics_tpu.ops.audio import pesq_native as jpesq
from metrics_tpu_torch.ops.audio import pesq as tpesq_ops
from metrics_tpu_torch.ops.audio import pesq_native as tpesq
from tests.audio.test_audio import _FakePesqBackend, _pesq_waveforms
from tests.audio.test_pesq_native import _GOLDEN_MOS, _golden_degradations, _speech_like
from tests.helpers.torch_port import assert_bitwise, assert_close, one_torch_thread

pytestmark = [pytest.mark.filterwarnings("ignore"), pytest.mark.usefixtures("one_torch_thread")]

MOS_ATOL = 1e-4
GOLDEN_ATOL = 2e-2
MODES = [(8000, "nb"), (16000, "wb")]


def _jax_all(cases):
    """Each case's JAX value, ``fn(*arrays)`` for every ``(fn, arrays)``, from
    one jitted function (one compile for a group of cases, not one each)."""
    fns = [fn for fn, _ in cases]
    inputs = [[jnp.asarray(a) for a in arrays] for _, arrays in cases]
    out = jax.jit(lambda ins: [fn(*a) for fn, a in zip(fns, ins)])(inputs)
    return [jax.tree_util.tree_map(np.asarray, o) for o in out]


def _jax_parts(fs, mode):
    """The JAX package's MOS, chosen delay and active-frame counts of each
    (ref, deg) row, over the batch."""

    def one(ref, deg):
        spec_r = jpesq._filtered_spec(ref, fs, mode)
        spec_d = jpesq._filtered_spec(deg, fs, mode)
        active = [jnp.sum(jnp.sum(s, -1) > 1e-4 * jnp.max(jnp.sum(s, -1))) for s in (spec_r, spec_d)]
        delay = jpesq._align_delay_frames(spec_r * jpesq._level_gain_pow(spec_r), spec_d * jpesq._level_gain_pow(spec_d))
        return jpesq._pesq_single(ref, deg, fs, mode), delay, active[0], active[1]

    return jax.vmap(one)


@pytest.fixture(scope="module", params=MODES, ids=[m for _, m in MODES])
def golden(request):
    fs, mode = request.param
    ref, degs = _golden_degradations(fs)
    refs = np.stack([ref] * len(degs))
    degs = np.stack(degs)
    want = list(_jax_all([(_jax_parts(fs, mode), (refs, degs))])[0])
    got = [x.numpy() for x in tpesq._pesq_parts(torch.from_numpy(refs), torch.from_numpy(degs), fs, mode)]
    return dict(fs=fs, mode=mode, refs=refs, degs=degs, want=want, got=got)


def test_golden_scores_match_jax_and_the_pins(golden):
    got, want = golden["got"][0], golden["want"][0]
    assert got.dtype == want.dtype == np.float32
    assert_close(got.astype(np.float64), want.astype(np.float64), rtol=0.0, atol=MOS_ATOL)
    assert_close(got, np.asarray(_GOLDEN_MOS[(golden["fs"], golden["mode"])], np.float32), rtol=0.0, atol=GOLDEN_ATOL)


def test_golden_delays_and_active_frames_equal_jax(golden):
    for k, what in ((1, "delay"), (2, "active reference frames"), (3, "active degraded frames")):
        np.testing.assert_array_equal(golden["got"][k].astype(np.int64), golden["want"][k].astype(np.int64), err_msg=what)


def test_golden_batch_through_the_public_function(golden):
    got = tpesq.pesq_native(torch.from_numpy(golden["degs"]), torch.from_numpy(golden["refs"]), golden["fs"],
                            golden["mode"])
    assert_bitwise(got, golden["got"][0], "pesq_native against _pesq_parts")
    one = tpesq.pesq_native(torch.from_numpy(golden["degs"][3]), torch.from_numpy(golden["refs"][3]), golden["fs"],
                            golden["mode"])
    assert one.shape == ()
    # rows are independent up to the batched FFT's rounding
    assert_close(float(one), float(golden["got"][0][3]), rtol=0.0, atol=1e-5)


# the JAX test's speech under a seeded syllable envelope (its own envelope is
# periodic, and its correlation peak not prominent), shifted by whole frame hops
SHIFTS = (3, -4, 0)
_ENVELOPE = np.repeat(np.random.default_rng(3).uniform(0.05, 1.0, size=80), 400).astype(np.float32)
DELAY_REF = _speech_like(4 * 8000, 8000) * _ENVELOPE
DELAY_REFS = np.stack([DELAY_REF] * len(SHIFTS))
DELAY_DEGS = np.stack([np.roll(DELAY_REF, s * 128) for s in SHIFTS])


def _noisy(fs):
    rng = np.random.default_rng(50 + fs)
    t = rng.normal(size=(3, fs)).astype(np.float32)
    return (t + 0.5 * rng.normal(size=(3, fs))).astype(np.float32), t


@pytest.fixture(scope="module")
def more_refs():
    """The JAX package's parts on the pure delays and its MOS on noise in both
    modes, from one jitted function."""
    parts = _jax_parts(8000, "nb")
    cases = [(parts, (DELAY_REFS, DELAY_DEGS))]
    cases += [((lambda fs, mode: lambda a, b: jpesq.pesq_native(a, b, fs, mode))(fs, mode), _noisy(fs)) for fs, mode in MODES]
    out = [list(o) if isinstance(o, (list, tuple)) else o for o in _jax_all(cases)]
    return {"delays": out[0], "noisy": dict(zip(MODES, out[1:]))}


def test_pure_delays_are_found_and_absorbed(more_refs):
    got = tpesq._pesq_parts(torch.from_numpy(DELAY_REFS), torch.from_numpy(DELAY_DEGS), 8000, "nb")
    want = more_refs["delays"]
    assert got[1].tolist() == np.asarray(want[1]).tolist() == list(SHIFTS)
    assert (got[0] > 4.4).all()
    assert_close(got[0].numpy().astype(np.float64), np.asarray(want[0], np.float64), rtol=0.0, atol=MOS_ATOL)


@pytest.mark.parametrize("fs,mode", MODES)
def test_noisy_batches_match_jax_in_both_modes(fs, mode, more_refs):
    p, t = _noisy(fs)
    got = mt.ops.perceptual_evaluation_speech_quality(torch.from_numpy(p), torch.from_numpy(t), fs, mode,
                                                      implementation="native")
    want = more_refs["noisy"][(fs, mode)]
    assert_close(got.numpy().astype(np.float64), np.asarray(want, np.float64), rtol=0.0, atol=MOS_ATOL, msg=mode)


@pytest.mark.parametrize("fs,mode", MODES)
def test_tables_are_the_jax_ones(fs, mode):
    for a, b in zip(tpesq._band_matrix(fs), jpesq._band_matrix(fs)):
        assert_bitwise(a, b)
    assert_bitwise(tpesq._abs_threshold(fs), jpesq._abs_threshold(fs))
    assert_bitwise(tpesq._receive_filter(fs, mode), jpesq._receive_filter(fs, mode))
    tables = tpesq._tables(fs, mode, torch.device("cpu"))
    assert_bitwise(tables["thr"], np.asarray(jnp.asarray(jpesq._abs_threshold(fs)) * 1e4))
    assert_bitwise(tables["filter_sq"], np.asarray(jnp.asarray(jpesq._receive_filter(fs, mode)) ** 2))


def test_bf16_tracks_f32_as_in_the_jax_grid():
    rng = np.random.default_rng(77)
    t = rng.normal(size=(8000,)).astype(np.float32)
    p = t + 0.2 * rng.normal(size=(8000,)).astype(np.float32)
    f32 = float(tpesq.pesq_native(torch.from_numpy(p), torch.from_numpy(t), 8000, "nb"))
    bf16 = float(tpesq.pesq_native(torch.from_numpy(p).bfloat16(), torch.from_numpy(t).bfloat16(), 8000, "nb"))
    assert np.isfinite(bf16)
    np.testing.assert_allclose(bf16, f32, atol=0.15, rtol=0.05)


def test_native_validation():
    x = torch.zeros(8000)
    with pytest.raises(ValueError, match=r"`fs` must be one of \(8000, 16000\); got 44100"):
        tpesq.pesq_native(x, x, 44100, "nb")
    with pytest.raises(ValueError, match=r"`mode` must be one of \('wb', 'nb'\); got 'speech'"):
        tpesq.pesq_native(x, x, 16000, "speech")
    with pytest.raises(ValueError, match="Expected argument `mode` to be 'nb' for a 8000Hz signal"):
        tpesq.pesq_native(x, x, 8000, "wb")
    with pytest.raises(RuntimeError, match="must have the same shape"):
        tpesq.pesq_native(x, torch.zeros(7999), 8000, "nb")
    with pytest.raises(ValueError, match=r"`implementation` must be one of \('pesq', 'native'\); got 'bogus'"):
        mt.ops.perceptual_evaluation_speech_quality(x, x, 8000, "nb", implementation="bogus")


# --------------------------------------------------------------------------- #
# the C-extension route: its gate, and its plumbing through a stand-in
# --------------------------------------------------------------------------- #
def test_the_pesq_route_is_gated_without_the_extension():
    assert tpesq_ops._PESQ_AVAILABLE is False  # not installed here
    x = torch.zeros(8000)
    with pytest.raises(ModuleNotFoundError, match="PESQ metric requires that pesq is installed"):
        mt.ops.perceptual_evaluation_speech_quality(x, x, 8000, "nb")
    with pytest.raises(ModuleNotFoundError, match="requires that `pesq` is installed"):
        mt.PerceptualEvaluationSpeechQuality(16000, "wb", device="cpu")


@pytest.fixture
def fake_pesq(monkeypatch):
    import metrics_tpu.audio.pesq as jax_pesq_module
    import metrics_tpu.ops.audio.pesq as jax_pesq_ops

    monkeypatch.setitem(sys.modules, "pesq", _FakePesqBackend)
    for module in (jax_pesq_ops, jax_pesq_module, tpesq_ops):
        monkeypatch.setattr(module, "_PESQ_AVAILABLE", True)
    return _FakePesqBackend


def test_the_pesq_route_through_a_stand_in_matches_jax(fake_pesq):
    preds, target = _pesq_waveforms()
    got = mt.ops.perceptual_evaluation_speech_quality(torch.from_numpy(preds), torch.from_numpy(target), 8000, "nb")
    want = mj.ops.perceptual_evaluation_speech_quality(jnp.asarray(preds), jnp.asarray(target), 8000, "nb")
    assert got.shape == (2, 3) and got.device.type == "cpu"
    assert_bitwise(got, np.asarray(want))
    one = mt.ops.perceptual_evaluation_speech_quality(torch.from_numpy(preds[0, 0]), torch.from_numpy(target[0, 0]),
                                                      16000, "wb", keep_same_device=True)
    assert_bitwise(one, np.asarray(mj.ops.perceptual_evaluation_speech_quality(
        jnp.asarray(preds[0, 0]), jnp.asarray(target[0, 0]), 16000, "wb")))


def test_the_pesq_route_validation(fake_pesq):
    preds, target = _pesq_waveforms(shape=(1,))
    p, t = torch.from_numpy(preds), torch.from_numpy(target)
    with pytest.raises(ValueError, match="to either be 8000 or 16000"):
        mt.ops.perceptual_evaluation_speech_quality(p, t, 44100, "nb")
    with pytest.raises(ValueError, match="to either be 'wb' or 'nb'"):
        mt.ops.perceptual_evaluation_speech_quality(p, t, 16000, "speech")
    with pytest.raises(ValueError, match="'nb' for a 8000Hz signal"):
        mt.ops.perceptual_evaluation_speech_quality(p, t, 8000, "wb")


def test_the_class_accumulates_the_pesq_route_as_jax_does(fake_pesq):
    preds, target = _pesq_waveforms(shape=(4,))
    port = mt.PerceptualEvaluationSpeechQuality(fs=8000, mode="nb", device="cpu")
    ref = mj.PerceptualEvaluationSpeechQuality(fs=8000, mode="nb", compiled_update=False, compiled_compute=False)
    for sl in (slice(0, 2), slice(2, 4)):
        port.update(torch.from_numpy(preds[sl]), torch.from_numpy(target[sl]))
        ref.update(jnp.asarray(preds[sl]), jnp.asarray(target[sl]))
    assert_bitwise(port.compute(), np.asarray(ref.compute()))
    assert int(port.total) == 4


def test_class_construction_checks():
    with pytest.raises(ValueError, match="Expected argument `fs` to either be 8000 or 16000 but got 44100"):
        mt.PerceptualEvaluationSpeechQuality(44100, "nb", implementation="native", device="cpu")
    with pytest.raises(ValueError, match="Expected argument `mode` to either be 'wb' or 'nb' but got speech"):
        mt.PerceptualEvaluationSpeechQuality(16000, "speech", implementation="native", device="cpu")
    with pytest.raises(ValueError, match="Expected argument `mode` to be 'nb' for a 8000Hz signal"):
        mt.PerceptualEvaluationSpeechQuality(8000, "wb", implementation="native", device="cpu")
    with pytest.raises(ValueError, match="implementation"):
        mt.PerceptualEvaluationSpeechQuality(8000, "nb", implementation="bogus", device="cpu")
