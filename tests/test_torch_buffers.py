"""``CatBuffer``'s captured part (``metrics_tpu_torch/core/buffers.py``)
against the JAX package's traced ``CatBuffer`` under ``jax.jit``.

A captured append (inside a compiled step: the value checks off) cannot grow
the buffer: it writes at the count clamped into ``[0, capacity - n]``, keeps
the true count, and sets the sticky overflow flag before the write; a batch
larger than the buffer is cut to ``capacity`` rows. Compaction (merge) is
one stable sort. Data, counts and flags are compared bit for bit, and so
are the host mirrors (``len``, ``overflow_seen``) against the JAX values.

The engine cases run the card's replay path on the CPU
(``tests/helpers/torch_port.py::use_card_replay_path``): a replay runs the
captured body, which appends into the step's static buffers in place.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt_jax
import metrics_tpu_torch as mt_torch
from metrics_tpu.core.buffers import CatBuffer as JaxCatBuffer
from metrics_tpu.utils.exceptions import MetricsUserError as JaxUserError
from metrics_tpu_torch.core.buffers import CatBuffer, buffers_in, writes_in_place
from metrics_tpu_torch.utils.checks import _checks_off
from metrics_tpu_torch.utils.exceptions import MetricsUserError, Uncapturable
from tests.helpers.torch_port import assert_bitwise, use_card_replay_path


@pytest.fixture(autouse=True)
def _engines_on():
    for pkg in (mt_jax, mt_torch):
        pkg.set_compiled_update(True)
        pkg.set_compiled_compute(True)
    yield
    for pkg in (mt_jax, mt_torch):
        pkg.set_compiled_update(None)
        pkg.set_compiled_compute(None)


def _rows(rng, n, width=3):
    return rng.normal(size=(n, width)).astype(np.float32)


def _assert_same_buffer(port: CatBuffer, jax_buf: JaxCatBuffer, msg: str = "") -> None:
    assert port.capacity == jax_buf.capacity, msg
    assert_bitwise(port.data, np.asarray(jax_buf.data), msg + " data")
    assert_bitwise(port.count, np.asarray(jax_buf.count), msg + " count")
    assert_bitwise(port.overflowed, np.asarray(jax_buf.overflowed), msg + " overflowed")
    assert len(port) == int(jax_buf.count), msg + " count mirror"
    assert port.overflow_seen == bool(jax_buf.overflowed), msg + " overflow mirror"


@jax.jit
def _jax_append(buf, x):
    new = buf.copy()
    new.append(x)
    return new


def _captured_append(buf: CatBuffer, x: np.ndarray) -> CatBuffer:
    """The port's append as a compiled step runs it: checks off, on a copy."""
    new = buf.copy()
    with _checks_off():
        new.append(torch.from_numpy(x))
    return new


# --------------------------------------------------------------------------- #
# the append, buffer against buffer
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("capacity,sizes", [
    (8, (3, 3, 3)),  # the third append overflows: rows 5..7 are overwritten
    (8, (3, 3, 3, 2, 8)),  # sticky, then a batch of the whole capacity
    (4, (6,)),  # one batch larger than the buffer, cut to 4 rows
    (4, (1, 9, 1)),  # larger than the buffer mid-stream
    (16, (5, 5, 6)),  # exactly full: no overflow
])
def test_captured_append_clamps_counts_and_flags_like_the_traced_jax_append(capacity, sizes):
    rng = np.random.default_rng(capacity + len(sizes))
    port = CatBuffer.empty(capacity, (3,))
    ref = JaxCatBuffer.empty(capacity, (3,))
    for k, n in enumerate(sizes):
        x = _rows(rng, n)
        port, ref = _captured_append(port, x), _jax_append(ref, jnp.asarray(x))
        _assert_same_buffer(port, ref, f"append {k}")


def test_overflow_raises_the_jax_text_on_to_array():
    rng = np.random.default_rng(3)
    port, ref = CatBuffer.empty(4, (3,)), JaxCatBuffer.empty(4, (3,))
    for n in (3, 3):
        x = _rows(rng, n)
        port, ref = _captured_append(port, x), _jax_append(ref, jnp.asarray(x))
    with pytest.raises(JaxUserError) as want:
        ref.to_array()
    with pytest.raises(MetricsUserError) as got:
        port.to_array()
    assert str(got.value) == str(want.value)


def test_to_array_inside_a_captured_step_is_uncapturable():
    buf = CatBuffer.from_array(torch.arange(3.0), capacity=4)
    with _checks_off(), pytest.raises(Uncapturable, match="data-dependent shape"):
        buf.to_array()


def test_an_eager_append_after_an_overflow_grows_and_keeps_the_flag():
    rng = np.random.default_rng(4)
    port, ref = CatBuffer.empty(4, (3,)), JaxCatBuffer.empty(4, (3,))
    for n in (3, 3):
        x = _rows(rng, n)
        port, ref = _captured_append(port, x), _jax_append(ref, jnp.asarray(x))
    x = _rows(rng, 5)
    port.append(torch.from_numpy(x))
    ref.append(jnp.asarray(x))
    _assert_same_buffer(port, ref, "eager after overflow")


@pytest.mark.parametrize("overflow", [False, True])
def test_captured_merge_compacts_like_the_traced_jax_merge(overflow):
    rng = np.random.default_rng(5 + overflow)
    a, ja = CatBuffer.empty(4, (3,)), JaxCatBuffer.empty(4, (3,))
    b, jb = CatBuffer.empty(6, (3,)), JaxCatBuffer.empty(6, (3,))
    for n in ((3, 3) if overflow else (3,)):
        x = _rows(rng, n)
        a, ja = _captured_append(a, x), _jax_append(ja, jnp.asarray(x))
    x = _rows(rng, 2)
    b, jb = _captured_append(b, x), _jax_append(jb, jnp.asarray(x))
    with _checks_off():
        merged = a.merge(b)
    _assert_same_buffer(merged, jax.jit(lambda u, v: u.merge(v))(ja, jb), "captured merge")
    # eager: an append unless an operand overflowed, then the same compaction
    _assert_same_buffer(a.merge(b), ja.merge(jb), "eager merge")


def test_copy_to_and_alias_carry_the_mirrors():
    buf = CatBuffer.empty(2, (1,))
    buf = _captured_append(buf, np.ones((3, 1), np.float32))
    for other in (buf.copy(), buf.to("cpu"), buf._alias()):
        assert (len(other), other.overflow_seen, other.capacity) == (3, True, 2)
    assert buf.copy().data.data_ptr() != buf.data.data_ptr()
    assert buf._alias().data is buf.data


def test_writes_in_place_skips_the_copy_in_update_state():
    metric = mt_torch.AUROC(buffer_capacity=8, device="cpu", compiled_update=False)
    metric.update(torch.tensor([0.1, 0.9]), torch.tensor([0, 1]))
    state = metric.get_state()
    with _checks_off(), writes_in_place():
        new = metric.update_state(state, torch.tensor([0.2, 0.8]), torch.tensor([1, 0]))
    assert new["preds"].data is state["preds"].data and len(new["preds"]) == 4
    assert len(state["preds"]) == 2  # the input buffer object keeps its mirror
    new = metric.update_state(metric.get_state(), torch.tensor([0.5]), torch.tensor([1]))
    assert new["preds"].data is not metric.preds.data


# --------------------------------------------------------------------------- #
# through the engines, on the card's replay path
# --------------------------------------------------------------------------- #
def _auroc_stream(rng, n_calls, rows=24):
    return [(rng.random(rows).astype(np.float32), rng.integers(0, 2, rows).astype(np.int32)) for _ in range(n_calls)]


def test_engine_appends_match_the_jax_engine_call_by_call(monkeypatch):
    """Capacity 64 and batches of 24: calls 1-2 eager (the first one
    materializes the buffer), call 3 probes and overflows (written at the
    clamped offset 40), call 4 replays; the warning fires once, at call 3."""
    use_card_replay_path(monkeypatch)
    rng = np.random.default_rng(6)
    ref = mt_jax.AUROC(pos_label=1, buffer_capacity=64)
    port = mt_torch.AUROC(pos_label=1, buffer_capacity=64, device="cpu")
    warned = []
    for k, (p, t) in enumerate(_auroc_stream(rng, 5)):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            ref.update(jnp.asarray(p), jnp.asarray(t))
            jax_warned = any("overflowed" in str(w.message) for w in rec)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            port.update(torch.from_numpy(p), torch.from_numpy(t))
            warned.append(any("overflowed" in str(w.message) for w in rec))
        assert warned[-1] == jax_warned, f"call {k}"
        for key in ("preds", "target"):
            _assert_same_buffer(getattr(port, key), getattr(ref, key), f"call {k} {key}")
    assert warned == [False, False, True, False, False]
    stats, jstats = port.engine_stats()["update"], ref.engine_stats()["update"]
    assert (stats.eager_calls, stats.cache_misses, stats.cache_hits) == (2, 1, 2)
    assert (stats.eager_calls, stats.cache_misses, stats.cache_hits, stats.donated_calls) == (
        jstats.eager_calls, jstats.cache_misses, jstats.cache_hits, jstats.donated_calls)
    assert len(port.preds) == 120 and port.preds.capacity == 64
    with pytest.raises(JaxUserError) as want:
        ref.compute()
    with pytest.raises(MetricsUserError) as got:
        port.compute()
    assert str(got.value) == str(want.value)
    port.reset()
    assert not port._overflow_reported and len(port.preds) == 0


def test_a_held_buffer_blocks_the_in_place_replay(monkeypatch):
    use_card_replay_path(monkeypatch)
    rng = np.random.default_rng(7)
    port = mt_torch.CalibrationError(n_bins=5, buffer_capacity=256, device="cpu")
    stream = [(rng.random(16).astype(np.float32), rng.integers(0, 2, 16)) for _ in range(6)]
    for p, t in stream[:4]:
        port.update(torch.from_numpy(p), torch.from_numpy(t))
    donated = port.engine_stats()["update"].donated_calls
    held = port.get_state()["confidences"]
    rows = held.data.clone()
    count = held.count.clone()
    port.update(*map(torch.from_numpy, stream[4]))
    assert port.engine_stats()["update"].donated_calls == donated  # refused: the snapshot holds the buffer
    assert_bitwise(held.data, rows.numpy())
    assert_bitwise(held.count, count.numpy())
    assert len(held) == 64 and len(port.confidences) == 80
    del held
    port.update(*map(torch.from_numpy, stream[5]))
    assert port.engine_stats()["update"].donated_calls == donated + 1
    eager = mt_torch.CalibrationError(n_bins=5, buffer_capacity=256, device="cpu", compiled_update=False)
    for p, t in stream:
        eager.update(torch.from_numpy(p), torch.from_numpy(t))
    assert_bitwise(port.compute(), eager.compute().numpy())


def test_metric_to_moves_counts_flags_and_mirrors():
    metric = mt_torch.ROC(buffer_capacity=8, device="cpu")
    metric.update(torch.tensor([0.2, 0.7, 0.4]), torch.tensor([0, 1, 1]))
    metric.to("cpu")
    for buf in buffers_in(metric.get_state()):
        assert buf.count.device.type == "cpu" and buf.overflowed.device.type == "cpu"
        assert len(buf) == 3 and not buf.overflow_seen
