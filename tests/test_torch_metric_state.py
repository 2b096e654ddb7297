"""``Metric.astype`` and the pure ``reset_state`` of the port against the JAX
package's (ROADMAP queue C, C3): the cast reaches the floating states and
their defaults, so it survives ``reset()``; ``reset_state(state)`` restores
the defaults and keeps a ``CatBuffer``'s shape and capacity. The masked,
tenant-stacked reset is not ported and raises.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as M
import metrics_tpu_torch as mt
from metrics_tpu.core.buffers import CatBuffer as JaxCatBuffer
from metrics_tpu_torch.utils.exceptions import MetricsUserError
from tests.helpers.testers import DummyMetricSum
from tests.helpers.torch_port import assert_bitwise

pytestmark = pytest.mark.filterwarnings("ignore")

_rng = np.random.default_rng(1011)
PROBS = _rng.dirichlet(np.ones(4), size=24).astype(np.float32)
LABELS = _rng.integers(0, 4, 24).astype(np.int32)  # the JAX package keeps int32 labels
VALUES = _rng.random(24).astype(np.float32)


class PortSum(mt.Metric):
    """The port twin of ``tests/helpers/testers.py``'s DummyMetricSum."""

    full_state_update = True

    def __init__(self, **kwargs):
        super().__init__(device="cpu", **kwargs)
        self.add_state("x", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, x):
        self.x = self.x + x

    def compute(self):
        return self.x


# --------------------------------------------------------------------------- #
# astype
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64, torch.float16])
def test_astype_survives_reset(dtype):
    m = PortSum().astype(dtype)
    m.update(torch.tensor(1.0, dtype=dtype))
    assert m.x.dtype == dtype
    m.reset()
    assert m.x.dtype == dtype and float(m.x) == 0.0
    assert m._defaults["x"].dtype == dtype


def test_astype_bfloat16_matches_jax():
    ref = DummyMetricSum().astype(jnp.bfloat16)
    ref.update(jnp.asarray(1.5, jnp.bfloat16))
    ref.reset()
    ref.update(jnp.asarray(2.5, jnp.bfloat16))
    port = PortSum().astype(torch.bfloat16)
    port.update(torch.tensor(1.5, dtype=torch.bfloat16))
    port.reset()
    port.update(torch.tensor(2.5, dtype=torch.bfloat16))
    assert str(ref.x.dtype) == "bfloat16" and port.x.dtype == torch.bfloat16
    assert float(port.x) == float(ref.x) == 2.5


@pytest.mark.parametrize("name,make_jax,make_port,args", [
    ("Accuracy", lambda: M.Accuracy(num_classes=4), lambda: mt.Accuracy(num_classes=4, device="cpu"), (PROBS, LABELS)),
    ("MeanMetric", lambda: M.MeanMetric(), lambda: mt.MeanMetric(device="cpu"), (VALUES,)),
    ("MeanSquaredError", lambda: M.MeanSquaredError(), lambda: mt.MeanSquaredError(device="cpu"), (VALUES, VALUES[::-1].copy())),
])
def test_astype_casts_the_floating_states_only(name, make_jax, make_port, args):
    ref, port = make_jax().astype(jnp.bfloat16), make_port().astype(torch.bfloat16)
    for key in ref._defaults:
        assert str(ref._defaults[key].dtype) == str(port._defaults[key].dtype).replace("torch.", ""), key
        assert str(getattr(ref, key).dtype) == str(getattr(port, key).dtype).replace("torch.", ""), key
    if name == "Accuracy":
        assert all(v.dtype == torch.int32 for v in port.get_state().values())
    port.update(*map(torch.from_numpy, args))
    port.reset()
    assert {k: v.dtype for k, v in port.get_state().items()} == {k: v.dtype for k, v in port._defaults.items()}


def test_astype_casts_a_buffer_and_its_rows_stay():
    port = mt.CatMetric(buffer_capacity=32, device="cpu", compiled_update=False)
    port.update(torch.from_numpy(VALUES[:5]))
    port.astype(torch.float64)
    buf = port.value
    assert buf.data.dtype == torch.float64 and buf.count.dtype == torch.int32 and len(buf) == 5
    assert_bitwise(buf.data[:5].float(), VALUES[:5])
    port.reset()
    assert not port.value.materialized  # an unmaterialized default stays as it is
    m = mt.CatMetric(buffer_capacity=8, device="cpu").astype(torch.bfloat16)
    assert not m.value.materialized


def test_astype_drops_the_engines_and_captures_again():
    m = mt.MeanMetric(device="cpu")
    for _ in range(3):
        m.update(torch.from_numpy(VALUES))
    assert m._update_engine is not None
    m.astype(torch.float64)
    assert m._update_engine is None
    for _ in range(3):
        m.update(torch.from_numpy(VALUES).double())
    assert m.value.dtype == torch.float64 and m.weight.dtype == torch.float64
    want = np.mean(np.concatenate([VALUES.astype(np.float64)] * 3))
    np.testing.assert_allclose(float(m.compute()), want, rtol=1e-6)


# --------------------------------------------------------------------------- #
# reset_state
# --------------------------------------------------------------------------- #
def _jax_leaf(v):
    return v


def _assert_same_reset(got, want, msg):
    assert set(got) == set(want), msg
    for key, w in want.items():
        g = got[key]
        where = f"{msg}: {key}"
        if isinstance(w, JaxCatBuffer):
            assert isinstance(g, mt.CatBuffer), where
            assert g.capacity == w.capacity and g.materialized == w.materialized, where
            assert int(g.count) == int(w.count) == 0 and len(g) == 0 and not g.overflow_seen, where
            if w.materialized:
                assert tuple(g.data.shape) == tuple(w.data.shape), where
                assert_bitwise(g.data, np.asarray(w.data), where)
        elif isinstance(w, list):
            assert g == [] and w == [], where
        else:
            assert_bitwise(g, np.asarray(w), where)


RESET_CASES = {
    "Accuracy": (lambda: M.Accuracy(num_classes=4), lambda **kw: mt.Accuracy(num_classes=4, **kw), (PROBS, LABELS)),
    "MeanSquaredError": (lambda: M.MeanSquaredError(), lambda **kw: mt.MeanSquaredError(**kw), (VALUES, VALUES[::-1].copy())),
    "MinMetric": (lambda: M.MinMetric(), lambda **kw: mt.MinMetric(**kw), (VALUES,)),
    "CatMetric list": (lambda: M.CatMetric(), lambda **kw: mt.CatMetric(**kw), (VALUES,)),
    "CatMetric buffered": (lambda: M.CatMetric(buffer_capacity=64), lambda **kw: mt.CatMetric(buffer_capacity=64, **kw),
                           (VALUES,)),
    "AUROC buffered": (lambda: M.AUROC(num_classes=4, buffer_capacity=64),
                       lambda **kw: mt.AUROC(num_classes=4, buffer_capacity=64, **kw), (PROBS, LABELS)),
    "BinnedPrecisionRecallCurve": (lambda: M.BinnedPrecisionRecallCurve(num_classes=4, thresholds=11),
                                   lambda **kw: mt.BinnedPrecisionRecallCurve(num_classes=4, thresholds=11, **kw),
                                   (PROBS, LABELS)),
}


@pytest.mark.parametrize("name", sorted(RESET_CASES))
def test_reset_state_matches_jax(name):
    make_jax, make_port, args = RESET_CASES[name]
    ref, port = make_jax(), make_port(device="cpu", compiled_update=False, compiled_compute=False)
    ref_state = ref.update_state(ref.init_state(), *map(jnp.asarray, args))
    port_state = port.update_state(port.init_state(), *map(torch.from_numpy, args))
    before = {k: (v.copy() if isinstance(v, mt.CatBuffer) else list(v) if isinstance(v, list) else v.clone())
              for k, v in port_state.items()}
    got = port.reset_state(port_state)
    _assert_same_reset(got, ref.reset_state(ref_state), name)
    # pure: the state it was given is untouched
    for key, value in before.items():
        if isinstance(value, mt.CatBuffer):
            assert len(port_state[key]) == len(value) and torch.equal(port_state[key].data, value.data)
        elif isinstance(value, list):
            assert len(port_state[key]) == len(value)
        else:
            assert torch.equal(port_state[key], value)
    # and a reset state advances as a fresh one does
    again = port.update_state(got, *map(torch.from_numpy, args))
    fresh = port.update_state(port.init_state(), *map(torch.from_numpy, args))
    assert port.compute_state(again).__class__ is port.compute_state(fresh).__class__
    for a, b in zip(_leaves(port.compute_state(again)), _leaves(port.compute_state(fresh))):
        assert torch.equal(a, b), name


def _leaves(x):
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return [x]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_reset_state_keeps_the_cast(dtype):
    port = mt.MeanSquaredError(device="cpu").astype(dtype)
    state = port.update_state(port.init_state(), torch.from_numpy(VALUES).to(dtype), torch.from_numpy(VALUES).to(dtype))
    out = port.reset_state(state)
    assert out["sum_squared_error"].dtype == dtype and float(out["sum_squared_error"]) == 0.0
    assert out["total"].dtype == port._defaults["total"].dtype


def test_reset_state_keeps_an_overflowed_buffers_shape_and_clears_its_flag():
    port = mt.CatMetric(buffer_capacity=4, device="cpu")
    state = port.init_state()
    state["value"] = mt.CatBuffer(torch.arange(4, dtype=torch.float32), 7, overflowed=True)
    out = port.reset_state(state)
    buf = out["value"]
    assert buf.capacity == 4 and tuple(buf.data.shape) == (4,) and len(buf) == 0
    assert not buf.overflow_seen and not bool(buf.overflowed) and int(buf.count) == 0
    assert torch.equal(buf.data, torch.zeros(4))


def test_masked_reset_state_is_not_ported():
    # ported since tenancy: the masked (tenant-stacked) reset restores only
    # the masked rows, as the JAX package's does, and refuses a non-bool mask
    rng = np.random.default_rng(5)
    ref = M.MetricCollection([M.MeanSquaredError(), M.MaxMetric()])
    port = mt.MetricCollection([mt.MeanSquaredError(device="cpu"), mt.MaxMetric(device="cpu")])
    stacked = {
        lname: {k: rng.normal(size=(4, *np.shape(np.asarray(v)))).astype(np.asarray(v).dtype)
                for k, v in st.items()}
        for lname, st in ref.init_state().items()
    }
    mask = np.array([True, False, True, False])
    want = ref.reset_state({l: {k: jnp.asarray(v) for k, v in st.items()} for l, st in stacked.items()},
                           jnp.asarray(mask))
    got = port.reset_state({l: {k: torch.from_numpy(v) for k, v in st.items()} for l, st in stacked.items()},
                           torch.from_numpy(mask))
    for lname, st in want.items():
        for k, v in st.items():
            np.testing.assert_array_equal(got[lname][k].numpy(), np.asarray(v))
    with pytest.raises(MetricsUserError, match="1-D boolean"):
        port.reset_state(port.init_state(), torch.tensor([1, 0]))


def test_collection_reset_state_matches_jax():
    ref = M.MetricCollection([M.Accuracy(num_classes=4), M.Precision(num_classes=4), M.MeanSquaredError()])
    port = mt.MetricCollection([mt.Accuracy(num_classes=4, device="cpu"), mt.Precision(num_classes=4, device="cpu"),
                                mt.MeanSquaredError(device="cpu")])
    assert set(port.compute_groups) == set(ref.compute_groups)
    probs, labels = PROBS.argmax(1), LABELS
    ref_states = ref.update_state(ref.init_state(), jnp.asarray(probs), jnp.asarray(labels))
    port_states = port.update_state(port.init_state(), torch.from_numpy(probs), torch.from_numpy(labels))
    got, want = port.reset_state(port_states), ref.reset_state(ref_states)
    assert set(got) == set(want)
    for leader in want:
        _assert_same_reset(got[leader], want[leader], leader)
