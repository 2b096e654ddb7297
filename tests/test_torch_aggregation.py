"""The aggregators of the port against the JAX package:
``metrics_tpu_torch/aggregation.py`` SumMetric, MeanMetric, MaxMetric,
MinMetric and CatMetric, under every NaN strategy.

Eager, the strategy raises, warns or drops where the JAX package's
``_is_concrete`` holds; compiled (a captured step, or on the CPU the same
step with the value checks off) it only masks. So a buffered CatMetric keeps
a NaN row as the imputed 0.0 when compiled and drops it eager, in both
packages. Maxima, minima, counts and copied rows are compared bit for bit;
float32 sums within 1e-6 (``tests/helpers/torch_parity.py``).
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt_jax
import metrics_tpu_torch as mt_torch
from tests.helpers import torch_parity as hp
from tests.helpers.torch_port import assert_bitwise, assert_close

AGGREGATORS = ("SumMetric", "MeanMetric", "MaxMetric", "MinMetric", "CatMetric")
STRATEGIES = ("error", "warn", "ignore", 2.5)
EAGER = dict(compiled_update=False, compiled_compute=False)


@pytest.fixture(autouse=True)
def _engines_at_defaults():
    for pkg in (mt_jax, mt_torch):
        pkg.set_compiled_update(None)
        pkg.set_compiled_compute(None)
    yield


def _batches(nan_at=None, n=5, width=4, seed=0):
    rng = np.random.default_rng(seed)
    out = [rng.normal(size=width).astype(np.float32) for _ in range(n)]
    if nan_at is not None:
        out[nan_at][1] = np.nan
    return out


def _feed(metric, batches, to, weights=None):
    """Update once per batch; the warnings each update raised."""
    seen = []
    for i, b in enumerate(batches):
        args = (to(b),) if weights is None else (to(b), to(weights[i]))
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            metric.update(*args)
        seen.append(sorted({str(w.message) for w in rec if "nan" in str(w.message)}))
    return seen


def _jax(x):
    return jnp.asarray(x)


def _torch(x):
    return torch.from_numpy(np.array(x, copy=True))


def _same(name, got, want):
    if name in hp.BITWISE_RESULTS:
        assert_bitwise(got, np.asarray(want), name)
    else:
        assert_close(got.numpy().astype(np.float64), np.asarray(want).astype(np.float64),
                     rtol=hp.RTOL, atol=hp.ATOL, msg=name)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name", AGGREGATORS)
def test_nan_strategy_eager(name, strategy):
    batches = _batches(nan_at=2)
    ref = getattr(mt_jax, name)(nan_strategy=strategy, **EAGER)
    port = getattr(mt_torch, name)(nan_strategy=strategy, device="cpu", **EAGER)
    if strategy == "error":
        with pytest.raises(RuntimeError, match="nan"):
            _feed(ref, batches, _jax)
        with pytest.raises(RuntimeError, match="nan"):
            _feed(port, batches, _torch)
        return
    want_warned, got_warned = _feed(ref, batches, _jax), _feed(port, batches, _torch)
    assert got_warned == want_warned
    assert bool(got_warned[2]) == (strategy == "warn")
    hp.assert_same_states(ref, port, name)
    _same(name, port.compute(), ref.compute())


@pytest.mark.parametrize("name", AGGREGATORS)
def test_scalars_zero_d_tensors_and_empty_batches(name):
    ref, port = getattr(mt_jax, name)(**EAGER), getattr(mt_torch, name)(device="cpu", **EAGER)
    for value in (1.5, np.float32(-2.0), np.zeros((0,), np.float32), np.array([3.0, 0.25], np.float32)):
        ref.update(value if isinstance(value, float) else jnp.asarray(value))
        port.update(value if isinstance(value, float) else _torch(value))
    hp.assert_same_states(ref, port, name)
    _same(name, port.compute(), ref.compute())


@pytest.mark.parametrize("strategy", ("warn", "ignore", 0.5))
def test_weighted_mean_with_nan_values_and_weights(strategy):
    values = _batches(nan_at=1, seed=1)
    weights = [np.abs(np.random.default_rng(k).normal(size=4)).astype(np.float32) for k in range(5)]
    weights[3][0] = np.nan
    ref = mt_jax.MeanMetric(nan_strategy=strategy, **EAGER)
    port = mt_torch.MeanMetric(nan_strategy=strategy, device="cpu", **EAGER)
    assert _feed(port, values, _torch, weights) == _feed(ref, values, _jax, weights)
    hp.assert_same_states(ref, port, "MeanMetric")
    _same("MeanMetric", port.compute(), ref.compute())


@pytest.mark.parametrize("strategy", ("warn", "ignore", 4.0))
@pytest.mark.parametrize("name", ("MaxMetric", "MinMetric"))
def test_max_and_min_over_an_all_nan_batch(name, strategy):
    batches = [np.array([0.5, -1.0], np.float32), np.full(3, np.nan, np.float32), np.array([0.25], np.float32)]
    ref = getattr(mt_jax, name)(nan_strategy=strategy, **EAGER)
    port = getattr(mt_torch, name)(nan_strategy=strategy, device="cpu", **EAGER)
    _feed(ref, batches[:2], _jax)
    _feed(port, batches[:2], _torch)
    assert_bitwise(port.value, np.asarray(ref.value), name)  # the all-NaN batch moved it to -inf/inf or not
    _feed(ref, batches[2:], _jax)
    _feed(port, batches[2:], _torch)
    assert_bitwise(port.compute(), np.asarray(ref.compute()), name)


@pytest.mark.parametrize("name", AGGREGATORS)
def test_compiled_updates_mask_nan_without_warning(name):
    """At the engine defaults the NaN batch (the third call, a replay)
    is masked and nothing warns, in both packages."""
    kw = dict(buffer_capacity=64) if name == "CatMetric" else {}
    ref, port = getattr(mt_jax, name)(**kw), getattr(mt_torch, name)(device="cpu", **kw)
    batches = _batches(nan_at=2, seed=2)
    want_warned, got_warned = _feed(ref, batches, _jax), _feed(port, batches, _torch)
    assert got_warned == want_warned == [[]] * 5
    hp.same_partition(ref, port, name)
    assert hp.counters(port)["update"] == hp.counters(ref)["update"]
    hp.assert_same_states(ref, port, name)
    _same(name, port.compute(), ref.compute())


@pytest.mark.parametrize("compiled", (True, False))
@pytest.mark.parametrize("pkg", ("jax", "torch"))
def test_buffered_cat_metric_keeps_a_nan_row_compiled_and_drops_it_eager(pkg, compiled):
    """Five batches of 4, one NaN in the third: compiled, the buffered
    CatMetric computes 20 values with 0.0 where the NaN was; eager (and the
    list state, which never compiles) 19."""
    mod, to = (mt_jax, _jax) if pkg == "jax" else (mt_torch, _torch)
    kw = {} if pkg == "jax" else dict(device="cpu")
    buffered = mod.CatMetric(buffer_capacity=64, **kw, **({} if compiled else EAGER))
    listed = mod.CatMetric(**kw)
    batches = _batches(nan_at=2, seed=3)
    _feed(buffered, batches, to)
    _feed(listed, batches, to)
    got, in_list = np.asarray(buffered.compute()), np.asarray(listed.compute())
    clean = np.concatenate(batches)
    if compiled:
        assert got.shape == (20,) and got[9] == 0.0
        assert_bitwise(got, np.where(np.isnan(clean), np.float32(0.0), clean))
    else:
        assert_bitwise(got, clean[~np.isnan(clean)])
    assert_bitwise(in_list, clean[~np.isnan(clean)])


def test_both_packages_agree_on_the_buffered_nan_split():
    batches = _batches(nan_at=2, seed=3)
    for kw in ({}, EAGER):
        ref, port = mt_jax.CatMetric(buffer_capacity=64, **kw), mt_torch.CatMetric(buffer_capacity=64, device="cpu", **kw)
        _feed(ref, batches, _jax)
        _feed(port, batches, _torch)
        hp.assert_same_states(ref, port, "CatMetric")
        assert_bitwise(port.compute(), np.asarray(ref.compute()))


def test_bad_nan_strategy_raises_in_both():
    for mod, kw in ((mt_jax, {}), (mt_torch, dict(device="cpu"))):
        for name in AGGREGATORS:
            with pytest.raises(ValueError, match="nan_strategy"):
                getattr(mod, name)(nan_strategy="drop", **kw)


@pytest.mark.parametrize("name", ("SumMetric", "MaxMetric", "MeanMetric"))
def test_a_compiled_compute_hands_out_a_copy_of_its_state(name):
    """A compute that returns its state as it is gives the caller a copy, as
    a jit output is a fresh buffer: a held result keeps its value, and the
    next update still writes the state in place, as the JAX engine donates."""
    ref, port = getattr(mt_jax, name)(), getattr(mt_torch, name)(device="cpu")
    held = []
    for b in _batches(seed=4):
        ref.update(jnp.asarray(b))
        port.update(_torch(b))
        held.append((port.compute().clone(), port.compute()))
        ref.compute()
    for before, result in held:
        assert torch.equal(before, result)
    assert hp.counters(port) == hp.counters(ref)
    assert hp.counters(port)["update"]["donated_calls"] == 3
