"""The wrappers of the port (A11b) against the JAX package's.

Torch twins of ``tests/wrappers/test_wrappers.py`` and
``tests/wrappers/test_bootstrap_merge.py``: the same seeded numpy inputs go
through ``metrics_tpu.wrappers`` and ``metrics_tpu_torch.wrappers`` on the
CPU. BootStrapper draws its resample rows from ``np.random.default_rng(seed)``
with the JAX package's calls in its order, so over Accuracy (integer counts)
both packages agree bit for bit; over MeanSquaredError (float32 sums) within
1e-6. Results are held within 1e-6 unless they are integer ratios.
"""
from copy import deepcopy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as M
import metrics_tpu_torch as mt
from tests.helpers.torch_port import assert_bitwise, assert_close

pytestmark = pytest.mark.filterwarnings("ignore")

TOL = dict(rtol=1e-6, atol=1e-6)


def _rng(seed=21):
    return np.random.default_rng(seed)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return jnp.asarray(x)


def _close(got, want, **kw):
    assert_close(np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64), **{**TOL, **kw})


def _acc(**kw):
    return M.Accuracy(**kw), mt.Accuracy(device="cpu", **kw)


def _mse():
    return M.MeanSquaredError(), mt.MeanSquaredError(device="cpu")


# --------------------------------------------------------------------------- #
# BootStrapper
# --------------------------------------------------------------------------- #
def test_bootstrapper_mean_close_to_base():
    # the JAX package's case on the port alone (its parity: the bitwise cases below)
    rng = _rng()
    preds, target = rng.integers(0, 5, 200), rng.integers(0, 5, 200)
    port = mt.BootStrapper(mt.Accuracy(num_classes=5, device="cpu"), num_bootstraps=50, seed=0)
    port.update(_t(preds), _t(target))
    got = port.compute()
    assert set(got) == {"mean", "std"}
    assert abs(float(got["mean"]) - float((preds == target).mean())) < 0.05 and float(got["std"]) > 0


def test_bootstrapper_quantile_raw():
    rng = _rng()
    p, t = rng.random(64), rng.random(64)
    ref = M.BootStrapper(M.MeanSquaredError(), num_bootstraps=10, quantile=0.5, raw=True, seed=1)
    port = mt.BootStrapper(mt.MeanSquaredError(device="cpu"), num_bootstraps=10, quantile=0.5, raw=True, seed=1)
    ref.update(_j(p.astype(np.float32)), _j(t.astype(np.float32)))
    port.update(_t(p.astype(np.float32)), _t(t.astype(np.float32)))
    got, want = port.compute(), ref.compute()
    assert got["raw"].shape == (10,) and set(got) == set(want)
    for key in want:
        _close(got[key], want[key])


def test_bootstrapper_rejects_non_metric():
    with pytest.raises(ValueError, match="base metric"):
        mt.BootStrapper(lambda x: x)


def _accuracy_bootstrap_calls():
    rng = _rng(7)
    return [(rng.dirichlet(np.ones(6), size=n).astype(np.float32), rng.integers(0, 6, n).astype(np.int32))
            for n in (40, 33, 1)]


@pytest.fixture(scope="module")
def jax_bootstraps():
    """The JAX BootStrapper updated over ``_accuracy_bootstrap_calls``, once
    per strategy for the module: the quantile is read only by the compute,
    so the three quantile cases of a strategy share its updates (the JAX
    package's per-length vmapped updates were most of their time); each
    case computes on its own copy with its quantile set."""
    out = {}
    for strategy in ("poisson", "multinomial"):
        ref = M.BootStrapper(M.Accuracy(num_classes=6), num_bootstraps=8, sampling_strategy=strategy, seed=13,
                             raw=True)
        for p, t in _accuracy_bootstrap_calls():
            ref.update(_j(p), _j(t))
        out[strategy] = ref
    return out


@pytest.mark.parametrize("strategy", ["poisson", "multinomial"])
@pytest.mark.parametrize("quantile", [None, 0.5, [0.025, 0.975]])
def test_bootstrapper_over_accuracy_is_bitwise(strategy, quantile, jax_bootstraps):
    """The same seed draws the same rows in both packages: every replica's
    integer counts agree bit for bit, and the statistics within 1e-6."""
    kw = dict(num_bootstraps=8, sampling_strategy=strategy, seed=13, raw=True)
    ref = deepcopy(jax_bootstraps[strategy])
    ref.quantile = None if quantile is None else jnp.asarray(quantile)
    port = mt.BootStrapper(mt.Accuracy(num_classes=6, device="cpu"), quantile=quantile, **kw)
    for p, t in _accuracy_bootstrap_calls():
        port.update(_t(p), _t(t))
    assert port._vmap_update is True
    for key in ref._defaults:
        assert_bitwise(getattr(port, key), np.asarray(getattr(ref, key)), key)
    got, want = port.compute(), ref.compute()
    assert set(got) == set(want)
    assert_bitwise(got["raw"], np.asarray(want["raw"]), "raw")
    for key in want:
        _close(got[key], want[key])


@pytest.mark.parametrize("strategy", ["poisson", "multinomial"])
def test_bootstrapper_over_mse_within_bound(strategy):
    rng = _rng(8)
    calls = [(rng.normal(size=n).astype(np.float32), rng.normal(size=n).astype(np.float32)) for n in (32, 17, 50)]
    kw = dict(num_bootstraps=6, sampling_strategy=strategy, seed=21, raw=True, quantile=jnp.asarray([0.1, 0.9]))
    ref = M.BootStrapper(M.MeanSquaredError(), **kw)
    port = mt.BootStrapper(mt.MeanSquaredError(device="cpu"), **{**kw, "quantile": [0.1, 0.9]})
    for p, t in calls:
        ref.update(_j(p), _j(t))
        port.update(_t(p), _t(t))
    assert_bitwise(port.total, np.asarray(ref.total), "total")  # integer counts
    _close(port.sum_squared_error, ref.sum_squared_error)
    got, want = port.compute(), ref.compute()
    for key in want:
        _close(got[key], want[key])


def test_bootstrapper_empty_poisson_draws_skip_their_replica():
    """A batch of one row: about a third of the poisson draws are empty, and
    those replicas keep their state, in both packages."""
    kw = dict(num_bootstraps=12, seed=4, raw=True)
    ref, port = M.BootStrapper(M.MeanSquaredError(), **kw), mt.BootStrapper(mt.MeanSquaredError(device="cpu"), **kw)
    rng = _rng(9)
    for _ in range(3):
        p, t = rng.random(1).astype(np.float32), rng.random(1).astype(np.float32)
        ref.update(_j(p), _j(t))
        port.update(_t(p), _t(t))
    counts = port.total.numpy()
    assert (counts < 3).any()  # some replica skipped a draw
    assert_bitwise(port.total, np.asarray(ref.total), "total")
    _close(port.sum_squared_error, ref.sum_squared_error)


def test_bootstrapper_forward_accumulates():
    """forward() keeps the stacked state it had before the batch value."""
    kw = dict(num_bootstraps=8, seed=0, sampling_strategy="multinomial")
    ref, port = M.BootStrapper(M.MeanSquaredError(), **kw), mt.BootStrapper(mt.MeanSquaredError(device="cpu"), **kw)
    for shift in (1.0, 0.0):
        ref(jnp.zeros(16) + shift, jnp.zeros(16))
        port(torch.zeros(16) + shift, torch.zeros(16))
    got, want = port.compute(), ref.compute()
    assert float(got["mean"]) == pytest.approx(0.5, abs=0.25)
    _close(got["mean"], want["mean"])


def test_bootstrapper_stacked_path_active():
    bs = mt.BootStrapper(mt.MeanSquaredError(device="cpu"), num_bootstraps=6, seed=0)
    assert bs._vmapped and bs.metrics == []
    assert all(getattr(bs, k).shape[0] == 6 for k in bs._defaults)
    x = _t(np.random.default_rng(0).normal(size=(32,)).astype(np.float32))
    bs.update(x, x + 0.1)
    out = bs.compute()
    assert np.isfinite(float(out["mean"])) and np.isfinite(float(out["std"]))


@pytest.mark.parametrize("strategy", ["poisson", "multinomial"])
def test_bootstrapper_stacked_matches_copies_design(strategy):
    """Same seed: the stacked path reproduces the copies path, as in the JAX package."""
    rng = np.random.default_rng(5)
    batches = [(rng.normal(size=(16,)).astype(np.float32), rng.normal(size=(16,)).astype(np.float32)) for _ in range(3)]
    kw = dict(num_bootstraps=8, sampling_strategy=strategy, seed=11, raw=True)
    bs = mt.BootStrapper(mt.MeanSquaredError(device="cpu"), **kw)
    bs_ref = mt.BootStrapper(mt.MeanSquaredError(device="cpu"), **kw)
    bs_ref._vmapped = False
    bs_ref.metrics = [mt.MeanSquaredError(device="cpu") for _ in range(8)]
    jax_ref = M.BootStrapper(M.MeanSquaredError(), **kw)
    for x, y in batches:
        bs.update(_t(x), _t(y))
        bs_ref.update(_t(x), _t(y))
        jax_ref.update(_j(x), _j(y))
    got, want = bs.compute(), bs_ref.compute()
    _close(got["raw"], want["raw"])
    _close(got["raw"], jax_ref.compute()["raw"])


def test_bootstrapper_is_never_captured():
    """The update draws fresh indices on the host at every call: the engines
    leave it eager and capture nothing, as the JAX engine does."""
    bs = mt.BootStrapper(mt.MeanSquaredError(device="cpu"), num_bootstraps=4, seed=0)
    assert bs.supports_compiled_update is False
    x = torch.linspace(0, 1, 8)
    for _ in range(4):
        bs.update(x, x * 0.5)
    view = bs.engine_stats()["partition"]
    ref = M.BootStrapper(M.MeanSquaredError(), num_bootstraps=4, seed=0)
    assert view["update"] == ref.engine_stats()["partition"]["update"]
    assert view["update"]["path"] == "eager"
    stats = bs.engine_stats()["update"]
    assert stats is None or (stats.cache_misses == 0 and stats.cache_hits == 0)


def test_bootstrapper_inherits_base_state():
    base = mt.MeanSquaredError(device="cpu")
    base.update(torch.ones(4), torch.zeros(4))
    bs = mt.BootStrapper(base, num_bootstraps=3, seed=0, mean=True, std=False)
    assert bs._vmapped
    np.testing.assert_allclose(float(bs.compute()["mean"]), 1.0)


class _ReadsBack(mt.Metric):
    """A base whose update reads a value back: vmap refuses it."""

    full_state_update = False

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, x):
        if float(x.max()) > 1e9:
            raise ValueError("too large")
        self.total = self.total + x.sum()

    def compute(self):
        return self.total


def test_bootstrapper_loops_the_replicas_where_vmap_refuses():
    """Same rows and the same stacked state through the per-replica loop."""
    x = _t(np.arange(10, dtype=np.float32))
    looped = mt.BootStrapper(_ReadsBack(device="cpu"), num_bootstraps=5, seed=3, raw=True)
    looped.update(x)
    assert looped._vmap_update is False and looped.total.shape == (5,)
    stacked = mt.BootStrapper(mt.SumMetric(device="cpu"), num_bootstraps=5, seed=3, raw=True)
    stacked.update(x)
    assert stacked._vmap_update is True
    assert_bitwise(looped.compute()["raw"], stacked.compute()["raw"].numpy())


def test_bootstrapper_copies_path_for_list_states():
    """A base with an unbounded list state takes the copies path in both packages."""
    rng = _rng(12)
    p, t = rng.random(20).astype(np.float32), rng.random(20).astype(np.float32)
    kw = dict(num_bootstraps=3, seed=7, raw=True)
    ref = M.BootStrapper(M.SpearmanCorrCoef(), **kw)
    port = mt.BootStrapper(mt.SpearmanCorrCoef(device="cpu"), **kw)
    assert not port._vmapped and not ref._vmapped and len(port.metrics) == 3
    ref.update(_j(p), _j(t))
    port.update(_t(p), _t(t))
    _close(port.compute()["raw"], ref.compute()["raw"])


# --------------------------------------------------------------------------- #
# ClasswiseWrapper
# --------------------------------------------------------------------------- #
def test_classwise_wrapper_keys_and_values():
    rng = _rng()
    preds, target = rng.random((10, 3)).astype(np.float32), rng.integers(0, 3, 10)
    labels = ["horse", "fish", "dog"]
    ref = M.ClasswiseWrapper(M.Accuracy(num_classes=3, average="none"), labels=labels)
    port = mt.ClasswiseWrapper(mt.Accuracy(num_classes=3, average="none", device="cpu"), labels=labels)
    got, want = port(_t(preds), _t(target)), ref(_j(preds), _j(target))
    assert list(got) == list(want) == ["accuracy_horse", "accuracy_fish", "accuracy_dog"]
    for key in want:
        assert_bitwise(got[key], np.asarray(want[key]), key)


def test_classwise_in_collection_flattens():
    rng = _rng()
    preds, target = rng.random((10, 3)).astype(np.float32), rng.integers(0, 3, 10)
    col = mt.MetricCollection({"acc": mt.ClasswiseWrapper(mt.Accuracy(num_classes=3, average="none", device="cpu"))})
    ref = M.MetricCollection({"acc": M.ClasswiseWrapper(M.Accuracy(num_classes=3, average="none"))})
    col.update(_t(preds), _t(target))
    ref.update(_j(preds), _j(target))
    got, want = col.compute(), ref.compute()
    assert set(got) == set(want) == {"accuracy_0", "accuracy_1", "accuracy_2"}
    for key in want:
        assert_bitwise(got[key], np.asarray(want[key]), key)


def test_classwise_forward_invalidates_cache():
    port = mt.ClasswiseWrapper(mt.Accuracy(num_classes=3, average=None, device="cpu"))
    port.update(torch.tensor([[0.8, 0.1, 0.1], [0.1, 0.8, 0.1]]), torch.tensor([0, 1]))
    first = port.compute()
    port(torch.tensor([[0.8, 0.1, 0.1]]), torch.tensor([1]))
    second = port.compute()
    assert float(second["accuracy_1"]) == pytest.approx(0.5)
    assert float(first["accuracy_1"]) == pytest.approx(1.0)


def test_classwise_rejects_bad_arguments():
    with pytest.raises(ValueError, match="metric"):
        mt.ClasswiseWrapper(lambda x: x)
    with pytest.raises(ValueError, match="labels"):
        mt.ClasswiseWrapper(mt.Accuracy(device="cpu"), labels=[1, 2])


# --------------------------------------------------------------------------- #
# MinMaxMetric
# --------------------------------------------------------------------------- #
def test_minmax_tracks():
    ref, port = M.MinMaxMetric(M.MeanSquaredError()), mt.MinMaxMetric(mt.MeanSquaredError(device="cpu"))
    t = np.asarray([1.0, 2.0, 3.0], np.float32)
    got, want = port(_t(t + 0.5), _t(t)), ref(_j(t + 0.5), _j(t))
    assert float(got["min"]) == float(got["max"]) == float(got["raw"]) == pytest.approx(0.25)
    for key in want:
        _close(got[key], want[key])
    ref.update(_j(t + 1.0), _j(t))
    port.update(_t(t + 1.0), _t(t))
    got, want = port.compute(), ref.compute()
    assert float(got["max"]) > 0.25 and float(got["min"]) == pytest.approx(0.25)
    for key in want:
        _close(got[key], want[key])


def test_minmax_forward_accumulates():
    """forward() keeps the base metric's state (the snapshot reaches the child)."""
    port, ref = mt.MinMaxMetric(mt.MeanSquaredError(device="cpu")), M.MinMaxMetric(M.MeanSquaredError())
    for shift in (1.0, 0.0):
        port(torch.zeros(4) + shift, torch.zeros(4))
        ref(jnp.zeros(4) + shift, jnp.zeros(4))
    got, want = port.compute(), ref.compute()
    assert float(got["raw"]) == pytest.approx(0.5, abs=1e-6)
    for key in want:
        _close(got[key], want[key])


def test_minmax_tracking_across_computes():
    port, ref = mt.MinMaxMetric(mt.MeanSquaredError(device="cpu")), M.MinMaxMetric(M.MeanSquaredError())
    rng = _rng(51)
    for _ in range(4):
        p, t = rng.random(16).astype(np.float32), rng.random(16).astype(np.float32)
        port.update(_t(p), _t(t))
        ref.update(_j(p), _j(t))
        got, want = port.compute(), ref.compute()
        for key in ("raw", "min", "max"):
            _close(got[key], want[key])
    assert port.min_val.dtype == torch.float32 and port._reductions == {"min_val": "min", "max_val": "max"}


def test_minmax_rejects_non_scalar_base_values():
    port = mt.MinMaxMetric(mt.Accuracy(num_classes=3, average="none", device="cpu"))
    port.update(torch.tensor([0, 1, 2]), torch.tensor([0, 1, 1]))
    with pytest.raises(RuntimeError, match="float or scalar tensor"):
        port.compute()
    with pytest.raises(ValueError, match="base metric"):
        mt.MinMaxMetric(3)


# --------------------------------------------------------------------------- #
# MultioutputWrapper
# --------------------------------------------------------------------------- #
def _multi_pair(**kw):
    return M.MultioutputWrapper(M.MeanSquaredError(), num_outputs=2, **kw), \
        mt.MultioutputWrapper(mt.MeanSquaredError(device="cpu"), num_outputs=2, **kw)


def _feed(pair, *arrays):
    ref, port = pair
    ref.update(*map(_j, arrays))
    port.update(*map(_t, arrays))
    return port.compute(), ref.compute()


def test_multioutput_wrapper():
    rng = _rng()
    preds, target = rng.random((16, 2)).astype(np.float32), rng.random((16, 2)).astype(np.float32)
    got, want = _feed(_multi_pair(), preds, target)
    _close(got, want)
    _close(got, [np.mean((preds[:, i] - target[:, i]) ** 2) for i in range(2)])


def test_multioutput_removes_nan_rows():
    preds = np.asarray([[1.0, 1.0], [np.nan, 2.0], [3.0, 3.0]], dtype=np.float32)
    target = np.asarray([[1.0, 2.0], [2.0, 2.0], [3.0, 4.0]], dtype=np.float32)
    pair = _multi_pair()
    got, want = _feed(pair, preds, target)
    _close(got, want)
    assert float(got[0]) == 0.0
    for ref_child, port_child in zip(pair[0].metrics, pair[1].metrics):
        for key in ref_child._defaults:
            assert_bitwise(getattr(port_child, key), np.asarray(getattr(ref_child, key)), key)


def test_multioutput_remove_nans_per_output():
    from sklearn.metrics import mean_squared_error as sk_mse

    preds = np.asarray([[1.0, 10.0], [2.0, np.nan], [3.0, 30.0], [4.0, 40.0]], np.float32)
    target = np.asarray([[1.5, 11.0], [2.5, 21.0], [np.nan, 29.0], [4.0, 40.0]], np.float32)
    got, want = _feed(_multi_pair(), preds, target)
    _close(got, want)
    keep0 = ~np.isnan(preds[:, 0]) & ~np.isnan(target[:, 0])
    keep1 = ~np.isnan(preds[:, 1]) & ~np.isnan(target[:, 1])
    _close(got, [sk_mse(target[keep0, 0], preds[keep0, 0]), sk_mse(target[keep1, 1], preds[keep1, 1])])


def test_multioutput_remove_nans_disabled_propagates():
    preds = np.asarray([[1.0, 10.0], [2.0, np.nan]], np.float32)
    target = np.asarray([[1.0, 10.0], [2.0, 20.0]], np.float32)
    got, want = _feed(_multi_pair(remove_nans=False), preds, target)
    assert float(got[0]) == 0.0 and np.isnan(float(got[1])) and np.isnan(float(want[1]))


def test_multioutput_output_dim():
    preds = np.asarray([[1.0, 2.0, 3.0], [10.0, 20.0, 30.0]], np.float32)
    target = np.asarray([[1.0, 2.0, 4.0], [10.0, 22.0, 30.0]], np.float32)
    got, want = _feed(_multi_pair(output_dim=0), preds, target)
    _close(got, want)
    _close(got, [((preds[i] - target[i]) ** 2).mean() for i in range(2)])


def test_multioutput_squeeze_outputs_disabled_keeps_dim():
    rng = np.random.default_rng(5)
    preds, target = rng.random((8, 2)).astype(np.float32), rng.random((8, 2)).astype(np.float32)
    a, _ = _feed(_multi_pair(), preds, target)
    b, want = _feed(_multi_pair(squeeze_outputs=False), preds, target)
    _close(a, b)
    _close(b, want)


def test_multioutput_forward_returns_stacked_batch_values():
    preds = np.asarray([[1.0, 10.0], [2.0, 20.0]], np.float32)
    target = np.asarray([[1.0, 11.0], [2.0, 21.0]], np.float32)
    ref, port = _multi_pair()
    got, want = port(_t(preds), _t(target)), ref(_j(preds), _j(target))
    _close(got, want)
    _close(got, [0.0, 1.0])


def test_multioutput_forward_invalidates_cache():
    ref, port = _multi_pair()
    p = np.asarray([[1.0, 2.0]], np.float32)
    port.update(_t(p), _t(p))
    assert np.allclose(port.compute().numpy(), [0.0, 0.0])
    port(_t(p + 1.0), _t(p))
    _close(port.compute(), [0.5, 0.5])


def test_multioutput_reads_back_once_per_output():
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func._overloadpacket in (torch.ops.aten.nonzero, torch.ops.aten._local_scalar_dense):
                seen.append(func)
            return func(*args, **(kwargs or {}))

    port = mt.MultioutputWrapper(mt.MeanSquaredError(device="cpu", compiled_update=False), num_outputs=3)
    x = torch.rand(32, 3)
    with Count():
        port.update(x, x)
    assert len(seen) == 3


# --------------------------------------------------------------------------- #
# MetricTracker
# --------------------------------------------------------------------------- #
def test_tracker():
    ref, port = M.MetricTracker(M.MeanSquaredError(), maximize=False), \
        mt.MetricTracker(mt.MeanSquaredError(device="cpu"), maximize=False)
    t = _rng().random(32).astype(np.float32)
    for shift in [0.5, 0.1, 0.3]:
        ref.increment()
        port.increment()
        ref.update(_j(t + shift), _j(t))
        port.update(_t(t + shift), _t(t))
    _close(port.compute_all(), ref.compute_all())
    assert port.compute_all().shape == (3,) and port.n_steps == 3
    got, want = port.best_metric(return_step=True), ref.best_metric(return_step=True)
    assert got[1] == want[1] == 1
    assert got[0] == pytest.approx(want[0], abs=1e-6) and got[0] == pytest.approx(0.01, abs=1e-5)


def test_tracker_requires_increment():
    tracker = mt.MetricTracker(mt.MeanSquaredError(device="cpu"))
    with pytest.raises(ValueError, match="increment"):
        tracker.update(torch.tensor([1.0]), torch.tensor([1.0]))


def test_tracker_with_collection():
    port = mt.MetricTracker(mt.MetricCollection({"mse": mt.MeanSquaredError(device="cpu")}), maximize=[False])
    port.increment()
    port.update(torch.tensor([1.0, 2.0]), torch.tensor([1.0, 2.0]))
    assert "mse" in port.compute_all()
    assert port.best_metric()["mse"] == pytest.approx(0.0)


def test_tracker_rejects_bad_maximize():
    with pytest.raises(ValueError, match="MetricCollection"):
        mt.MetricTracker(mt.MeanSquaredError(device="cpu"), maximize=[False])
    with pytest.raises(ValueError, match="single bool or list"):
        mt.MetricTracker(mt.MeanSquaredError(device="cpu"), maximize="yes")
    with pytest.raises(TypeError, match="Metric"):
        mt.MetricTracker(3)


def test_tracker_mixed_maximize_directions():
    t = _rng().random(32).astype(np.float32)
    ref = M.MetricTracker(M.MetricCollection({"mse": M.MeanSquaredError(), "mae": M.MeanAbsoluteError()}),
                          maximize=[True, False])
    port = mt.MetricTracker(mt.MetricCollection({"mse": mt.MeanSquaredError(device="cpu"),
                                                 "mae": mt.MeanAbsoluteError(device="cpu")}), maximize=[True, False])
    for shift in [0.5, 0.1, 0.3]:
        for tr, conv in ((ref, _j), (port, _t)):
            tr.increment()
            tr.update(conv(t + shift), conv(t))
    (gv, gs), (wv, ws) = port.best_metric(return_step=True), ref.best_metric(return_step=True)
    assert gs == ws and gs["mse"] == 1 and gs["mae"] == 0
    for key in wv:
        assert gv[key] == pytest.approx(wv[key], abs=1e-6)


def test_tracker_all_nan_returns_none():
    port = mt.MetricTracker(mt.MeanSquaredError(device="cpu"))
    port.increment()
    port.update(torch.tensor([float("nan")]), torch.tensor([1.0]))
    assert port.best_metric(return_step=True) == (None, None)


# --------------------------------------------------------------------------- #
# test_bootstrap_merge.py: the stacked states merge as sync would
# --------------------------------------------------------------------------- #
def _states(metric):
    return {name: getattr(metric, name) for name in metric._defaults}


def _workers(make, seeds, calls, conv):
    a, b = make(seeds[0]), make(seeds[1])
    for i, args in enumerate(calls):
        (a if i < len(calls) // 2 else b).update(*map(conv, args))
    return a, b


def test_bootstrap_merge_matches_single_worker_accuracy():
    rng = np.random.default_rng(0)
    preds = rng.integers(0, 5, size=(4, 64)).astype(np.int32)
    target = np.where(rng.uniform(size=(4, 64)) < 0.7, preds, rng.integers(0, 5, size=(4, 64))).astype(np.int32)
    pa, pb = _workers(lambda s: mt.BootStrapper(mt.Accuracy(num_classes=5, device="cpu"), num_bootstraps=32, seed=s),
                      (1, 2), list(zip(preds, target)), _t)
    out = pa.compute_state(pa.merge_states(_states(pa), _states(pb)))
    assert out["mean"] == pytest.approx(float((preds == target).mean()), abs=0.05)
    assert 0.0 < float(out["std"]) < 0.1


def test_bootstrap_merge_is_commutative():
    rng = np.random.default_rng(3)
    preds = rng.normal(size=(4, 32)).astype(np.float32)
    target = preds + 0.1 * rng.normal(size=(4, 32)).astype(np.float32)
    pa, pb = _workers(lambda s: mt.BootStrapper(mt.MeanSquaredError(device="cpu"), num_bootstraps=16, seed=s),
                      (5, 6), list(zip(preds, target)), _t)
    ab = pa.compute_state(pa.merge_states(_states(pa), _states(pb)))
    ba = pa.compute_state(pa.merge_states(_states(pb), _states(pa)))
    np.testing.assert_allclose(float(ab["mean"]), float(ba["mean"]), rtol=1e-6)
    np.testing.assert_allclose(float(ab["std"]), float(ba["std"]), rtol=1e-5)


@pytest.mark.parametrize("strategy", ["poisson", "multinomial"])
def test_bootstrap_merged_states_match_jax(strategy):
    rng = np.random.default_rng(0)
    preds = rng.integers(0, 5, size=(4, 24)).astype(np.int32)
    target = np.where(rng.uniform(size=(4, 24)) < 0.7, preds, rng.integers(0, 5, size=(4, 24))).astype(np.int32)
    kw = dict(num_bootstraps=6, sampling_strategy=strategy)
    ja, jb = _workers(lambda s: M.BootStrapper(M.Accuracy(num_classes=5), seed=s, **kw), (1, 2),
                      list(zip(preds, target)), _j)
    pa, pb = _workers(lambda s: mt.BootStrapper(mt.Accuracy(num_classes=5, device="cpu"), seed=s, **kw), (1, 2),
                      list(zip(preds, target)), _t)
    merged, want = pa.merge_states(_states(pa), _states(pb)), ja.merge_states(_states(ja), _states(jb))
    for key in want:
        assert_bitwise(merged[key], np.asarray(want[key]), key)
    got, want_out = pa.compute_state(merged), ja.compute_state(want)
    for key in want_out:
        _close(got[key], want_out[key])


def test_wrappers_live_on_their_base_metrics_device():
    base = mt.MeanSquaredError(device="cpu")
    for wrapper in (mt.BootStrapper(base, num_bootstraps=2), mt.MinMaxMetric(base),
                    mt.MultioutputWrapper(base, num_outputs=2), mt.ClasswiseWrapper(mt.Accuracy(device="cpu"))):
        assert wrapper.device == torch.device("cpu")
    assert deepcopy(mt.BootStrapper(base, num_bootstraps=2, seed=1))._rng is not None
