"""The regression slice of the port against the JAX package:
``metrics_tpu_torch/ops/regression/`` and ``metrics_tpu_torch/regression/``.

The same seeded numpy inputs go to both packages: every functional (MSE with
``squared`` and ``num_outputs``, MAE, MSLE, MAPE, SMAPE, WMAPE, cosine
similarity under every reduction, Tweedie deviance on each ``power`` branch
and its domain errors, Pearson, Spearman on ties and signed zeros, R2 under
every ``multioutput`` and ``adjusted``, explained variance), every class
over several updates, and Pearson's ``_final_aggregation`` of hand-stacked
per-rank moments. Results and float32 states are held within 1e-5, the JAX
package's own bound for these metrics (``tests/regression/test_regression.py:67``),
and within rtol 1e-4 where it states that one (Tweedie, ``:103``; R2 and
explained variance, ``tests/regression/test_reference_differentials.py:60,69``);
integer states and copied rows bit for bit.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt_jax
import metrics_tpu.ops as ops_jax
import metrics_tpu_torch as mt_torch
import metrics_tpu_torch.ops as ops_torch
from metrics_tpu.regression.moments import _final_aggregation as jax_final_aggregation
from metrics_tpu_torch.ops.regression.moments import _pearson_corrcoef_update, _r2_score_compute
from metrics_tpu_torch.ops.regression.other import _tweedie_deviance_score_update
from metrics_tpu_torch.regression.moments import _final_aggregation
from metrics_tpu_torch.utils.checks import _checks_off
from tests.helpers.torch_port import assert_bitwise, assert_close

N, BATCHES = 40, 3
BOUND = 1e-5
LOOSE = 1e-4  # rtol of the JAX package for Tweedie, R2 and explained variance

pytestmark = pytest.mark.filterwarnings("ignore")


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(np.array(a, copy=True)) for a in arrays]


def _close(got, want, rtol=BOUND, atol=BOUND):
    want = np.asarray(want)
    assert got.dtype == torch.float32 and want.dtype == np.float32, (got.dtype, want.dtype)
    assert tuple(got.shape) == want.shape, (tuple(got.shape), want.shape)
    assert_close(got.numpy().astype(np.float64), want.astype(np.float64), rtol=rtol, atol=atol)


def _data(seed, shape=(N,), positive=True):
    rng = np.random.default_rng(seed)
    preds = rng.random(shape).astype(np.float32)
    target = rng.random(shape).astype(np.float32)
    if positive:
        preds, target = preds + 0.1, target + 0.1
    else:
        preds, target = preds * 4 - 2, target * 4 - 2
    return preds, target


BASIC = ("mean_squared_error", "mean_absolute_error", "mean_squared_log_error", "mean_absolute_percentage_error",
         "symmetric_mean_absolute_percentage_error", "weighted_mean_absolute_percentage_error")


@pytest.mark.parametrize("shape", [(N,), (N, 3)])
@pytest.mark.parametrize("name", BASIC)
def test_basic_functionals(name, shape):
    ja, ta = _both(*_data(1, shape))
    _close(getattr(ops_torch, name)(*ta), getattr(ops_jax, name)(*ja))


@pytest.mark.parametrize("squared", (True, False))
@pytest.mark.parametrize("num_outputs", (1, 3))
def test_mean_squared_error_options(squared, num_outputs):
    ja, ta = _both(*_data(2, (N, 3), positive=False))
    want = ops_jax.mean_squared_error(*ja, squared=squared, num_outputs=num_outputs)
    _close(ops_torch.mean_squared_error(*ta, squared=squared, num_outputs=num_outputs), want)


def test_mape_clips_zero_targets_and_shapes_must_match():
    preds, target = _data(3)
    target[:5] = 0.0
    ja, ta = _both(preds, target)
    _close(ops_torch.mean_absolute_percentage_error(*ta), ops_jax.mean_absolute_percentage_error(*ja), rtol=BOUND, atol=0)
    with pytest.raises(RuntimeError, match="same shape"):
        ops_torch.mean_absolute_error(ta[0], ta[1][:-1])


@pytest.mark.parametrize("reduction", ("sum", "mean", "none", None))
def test_cosine_similarity(reduction):
    ja, ta = _both(*_data(4, (N, 7), positive=False))
    _close(ops_torch.cosine_similarity(*ta, reduction=reduction), ops_jax.cosine_similarity(*ja, reduction=reduction))


TWEEDIE_POWERS = (0.0, 1.0, 2.0, 3.0, 1.5, -1.0)


@pytest.mark.parametrize("power", TWEEDIE_POWERS)
def test_tweedie_each_branch(power):
    ja, ta = _both(*_data(5))
    want = ops_jax.tweedie_deviance_score(*ja, power=power)
    _close(ops_torch.tweedie_deviance_score(*ta, power=power), want, rtol=LOOSE)


# (power, preds, target) that leave the branch's domain, with the JAX package's message
TWEEDIE_ERRORS = [
    (0.5, 1.0, 1.0, "not defined for power=0.5"),
    (1.0, 0.0, 1.0, "'preds' has to be strictly positive and 'targets' cannot be negative"),
    (1.0, 1.0, -1.0, "'preds' has to be strictly positive and 'targets' cannot be negative"),
    (2.0, 1.0, 0.0, "both 'preds' and 'targets' have to be strictly positive"),
    (-1.0, 0.0, 1.0, "'preds' has to be strictly positive"),
    (1.5, 1.0, -1.0, "'targets' has to be strictly positive and 'preds' cannot be negative"),
    (3.0, 1.0, 0.0, "both 'preds' and 'targets' have to be strictly positive"),
]


@pytest.mark.parametrize("power,bad_pred,bad_target,message", TWEEDIE_ERRORS)
def test_tweedie_domain_errors_are_eager_only(power, bad_pred, bad_target, message):
    preds, target = _data(6)
    preds[3], target[3] = bad_pred, bad_target
    ja, ta = _both(preds, target)
    with pytest.raises(ValueError, match=message):
        ops_jax.tweedie_deviance_score(*ja, power=power)
    with pytest.raises(ValueError, match=message):
        ops_torch.tweedie_deviance_score(*ta, power=power)
    if 0 < power < 1:
        return  # the power itself is refused, captured or not
    with _checks_off():  # a captured step reads nothing back, as a JAX trace checks nothing
        total, count = _tweedie_deviance_score_update(*ta, power=power)
    assert total.shape == () and count == N


def test_tweedie_class_refuses_a_power_between_zero_and_one():
    for mt in (mt_jax, mt_torch):
        kw = {} if mt is mt_jax else {"device": "cpu"}
        with pytest.raises(ValueError, match="not defined"):
            mt.TweedieDevianceScore(power=0.3, **kw)


def test_pearson_and_spearman_functionals():
    ja, ta = _both(*_data(7, positive=False))
    _close(ops_torch.pearson_corrcoef(*ta), ops_jax.pearson_corrcoef(*ja))
    _close(ops_torch.spearman_corrcoef(*ta), ops_jax.spearman_corrcoef(*ja))


def test_spearman_with_ties_and_signed_zeros():
    """Scores on a coarse grid tie heavily; -0.0 and +0.0 tie too (the JAX
    package's sort and searchsorted compare them equal): the mean-tie ranks
    agree bit for bit."""
    rng = np.random.default_rng(8)
    preds = np.round(rng.normal(size=N) * 2).astype(np.float32) / 2
    target = np.round(rng.normal(size=N)).astype(np.float32)
    preds[:6] = [0.0, -0.0, 0.0, -0.0, 1.0, -1.0]
    target[:4] = [-0.0, 0.0, 0.0, -0.0]
    ja, ta = _both(preds, target)
    from metrics_tpu.ops.regression.moments import _rank_data as jax_rank
    from metrics_tpu_torch.ops.regression.moments import _rank_data as torch_rank

    for j, t in zip(ja, ta):
        assert_bitwise(torch_rank(t), jax_rank(j), "mean-tie ranks")
    _close(ops_torch.spearman_corrcoef(*ta), ops_jax.spearman_corrcoef(*ja))


def test_spearman_refuses_mixed_dtypes_and_2d():
    p, t = torch.zeros(4), torch.zeros(4, dtype=torch.float64)
    with pytest.raises(TypeError, match="same data type"):
        ops_torch.spearman_corrcoef(p, t)
    with pytest.raises(ValueError, match="1 dimensional"):
        ops_torch.spearman_corrcoef(torch.zeros(4, 2), torch.zeros(4, 2))


@pytest.mark.parametrize("adjusted", (0, 3, 38, 39, 45))
@pytest.mark.parametrize("multioutput", ("raw_values", "uniform_average", "variance_weighted"))
def test_r2_score(multioutput, adjusted):
    """adjusted 38 corrects; 39 (= n - 1) and 45 (> n - 1) warn and fall back."""
    ja, ta = _both(*_data(9, (N, 3), positive=False))
    with warnings.catch_warnings(record=True) as rec_jax:
        warnings.simplefilter("always")
        want = ops_jax.r2_score(*ja, adjusted=adjusted, multioutput=multioutput)
    with warnings.catch_warnings(record=True) as rec_torch:
        warnings.simplefilter("always")
        got = ops_torch.r2_score(*ta, adjusted=adjusted, multioutput=multioutput)
    _close(got, want, rtol=LOOSE)
    assert [str(w.message) for w in rec_torch] == [str(w.message) for w in rec_jax]


@pytest.mark.parametrize("adjusted", (0, 3, 38, 39, 45))
def test_r2_adjusted_on_a_device_count_is_a_select(adjusted):
    """In a captured compute the count is a device tensor: the fallback is a
    select and gives the eager value, with nothing read back."""
    _, ta = _both(*_data(10, (N, 3), positive=False))
    sums = (torch.sum(ta[1] * ta[1], 0), torch.sum(ta[1], 0), torch.sum((ta[1] - ta[0]) ** 2, 0))
    n = torch.tensor(N, dtype=torch.int32)
    eager = _r2_score_compute(*sums, n, adjusted=adjusted)
    with _checks_off():
        captured = _r2_score_compute(*sums, n, adjusted=adjusted)
    assert_bitwise(captured, eager, "select against eager")


def test_r2_errors():
    ja, ta = _both(*_data(11))
    for ops in (ops_jax, ops_torch):
        x = ja if ops is ops_jax else ta
        with pytest.raises(ValueError, match="at least two samples"):
            ops.r2_score(x[0][:1], x[1][:1])
        with pytest.raises(ValueError, match="multioutput"):
            ops.r2_score(*x, multioutput="bad")
        with pytest.raises(ValueError, match="adjusted"):
            ops.r2_score(*x, adjusted=-1)


@pytest.mark.parametrize("multioutput", ("raw_values", "uniform_average", "variance_weighted"))
def test_explained_variance(multioutput):
    preds, target = _data(12, (N, 3), positive=False)
    target[:, 2] = 1.5  # a constant output: zero denominator
    preds[:, 2] = 1.5  # and zero numerator
    ja, ta = _both(preds, target)
    want = ops_jax.explained_variance(*ja, multioutput=multioutput)
    _close(ops_torch.explained_variance(*ta, multioutput=multioutput), want, rtol=LOOSE)


# --------------------------------------------------------------------------- #
# the classes, over several updates, engines off and at their defaults
# --------------------------------------------------------------------------- #
CLASSES = [
    ("MeanSquaredError", {}, (N,)),
    ("MeanSquaredError", {"squared": False}, (N,)),
    ("MeanSquaredError", {"num_outputs": 3}, (N, 3)),
    ("MeanAbsoluteError", {}, (N,)),
    ("MeanSquaredLogError", {}, (N,)),
    ("MeanAbsolutePercentageError", {}, (N,)),
    ("SymmetricMeanAbsolutePercentageError", {}, (N,)),
    ("WeightedMeanAbsolutePercentageError", {}, (N,)),
    ("CosineSimilarity", {"reduction": "mean"}, (N, 5)),
    ("CosineSimilarity", {"reduction": "none"}, (N, 5)),
    ("TweedieDevianceScore", {"power": 2.0}, (N,)),
    ("TweedieDevianceScore", {"power": 1.5}, (N,)),
    ("PearsonCorrCoef", {}, (N,)),
    ("SpearmanCorrCoef", {}, (N,)),
    ("R2Score", {}, (N,)),
    ("R2Score", {"num_outputs": 3, "multioutput": "raw_values"}, (N, 3)),
    ("R2Score", {"num_outputs": 3, "multioutput": "variance_weighted", "adjusted": 2}, (N, 3)),
    ("ExplainedVariance", {}, (N,)),
    ("ExplainedVariance", {"multioutput": "raw_values"}, (N, 3)),
]
ID = [f"{name}-{'-'.join(f'{k}={v}' for k, v in kw.items())}" for name, kw, _ in CLASSES]


def _states_close(ref, twin):
    for key in ref._defaults:
        want, got = getattr(ref, key), getattr(twin, key)
        if isinstance(want, list):
            for g, w in zip(got, want):
                assert_bitwise(g, np.asarray(w), key)
        elif got.is_floating_point():
            _close(got, want, rtol=LOOSE)
        else:
            assert_bitwise(got, np.asarray(want), key)


@pytest.mark.parametrize("compiled", (False, True), ids=("eager", "engines"))
@pytest.mark.parametrize("name,kwargs,shape", CLASSES, ids=ID)
def test_classes(name, kwargs, shape, compiled):
    flags = {} if compiled else {"compiled_update": False, "compiled_compute": False}
    # the JAX reference eager (its engines would compile each instance anew);
    # the port's engines are what ``compiled`` switches
    ref = getattr(mt_jax, name)(compiled_update=False, compiled_compute=False, **kwargs)
    twin = getattr(mt_torch, name)(device="cpu", **flags, **kwargs)
    for b in range(BATCHES):
        ja, ta = _both(*_data(20 + b, shape, positive=name != "CosineSimilarity"))
        ref.update(*ja)
        twin.update(*ta)
        _close(twin.compute(), ref.compute(), rtol=LOOSE)
    _states_close(ref, twin)


def test_pearson_final_aggregation_of_hand_stacked_moments():
    """Four ranks' running moments (of different sizes) stacked on a leading
    axis: the merge equals the JAX package's, and the single-stream value."""
    rng = np.random.default_rng(30)
    sizes = (7, 13, 4, 16)
    chunks = [(rng.normal(size=s).astype(np.float32), rng.normal(size=s).astype(np.float32)) for s in sizes]
    moments = []
    for p, t in chunks:
        zero = torch.tensor(0.0)
        moments.append(_pearson_corrcoef_update(torch.from_numpy(p), torch.from_numpy(t), *(zero,) * 6))
    stacked = [torch.stack([m[i] for m in moments]) for i in range(6)]
    got = _final_aggregation(*stacked)
    want = jax_final_aggregation(*[jnp.asarray(s.numpy()) for s in stacked])
    for g, w in zip(got, want):
        _close(g, w)
    metric = mt_torch.PearsonCorrCoef(device="cpu")
    for name, value in zip(("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total"), stacked):
        setattr(metric, name, value)
    metric._update_count = 1
    merged = metric.compute()  # takes the stacked branch
    whole = ops_torch.pearson_corrcoef(torch.from_numpy(np.concatenate([p for p, _ in chunks])),
                                       torch.from_numpy(np.concatenate([t for _, t in chunks])))
    _close(merged, whole.numpy())
    assert float(stacked[5].sum()) == sum(sizes)


def test_regression_errors_match():
    for mt in (mt_jax, mt_torch):
        kw = {} if mt is mt_jax else {"device": "cpu"}
        with pytest.raises(ValueError, match="multioutput"):
            mt.R2Score(multioutput="bad", **kw)
        with pytest.raises(ValueError, match="adjusted"):
            mt.R2Score(adjusted=-2, **kw)
        with pytest.raises(ValueError, match="reduction"):
            mt.CosineSimilarity(reduction="max", **kw)
        with pytest.raises(ValueError, match="multioutput"):
            mt.ExplainedVariance(multioutput="max", **kw)
