"""The multilabel ranking metrics, the hinge loss and the KL divergence of
the port against the JAX package: ``metrics_tpu_torch/ops/classification/``
ranking, hinge and kl_divergence, and their classes.

The same seeded numpy inputs go to both packages: ranking scores with ties
(rounded through float16, where the double argsort of the ranking loss must
be stable both times), rows with no or only relevant labels, and
``sample_weight``; hinge in its four modes (Crammer-Singer, one-vs-all,
binary, each also squared); KL on probabilities with zeros in ``p``, on
log-probabilities, under every reduction. Results and float32 states are
held within 1e-5, the JAX package's bound for these metrics
(``tests/classification/test_ranking.py``); integer states bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt_jax
import metrics_tpu.ops as ops_jax
import metrics_tpu_torch as mt_torch
import metrics_tpu_torch.ops as ops_torch
from tests.helpers import torch_parity as hp
from tests.helpers.torch_port import assert_close

N, L, C = 48, 6, 5
BOUND = 1e-5

pytestmark = pytest.mark.filterwarnings("ignore")


def _both(*arrays):
    return ([None if a is None else jnp.asarray(a) for a in arrays],
            [None if a is None else torch.from_numpy(np.array(a, copy=True)) for a in arrays])


def _close(got, want):
    want = np.asarray(want)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert tuple(got.shape) == want.shape
    assert_close(got.numpy().astype(np.float64), want.astype(np.float64), rtol=BOUND, atol=BOUND)


def _ranking_data(seed, ties):
    rng = np.random.default_rng(seed)
    preds = rng.random((N, L)).astype(np.float32)
    if ties:  # a mixed-precision model's scores: float16 leaves ties
        preds = np.round(preds * 8).astype(np.float16).astype(np.float32) / 8
    target = (rng.random((N, L)) < 0.35).astype(np.int32)
    target[0] = 0  # no relevant label
    target[1] = 1  # only relevant labels
    weight = rng.random(N).astype(np.float32)
    return preds, target, weight


RANKING = ("coverage_error", "label_ranking_average_precision", "label_ranking_loss")


@pytest.mark.parametrize("weighted", (False, True))
@pytest.mark.parametrize("ties", (False, True))
@pytest.mark.parametrize("name", RANKING)
def test_ranking_functionals(name, ties, weighted):
    preds, target, weight = _ranking_data(3, ties)
    ja, ta = _both(preds, target, weight if weighted else None)
    _close(getattr(ops_torch, name)(*ta), getattr(ops_jax, name)(*ja))


def test_label_ranking_loss_on_tied_scores_needs_the_stable_sort():
    """Every row holds ties. ``jnp.argsort`` is stable, so the loss orders
    tied labels by index: it equals the loss of the scores with ties broken
    upward by index, and differs from the loss with ties broken the other
    way. The port lands where the JAX package does."""
    rng = np.random.default_rng(11)
    preds = rng.integers(0, 3, (N, L)).astype(np.float32)
    target = (rng.random((N, L)) < 0.5).astype(np.int32)
    ja, ta = _both(preds, target)
    got, want = ops_torch.label_ranking_loss(*ta), ops_jax.label_ranking_loss(*ja)
    _close(got, want)
    offset = np.arange(L, dtype=np.float32)[None, :] * 1e-3
    by_index = ops_torch.label_ranking_loss(torch.from_numpy(preds + offset), ta[1])
    against_index = ops_torch.label_ranking_loss(torch.from_numpy(preds - offset), ta[1])
    assert float(by_index) == float(got)
    assert abs(float(against_index) - float(got)) > 1e-3


def test_tied_ranking_loss_differs_from_sklearn_in_both_packages():
    """sklearn counts a relevant label tied with an irrelevant one as a
    misordered pair; the JAX package's stable argsort orders the tie by label
    index. The port keeps the reference's value. Coverage and LRAP use
    max-tie ranks, as sklearn does, and agree with it."""
    sk = pytest.importorskip("sklearn.metrics")
    rng = np.random.default_rng(11)
    preds = rng.integers(0, 3, (N, L)).astype(np.float32)
    target = (rng.random((N, L)) < 0.5).astype(np.int32)
    ja, ta = _both(preds, target)
    got = float(ops_torch.label_ranking_loss(*ta))
    assert got == pytest.approx(float(ops_jax.label_ranking_loss(*ja)), abs=BOUND)
    assert abs(got - sk.label_ranking_loss(target, preds)) > 0.1
    assert float(ops_torch.coverage_error(*ta)) == pytest.approx(sk.coverage_error(target, preds), abs=BOUND)
    lrap = float(ops_torch.label_ranking_average_precision(*ta))
    assert lrap == pytest.approx(sk.label_ranking_average_precision_score(target, preds), abs=BOUND)


@pytest.mark.parametrize("name", RANKING)
def test_ranking_input_checks_raise_alike(name):
    preds, target, weight = _ranking_data(0, False)
    for args in ((preds[:, :3], target), (preds[0], target[0]), (preds, target, weight[:5])):
        ja, ta = _both(*args)
        with pytest.raises(ValueError):
            getattr(ops_jax, name)(*ja)
        with pytest.raises(ValueError):
            getattr(ops_torch, name)(*ta)


CLASSES = ("CoverageError", "LabelRankingAveragePrecision", "LabelRankingLoss")


@pytest.mark.parametrize("weighted", (False, True))
@pytest.mark.parametrize("name", CLASSES)
def test_ranking_classes(name, weighted):
    ref = getattr(mt_jax, name)(compiled_update=False, compiled_compute=False)
    port = getattr(mt_torch, name)(device="cpu", compiled_update=False, compiled_compute=False)
    for seed in range(3):
        preds, target, weight = _ranking_data(40 + seed, ties=seed == 1)
        ja, ta = _both(preds, target, weight if weighted else None)
        ref.update(*ja)
        port.update(*ta)
    hp.assert_same_states(ref, port, name)
    _close(port.compute(), ref.compute())


@pytest.mark.parametrize("name", CLASSES)
def test_a_weighted_ranking_compute_stays_eager_as_in_the_jax_engine(name):
    """``sample_weight != 0`` is read on the host: the JAX trace of the
    weighted compute fails and the port's probe raises; the unweighted
    compute is captured on both sides."""
    for weighted in (False, True):
        ref, port = getattr(mt_jax, name)(), getattr(mt_torch, name)(device="cpu")
        for seed in range(4):
            preds, target, weight = _ranking_data(50 + seed, ties=False)
            ja, ta = _both(preds, target, weight if weighted else None)
            ref.update(*ja)
            port.update(*ta)
            _close(port.compute(), ref.compute())
        part = hp.same_partition(ref, port, name)
        assert hp.counters(port) == hp.counters(ref)
        assert part["update"] == ("fused", "compilable")
        assert part["compute"] == (("eager", "runtime fallback") if weighted else ("fused", "compilable"))


# --------------------------------------------------------------------------- #
# hinge
# --------------------------------------------------------------------------- #
def _hinge_data(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "binary":
        return rng.normal(size=N).astype(np.float32), rng.integers(0, 2, N).astype(np.int32)
    if kind == "two-class":
        return rng.normal(size=(N, 2)).astype(np.float32), rng.integers(0, 2, N).astype(np.int32)
    return rng.normal(size=(N, C)).astype(np.float32), rng.integers(0, C, N).astype(np.int32)


HINGE_MODES = [
    ("binary", None),
    ("multiclass", None),
    ("multiclass", "crammer-singer"),
    ("multiclass", "one-vs-all"),
    ("two-class", "one-vs-all"),
]


@pytest.mark.parametrize("squared", (False, True))
@pytest.mark.parametrize("kind,mode", HINGE_MODES)
def test_hinge_loss(kind, mode, squared):
    ja, ta = _both(*_hinge_data(kind, seed=1))
    got = ops_torch.hinge_loss(*ta, squared=squared, multiclass_mode=mode)
    _close(got, ops_jax.hinge_loss(*ja, squared=squared, multiclass_mode=mode))


@pytest.mark.parametrize("kind,mode", HINGE_MODES)
def test_hinge_class(kind, mode):
    ref = mt_jax.HingeLoss(squared=True, multiclass_mode=mode, compiled_update=False, compiled_compute=False)
    port = mt_torch.HingeLoss(squared=True, multiclass_mode=mode, device="cpu", compiled_update=False,
                              compiled_compute=False)
    for seed in range(3):
        ja, ta = _both(*_hinge_data(kind, seed=60 + seed))
        ref.update(*ja)
        port.update(*ta)
    hp.assert_same_states(ref, port, "HingeLoss")
    _close(port.compute(), ref.compute())


def test_hinge_rejects_what_the_jax_package_rejects():
    preds, target = _hinge_data("multiclass")
    for args, kwargs in (((preds, target), dict(multiclass_mode="all-vs-all")),
                         ((np.stack([preds, preds], 2), target), {}),
                         ((preds[:, 0], target[:-1]), {}),
                         ((preds, np.stack([target, target], 1)), {})):
        ja, ta = _both(*args)
        with pytest.raises(ValueError):
            ops_jax.hinge_loss(*ja, **kwargs)
        with pytest.raises(ValueError):
            ops_torch.hinge_loss(*ta, **kwargs)
    with pytest.raises(ValueError):
        mt_torch.HingeLoss(multiclass_mode="all-vs-all", device="cpu")


# --------------------------------------------------------------------------- #
# KL divergence
# --------------------------------------------------------------------------- #
def _kl_data(seed, log_prob):
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.ones(C), N).astype(np.float32)
    q = rng.dirichlet(np.ones(C), N).astype(np.float32)
    p[rng.random((N, C)) < 0.2] = 0.0  # zeros in p: 0 * log(0 / q) is 0
    p[:, 0] += 1e-3  # no all-zero row
    if log_prob:
        p, q = np.log(p + 1e-6).astype(np.float32), np.log(q).astype(np.float32)
    return p, q


REDUCTIONS = ("mean", "sum", "none", None)


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("log_prob", (False, True))
def test_kl_divergence(log_prob, reduction):
    ja, ta = _both(*_kl_data(2, log_prob))
    got = ops_torch.kl_divergence(*ta, log_prob=log_prob, reduction=reduction)
    _close(got, ops_jax.kl_divergence(*ja, log_prob=log_prob, reduction=reduction))


def test_safe_xlogy_is_zero_where_x_is_zero_even_for_nan_y():
    from metrics_tpu.utils.compute import safe_xlogy as xlogy_jax
    from metrics_tpu_torch.utils.compute import safe_xlogy as xlogy_torch

    x = np.array([0.0, 0.0, 0.0, 0.5, 2.0, 1.0], np.float32)
    y = np.array([np.nan, 0.0, 3.0, 0.25, np.inf, np.nan], np.float32)
    ja, ta = _both(x, y)
    got = xlogy_torch(*ta)
    assert_close(got, np.asarray(xlogy_jax(*ja)), rtol=0, atol=0)  # NaN where JAX has NaN, any NaN bits
    assert got[0] == 0.0 and torch.isnan(torch.xlogy(ta[0], ta[1]))[0]


KL_CLASS_CASES = [(r, False) for r in REDUCTIONS] + [("none", True), (None, True)]


@pytest.mark.parametrize("reduction,buffered", KL_CLASS_CASES)
@pytest.mark.parametrize("log_prob", (False, True))
def test_kl_class(log_prob, reduction, buffered):
    """``"none"``/``None`` keep each row's divergence in a list, or in a
    CatBuffer under ``buffer_capacity``."""
    kw = dict(log_prob=log_prob, reduction=reduction, compiled_update=False, compiled_compute=False)
    if buffered:
        kw["buffer_capacity"] = 64
    ref, port = mt_jax.KLDivergence(**kw), mt_torch.KLDivergence(device="cpu", **kw)
    for seed in range(3):
        ja, ta = _both(*_kl_data(70 + seed, log_prob))
        ref.update(*ja)
        port.update(*ta)
    hp.assert_same_states(ref, port, "KLDivergence")
    _close(port.compute(), ref.compute())


def test_kl_rejects_what_the_jax_package_rejects():
    p, q = _kl_data(0, False)
    for args in ((p, q[:, :3]), (p[0], q[0])):
        ja, ta = _both(*args)
        with pytest.raises((RuntimeError, ValueError)) as want:
            ops_jax.kl_divergence(*ja)
        with pytest.raises(want.type):
            ops_torch.kl_divergence(*ta)
    with pytest.raises(TypeError):
        mt_torch.KLDivergence(log_prob=1, device="cpu")
    with pytest.raises(ValueError):
        mt_torch.KLDivergence(reduction="max", device="cpu")
