"""The curve family of the port against the JAX package, the functionals:
``metrics_tpu_torch/ops/classification/`` precision_recall_curve, roc, auc,
auroc, average_precision, calibration_error, and the port's ``bincount``
(the classes are ``tests/test_torch_curve_classes.py``).

The same seeded numpy inputs go to both packages, at N = 24 (the
``INVENTORY`` batch size) and N = 2,000 with C = 10, in binary, multiclass
and multilabel form, with tied scores (rounded to 2 decimals), ``-0.0``
mixed with ``0.0``, an absent class, every ``average``, ``pos_label`` and
``max_fpr``. Curve points (integer cumulative sums in float32, one IEEE
division each), thresholds and states are compared bit for bit; scalars that
are float sums (means, trapezoids, weighted bin sums) within 1e-6 relative
and absolute, the bound stated here (the JAX package's own tests hold these
metrics to sklearn at 1e-5/1e-6, ``tests/classification/test_curves.py``).
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.ops as ops_jax
from metrics_tpu_torch.ops.classification.auc import auc
from metrics_tpu_torch.ops.classification.auroc import auroc
from metrics_tpu_torch.ops.classification.average_precision import average_precision
from metrics_tpu_torch.ops.classification.calibration_error import calibration_error
from metrics_tpu_torch.ops.classification.precision_recall_curve import precision_recall_curve
from metrics_tpu_torch.ops.classification.roc import roc
from metrics_tpu_torch.utils.data import bincount
from tests.helpers import torch_parity as hp
from tests.helpers.torch_port import assert_bitwise

C = 10
SIZES = (24, 2000)


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(np.array(a, copy=True)) for a in arrays]


def _same(got, want, bitwise, msg=""):
    hp.assert_same_result("", got, want, bitwise=bitwise, msg=msg)


def _data(kind, n, seed=0, ties=False, signed_zero=False, absent=False):
    rng = np.random.default_rng(seed + n)
    if kind == "binary":
        preds = rng.random(n).astype(np.float32)
        target = rng.integers(0, 2, n).astype(np.int32)
    elif kind == "multiclass":
        preds = rng.dirichlet(np.ones(C), size=n).astype(np.float32)
        target = rng.integers(0, C - 1 if absent else C, n).astype(np.int32)
    else:  # multilabel
        preds = rng.random((n, C)).astype(np.float32)
        target = rng.integers(0, 2, (n, C)).astype(np.int32)
        if absent:
            target[:, -1] = 0
    if ties:
        preds = np.round(preds, 2).astype(np.float32)
    if signed_zero:
        zero = rng.random(preds.shape) < 0.25
        preds = np.where(zero, np.where(rng.random(preds.shape) < 0.5, np.float32(-0.0), np.float32(0.0)), preds)
        preds = preds.astype(np.float32)
    return preds, target


def _call(jax_fn, torch_fn, arrays, **kwargs):
    """Both functionals on the same inputs; (result, warnings) per package."""
    ja, ta = _both(*arrays)
    out = []
    for fn, args in ((jax_fn, ja), (torch_fn, ta)):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            res = fn(*args, **kwargs)
        out.append((res, sorted({str(w.message) for w in rec})))
    return out


# --------------------------------------------------------------------------- #
# the functionals
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("variant", ["plain", "ties", "signed_zero"])
@pytest.mark.parametrize("pos_label", [1, 0])
def test_binary_curves_are_bitwise(n, variant, pos_label):
    preds, target = _data("binary", n, ties=variant == "ties", signed_zero=variant == "signed_zero")
    for jax_fn, torch_fn in ((ops_jax.precision_recall_curve, precision_recall_curve), (ops_jax.roc, roc)):
        (want, wwarn), (got, gwarn) = _call(jax_fn, torch_fn, (preds, target), pos_label=pos_label)
        _same(got, want, True, f"{torch_fn.__name__} {variant}")
        assert gwarn == wwarn


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("variant", ["plain", "ties", "absent"])
def test_multiclass_curves_are_bitwise(n, variant):
    preds, target = _data("multiclass", n, ties=variant == "ties", absent=variant == "absent")
    for jax_fn, torch_fn in ((ops_jax.precision_recall_curve, precision_recall_curve), (ops_jax.roc, roc)):
        (want, wwarn), (got, gwarn) = _call(jax_fn, torch_fn, (preds, target), num_classes=C)
        _same(got, want, True, f"{torch_fn.__name__} {variant}")
        assert gwarn == wwarn


@pytest.mark.parametrize("n", SIZES)
def test_multilabel_roc_is_bitwise_and_the_pr_curve_raises_as_in_the_reference(n):
    preds, target = _data("multilabel", n, ties=True)
    (want, _), (got, _) = _call(ops_jax.roc, roc, (preds, target), num_classes=C)
    _same(got, want, True, "roc")
    # the JAX package's multi-class PR curve passes the whole (N, C) target
    # on per class and raises for multilabel input; the port keeps that
    ja, ta = _both(preds, target)
    with pytest.raises(ValueError, match="same number of dimensions") as want_err:
        ops_jax.precision_recall_curve(*ja, num_classes=C)
    with pytest.raises(ValueError) as got_err:
        precision_recall_curve(*ta, num_classes=C)
    assert str(got_err.value) == str(want_err.value)


def test_a_one_sided_target_warns_and_zeroes_like_the_reference():
    preds, _ = _data("binary", 24)
    for target in (np.ones(24, np.int32), np.zeros(24, np.int32)):
        (want, wwarn), (got, gwarn) = _call(ops_jax.roc, roc, (preds, target))
        _same(got, want, True)
        assert gwarn == wwarn and gwarn


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("max_fpr", [None, 0.05, 0.3, 0.8, 1.0])
@pytest.mark.parametrize("variant", ["plain", "ties", "signed_zero"])
def test_binary_auroc(n, max_fpr, variant):
    preds, target = _data("binary", n, ties=variant == "ties", signed_zero=variant == "signed_zero")
    (want, _), (got, _) = _call(ops_jax.auroc, auroc, (preds, target), pos_label=1, max_fpr=max_fpr)
    _same(got, want, False, f"max_fpr={max_fpr}")


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("average", ["macro", "weighted", None])
@pytest.mark.parametrize("variant", ["plain", "ties", "absent"])
def test_multiclass_auroc(n, average, variant):
    preds, target = _data("multiclass", n, ties=variant == "ties", absent=variant == "absent")
    (want, wwarn), (got, gwarn) = _call(ops_jax.auroc, auroc, (preds, target), num_classes=C, average=average)
    _same(got, want, False, f"{average} {variant}")
    assert gwarn == wwarn
    if variant == "absent" and average == "weighted":
        assert gwarn == [f"Class {C - 1} has no observations and is dropped from the AUROC average"]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("average", ["macro", "weighted", "micro", None])
def test_multilabel_auroc(n, average):
    preds, target = _data("multilabel", n, ties=True)
    (want, _), (got, _) = _call(ops_jax.auroc, auroc, (preds, target), num_classes=C, average=average)
    _same(got, want, False, str(average))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind,average", [
    ("binary", "macro"), ("multiclass", "macro"), ("multiclass", "weighted"), ("multiclass", None),
    ("multilabel", "micro"),
])
@pytest.mark.parametrize("variant", ["plain", "ties", "absent"])
def test_average_precision(n, kind, average, variant):
    preds, target = _data(kind, n, ties=variant == "ties", absent=variant == "absent")
    kwargs = dict(pos_label=1) if kind == "binary" else dict(num_classes=C, average=average)
    (want, wwarn), (got, gwarn) = _call(ops_jax.average_precision, average_precision, (preds, target), **kwargs)
    _same(got, want, False, f"{kind} {average} {variant}")
    assert gwarn == wwarn
    if variant == "absent" and kind == "multiclass" and average == "macro":
        assert any("was `nan`" in w for w in gwarn)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ["binary", "multiclass", "binary_logits", "multiclass_logits"])
@pytest.mark.parametrize("norm,n_bins", [("l1", 15), ("l2", 10), ("max", 7)])
def test_calibration_error(n, kind, norm, n_bins):
    preds, target = _data(kind.split("_")[0], n)
    if kind.endswith("logits"):
        preds = (np.log(preds + 1e-3) * 3.0).astype(np.float32)
    (want, _), (got, _) = _call(ops_jax.calibration_error, calibration_error, (preds, target), n_bins=n_bins, norm=norm)
    _same(got, want, False, f"{kind} {norm}")


@pytest.mark.parametrize("reorder,direction", [(True, 1), (False, 1), (False, -1)])
def test_auc(reorder, direction):
    rng = np.random.default_rng(11)
    x = np.sort(rng.random(50).astype(np.float32))[::direction]
    if reorder:
        x = rng.permutation(x)
    y = rng.random(50).astype(np.float32)
    (want, _), (got, _) = _call(ops_jax.auc, auc, (x, y), reorder=reorder)
    _same(got, want, False)


def test_auc_refuses_a_non_monotonic_x_as_the_reference_does():
    x, y = np.asarray([0.0, 2.0, 1.0], np.float32), np.asarray([0.0, 1.0, 1.0], np.float32)
    (jx, jy), (tx, ty) = _both(x, y)
    with pytest.raises(ValueError, match="monotonic") as want:
        ops_jax.auc(jx, jy)
    with pytest.raises(ValueError) as got:
        auc(tx, ty)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("values,length", [
    ([0, 1, 5, -1], 3), ([-3, -1, 0, 0, 2, 9, 4], 5), ([7, 8], 4), ([], 3),
])
@pytest.mark.parametrize("weighted", [False, True])
def test_bincount_clips_negatives_and_drops_values_past_the_length(values, length, weighted):
    x = np.asarray(values, np.int32)
    w = np.linspace(0.5, 2.0, len(values)).astype(np.float32)
    want = jnp.bincount(jnp.asarray(x), weights=jnp.asarray(w) if weighted else None, length=length)
    got = bincount(torch.from_numpy(x), length, weights=torch.from_numpy(w) if weighted else None)
    assert_bitwise(got, np.asarray(want))
