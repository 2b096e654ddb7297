"""The six classes of the curve family (PrecisionRecallCurve, ROC, AUC,
AUROC, AveragePrecision, CalibrationError) against the JAX package, default
(list states) and buffered (``CatBuffer`` states); their functionals are
``tests/test_torch_curves.py``, whose inputs this module shares.

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

import metrics_tpu as mt_jax
import metrics_tpu_torch as mt_torch
from tests.helpers import torch_parity as hp
from tests.helpers.torch_port import assert_bitwise
from tests.test_torch_curves import C, SIZES, _data, _same


# --------------------------------------------------------------------------- #
# the classes
# --------------------------------------------------------------------------- #
def _class_cases():
    cases = []
    for kind in ("binary", "multiclass", "multilabel"):
        args = dict(pos_label=1) if kind == "binary" else dict(num_classes=C)
        cases += [("PrecisionRecallCurve", kind, args), ("ROC", kind, args)]
        for average in ("macro", "weighted", None) + (("micro",) if kind == "multilabel" else ()):
            cases.append(("AUROC", kind, dict(args, average=average)))
    cases.append(("AUROC", "binary", dict(pos_label=1, max_fpr=0.5)))
    cases += [("AveragePrecision", "binary", dict(pos_label=1)), ("AveragePrecision", "multilabel", dict(num_classes=C, average="micro"))]
    cases += [("AveragePrecision", "multiclass", dict(num_classes=C, average=a)) for a in ("macro", "weighted", None)]
    cases += [("CalibrationError", k, dict(n_bins=b, norm=nm)) for k in ("binary", "multiclass") for b, nm in ((15, "l1"), (10, "max"))]
    return [c for c in cases if not (c[0] == "PrecisionRecallCurve" and c[1] == "multilabel")]


CLASS_CASES = _class_cases()
EXACT = {"PrecisionRecallCurve", "ROC"}


def _ids(case):
    name, kind, args = case
    return f"{name}-{kind}-" + "-".join(f"{k}={v}" for k, v in args.items())


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("buffered", [False, True])
@pytest.mark.parametrize("case", CLASS_CASES, ids=_ids)
def test_classes_over_three_updates(case, buffered, n):
    name, kind, args = case
    preds, target = _data(kind, n, seed=7, ties=True)
    extra = dict(buffer_capacity=3 * n) if buffered else {}
    ref = getattr(mt_jax, name)(**args, **extra)
    port = getattr(mt_torch, name)(**args, **extra, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for chunk in np.array_split(np.arange(n), 3):
            hp.update_both(ref, port, [((preds[chunk], target[chunk]), {})])
        want, got = ref.compute(), port.compute()
    hp.assert_same_states(ref, port, name)
    _same(got, want, name in EXACT, _ids(case))


@pytest.mark.parametrize("name", ["AUC"])
@pytest.mark.parametrize("buffered", [False, True])
def test_auc_class(name, buffered):
    rng = np.random.default_rng(12)
    x, y = rng.random(60).astype(np.float32), rng.random(60).astype(np.float32)
    extra = dict(buffer_capacity=128) if buffered else {}
    ref, port = mt_jax.AUC(reorder=True, **extra), mt_torch.AUC(reorder=True, **extra, device="cpu")
    for chunk in np.array_split(np.arange(60), 3):
        hp.update_both(ref, port, [((x[chunk], y[chunk]), {})])
    hp.assert_same_states(ref, port, name)
    _same(port.compute(), ref.compute(), False)


def test_auroc_sketch_route_is_refused_until_the_sketches_are_ported():
    # the sketches are ported: the route refuses what the JAX package refuses
    assert mt_torch.AUROC(approx="sketch", device="cpu").approx == "sketch"
    for kwargs, match in ((dict(num_classes=3), "binary scores only"), (dict(max_fpr=0.5), "max_fpr")):
        with pytest.raises(mt_torch.utils.exceptions.MetricsUserError, match=match):
            mt_torch.AUROC(approx="sketch", device="cpu", **kwargs)
    with pytest.raises(ValueError, match="approx"):
        mt_torch.AUROC(approx="histogram", device="cpu")


def test_auroc_refuses_a_mode_change_as_the_reference_does():
    preds, target = _data("binary", 24)
    mpreds, mtarget = _data("multiclass", 24)
    for metric, pkg in ((mt_jax.AUROC(num_classes=C), jnp), (mt_torch.AUROC(num_classes=C, device="cpu"), torch)):
        to = jnp.asarray if pkg is jnp else torch.from_numpy
        metric.update(to(preds), to(target))
        with pytest.raises(ValueError, match="mode of data"):
            metric.update(to(mpreds), to(mtarget))


@pytest.mark.parametrize("n_bins", [1, 7, 15, 100])
def test_calibration_bin_boundaries_are_the_jax_grid_and_move_with_the_metric(n_bins):
    port = mt_torch.CalibrationError(n_bins=n_bins, device="cpu")
    assert_bitwise(port.bin_boundaries, np.asarray(mt_jax.CalibrationError(n_bins=n_bins).bin_boundaries))
    port.to("cpu")
    assert port.bin_boundaries.device.type == "cpu"


@pytest.mark.parametrize("buffered", [False, True])
def test_the_curve_classes_leave_the_engines_no_host_read_in_update(buffered):
    """With buffers the update is captured and the states stay bitwise to an
    eager twin over ragged batches (a ragged batch is a new signature)."""
    preds, target = _data("multiclass", 300, seed=3)
    extra = dict(buffer_capacity=512) if buffered else {}
    compiled = mt_torch.AUROC(num_classes=C, **extra, device="cpu")
    eager = mt_torch.AUROC(num_classes=C, **extra, device="cpu", compiled_update=False)
    for lo, hi in ((0, 64), (64, 128), (128, 192), (192, 256), (256, 300)):
        for m in (compiled, eager):
            m.update(torch.from_numpy(preds[lo:hi]), torch.from_numpy(target[lo:hi]))
    stats = compiled.engine_stats()["update"]
    if buffered:
        assert (stats.eager_calls, stats.cache_misses, stats.cache_hits) == (3, 1, 1)
    else:
        assert compiled.engine_stats()["partition"]["update"]["path"] == "eager"
    _same(compiled.compute(), eager.compute(), True)
