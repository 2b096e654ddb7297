"""The confusion-matrix family and the two stat-score ratios of the port
against the JAX package: ``metrics_tpu_torch/ops/classification/``
confusion_matrix, jaccard, matthews_corrcoef, cohen_kappa, specificity and
dice, and their classes.

The same seeded numpy inputs go to both packages in binary, multiclass
(probabilities and labels), multilabel and multidim form, with an absent
class. Integer matrices are compared bit for bit; everything else within
1e-6 relative and absolute, the JAX package's own bound for this family
(``tests/classification/test_confmat_family.py``).
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
from tests.helpers.torch_port import assert_bitwise, assert_close

C = 5
N = 64
KINDS = ("binary", "probs", "labels", "multilabel", "multidim")
NORMALIZE = (None, "none", "true", "pred", "all")

pytestmark = pytest.mark.filterwarnings("ignore")


def _data(kind, seed=0, n=N):
    """(preds, target, num_classes); class C - 1 never occurs in the
    multiclass targets (an absent class)."""
    rng = np.random.default_rng(seed + 17 * KINDS.index(kind))
    if kind == "binary":
        return rng.random(n).astype(np.float32), rng.integers(0, 2, n).astype(np.int32), 2
    if kind == "probs":
        return rng.dirichlet(np.ones(C), n).astype(np.float32), rng.integers(0, C - 1, n).astype(np.int32), C
    if kind == "labels":
        return rng.integers(0, C, n).astype(np.int32), rng.integers(0, C - 1, n).astype(np.int32), C
    if kind == "multilabel":
        return rng.random((n, C)).astype(np.float32), rng.integers(0, 2, (n, C)).astype(np.int32), C
    logits = rng.normal(size=(n, C, 3)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    return probs.astype(np.float32), rng.integers(0, C - 1, (n, 3)).astype(np.int32), C


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(np.array(a, copy=True)) for a in arrays]


def _same(got, want):
    """Integer results bit for bit, float results within the bound."""
    want = np.asarray(want)
    if np.issubdtype(want.dtype, np.integer):
        assert_bitwise(got, want)
    else:
        assert got.dtype == torch.float32 and want.dtype == np.float32
        assert_close(got.numpy().astype(np.float64), want.astype(np.float64), rtol=hp.RTOL, atol=hp.ATOL)


def _call_both(name, arrays, **kwargs):
    """The functional ``name`` of both packages; the port must raise the
    same exception type where the JAX package raises."""
    ja, ta = _both(*arrays)
    try:
        want = getattr(ops_jax, name)(*ja, **kwargs)
    except Exception as err:  # noqa: BLE001 - the port must raise alike
        with pytest.raises(type(err)):
            getattr(ops_torch, name)(*ta, **kwargs)
        return None
    got = getattr(ops_torch, name)(*ta, **kwargs)
    _same(got, want)
    return got


# --------------------------------------------------------------------------- #
# the functionals
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("normalize", NORMALIZE)
@pytest.mark.parametrize("kind", KINDS)
def test_confusion_matrix(kind, normalize):
    preds, target, nc = _data(kind)
    got = _call_both("confusion_matrix", (preds, target), num_classes=nc, normalize=normalize,
                     multilabel=kind == "multilabel")
    assert got is not None and got.dtype == (torch.int32 if normalize in (None, "none") else torch.float32)


def test_confusion_matrix_threshold_and_multilabel_layout():
    preds, target, _ = _data("multilabel", seed=3)
    got = _call_both("confusion_matrix", (preds, target), num_classes=C, threshold=0.3, multilabel=True)
    assert tuple(got.shape) == (C, 2, 2) and int(got.sum()) == N * C


@pytest.mark.parametrize("absent_score", (0.0, 0.5))
@pytest.mark.parametrize("ignore_index", (None, 0, 2, C + 3))
@pytest.mark.parametrize("average", ("micro", "macro", "weighted", "none", None))
@pytest.mark.parametrize("kind", ("probs", "labels"))
def test_jaccard_index(kind, average, ignore_index, absent_score):
    preds, target, nc = _data(kind, seed=1)
    _call_both("jaccard_index", (preds, target), num_classes=nc, average=average, ignore_index=ignore_index,
               absent_score=absent_score)


@pytest.mark.parametrize("kind", ("binary", "probs", "labels", "multidim"))
def test_jaccard_index_other_inputs(kind):
    preds, target, nc = _data(kind, seed=2)
    _call_both("jaccard_index", (preds, target), num_classes=nc)


@pytest.mark.parametrize("kind", ("binary", "probs", "labels", "multidim"))
def test_matthews_corrcoef(kind):
    preds, target, nc = _data(kind, seed=4)
    _call_both("matthews_corrcoef", (preds, target), num_classes=nc)


def test_matthews_corrcoef_of_a_constant_prediction_is_zero():
    target = np.arange(N, dtype=np.int32) % C
    got = _call_both("matthews_corrcoef", (np.zeros(N, np.int32), target), num_classes=C)
    assert float(got) == 0.0


@pytest.mark.parametrize("weights", (None, "linear", "quadratic"))
@pytest.mark.parametrize("kind", ("binary", "probs", "labels", "multidim"))
def test_cohen_kappa(kind, weights):
    preds, target, nc = _data(kind, seed=5)
    _call_both("cohen_kappa", (preds, target), num_classes=nc, weights=weights)


def test_cohen_kappa_rejects_other_weights():
    preds, target, nc = _data("labels")
    _call_both("cohen_kappa", (preds, target), num_classes=nc, weights="cubic")


AVERAGES = ("micro", "macro", "weighted", "none", "samples")


@pytest.mark.parametrize("average", AVERAGES)
@pytest.mark.parametrize("kind", ("binary", "probs", "labels", "multilabel"))
def test_specificity(kind, average):
    preds, target, nc = _data(kind, seed=6)
    nc = None if kind == "binary" and average in ("micro", "samples") else (1 if kind == "binary" else nc)
    _call_both("specificity", (preds, target), average=average, num_classes=nc)


@pytest.mark.parametrize("zero_division", (0, 1))
@pytest.mark.parametrize("average", AVERAGES)
@pytest.mark.parametrize("kind", ("binary", "probs", "labels", "multilabel"))
def test_dice(kind, average, zero_division):
    preds, target, nc = _data(kind, seed=7)
    nc = None if kind == "binary" and average in ("micro", "samples") else (1 if kind == "binary" else nc)
    _call_both("dice", (preds, target), average=average, num_classes=nc, zero_division=zero_division)


@pytest.mark.parametrize("mdmc_average", ("global", "samplewise"))
@pytest.mark.parametrize("average", ("micro", "macro", "none"))
@pytest.mark.parametrize("name", ("specificity", "dice"))
def test_multidim_averages(name, average, mdmc_average):
    preds, target, nc = _data("multidim", seed=8)
    _call_both(name, (preds, target), average=average, mdmc_average=mdmc_average, num_classes=nc)


@pytest.mark.parametrize("bg", (False, True))
def test_dice_score_alias(bg):
    preds, target, _ = _data("probs", seed=9)
    _call_both("dice_score", (preds, target), bg=bg, nan_score=1.0)


# --------------------------------------------------------------------------- #
# the classes
# --------------------------------------------------------------------------- #
CLASSES = [
    ("ConfusionMatrix", dict(num_classes=C), "probs"),
    ("ConfusionMatrix", dict(num_classes=C, normalize="true"), "labels"),
    ("ConfusionMatrix", dict(num_classes=C, normalize="all"), "multidim"),
    ("ConfusionMatrix", dict(num_classes=C, multilabel=True, normalize="pred"), "multilabel"),
    ("JaccardIndex", dict(num_classes=C), "probs"),
    ("JaccardIndex", dict(num_classes=C, average="none", ignore_index=1, absent_score=0.25), "labels"),
    ("JaccardIndex", dict(num_classes=C, average="weighted", ignore_index=0), "probs"),
    ("MatthewsCorrCoef", dict(num_classes=C), "probs"),
    ("MatthewsCorrCoef", dict(num_classes=2), "binary"),
    ("CohenKappa", dict(num_classes=C), "probs"),
    ("CohenKappa", dict(num_classes=C, weights="quadratic"), "labels"),
    ("CohenKappa", dict(num_classes=C, weights="linear"), "multidim"),
    ("Specificity", dict(num_classes=C), "probs"),
    ("Specificity", dict(num_classes=C, average="macro"), "labels"),
    ("Specificity", dict(num_classes=C, average="none"), "probs"),
    ("Specificity", dict(num_classes=C, average="macro", mdmc_average="samplewise"), "multidim"),
    ("Dice", dict(num_classes=C, multiclass=True), "probs"),
    ("Dice", dict(num_classes=C, average="weighted"), "labels"),
    ("Dice", dict(num_classes=C, average="samples", zero_division=1), "multilabel"),
]


@pytest.mark.parametrize("name,kwargs,kind", CLASSES, ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(CLASSES)])
def test_class_states_and_results(name, kwargs, kind):
    ref = getattr(mt_jax, name)(compiled_update=False, compiled_compute=False, **kwargs)
    port = getattr(mt_torch, name)(device="cpu", compiled_update=False, compiled_compute=False, **kwargs)
    for seed in range(3):
        preds, target, _ = _data(kind, seed=20 + seed)
        ja, ta = _both(preds, target)
        ref.update(*ja)
        port.update(*ta)
    hp.assert_same_states(ref, port, name)
    _same(port.compute(), ref.compute())


def test_binary_confusion_matrix_reverts_its_update_as_the_jax_engine_does():
    """With binary probabilities and num_classes=2 the traced update's input
    check raises; both engines keep that update eager."""
    ref, port = mt_jax.ConfusionMatrix(num_classes=2), mt_torch.ConfusionMatrix(num_classes=2, device="cpu")
    preds, target, _ = _data("binary")
    ja, ta = _both(preds, target)
    for _ in range(3):
        ref.update(*ja)
        port.update(*ta)
        _same(port.compute(), ref.compute())
    assert hp.same_partition(ref, port, "ConfusionMatrix")["update"] == ("eager", "runtime fallback")


def _collection(pkg, **kw):
    return pkg.MetricCollection({
        "confmat": pkg.ConfusionMatrix(num_classes=C, **kw),
        "jaccard": pkg.JaccardIndex(num_classes=C, **kw),
        "mcc": pkg.MatthewsCorrCoef(num_classes=C, **kw),
        "kappa": pkg.CohenKappa(num_classes=C, **kw),
        "specificity": pkg.Specificity(num_classes=C, average="macro", **kw),
        "dice": pkg.Dice(num_classes=C, average="macro", **kw),
    })


def test_collection_compute_groups_and_results_match_the_jax_collection():
    ref, port = _collection(mt_jax), _collection(mt_torch, device="cpu")
    assert port.compute_groups == ref.compute_groups
    assert sorted(map(sorted, port.compute_groups.values()))[0] == ["confmat", "jaccard", "kappa", "mcc"]
    for seed in range(4):
        preds, target, _ = _data("probs", seed=30 + seed)
        ja, ta = _both(preds, target)
        ref.update(*ja)
        port.update(*ta)
        want, got = ref.compute(), port.compute()
        assert sorted(got) == sorted(want)
        for key in want:
            _same(got[key], want[key])

