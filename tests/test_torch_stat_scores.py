"""Stat scores and the four main-path metrics: the port against the JAX package.

The same numpy inputs go through ``metrics_tpu`` and ``metrics_tpu_torch``.
tp/fp/tn/fn are int32 counts and must match bit for bit (dtype included);
Accuracy/F1/Precision/Recall values are float32 ratios whose division and
sum order may differ, so they agree within rtol=1e-6, atol=1e-7.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt_jax
import metrics_tpu_torch as mt_torch
from metrics_tpu.ops.classification.stat_scores import _stat_scores_update as jax_update
from metrics_tpu.utils.enums import DataType as JaxDataType
from metrics_tpu_torch.ops import accuracy, f1_score, fbeta_score, precision, recall, stat_scores
from metrics_tpu_torch.ops.classification.stat_scores import _stat_scores_update as torch_update
from metrics_tpu_torch.utils.data import argmax_first, select_topk, to_onehot
from metrics_tpu_torch.utils.enums import DataType as TorchDataType
from tests.helpers.torch_port import assert_bitwise, assert_close, both, strict_float32

strict_float32()

N, C, X = 97, 5, 3


def _probs(rng, *shape):
    return rng.uniform(size=shape).astype(np.float32)


def _labels(rng, *shape, high=C):
    return rng.integers(0, high, size=shape).astype(np.int64)


# name -> (inputs from a seeded rng, _stat_scores_update kwargs)
CASES = {
    "binary-prob": (lambda r: (_probs(r, N), _labels(r, N, high=2)), dict(reduce="micro")),
    "binary-prob-samples": (lambda r: (_probs(r, N), _labels(r, N, high=2)), dict(reduce="samples")),
    "binary-threshold": (lambda r: (_probs(r, N), _labels(r, N, high=2)), dict(reduce="micro", threshold=0.3)),
    "multiclass-labels-micro": (lambda r: (_labels(r, N), _labels(r, N)), dict(reduce="micro", num_classes=C)),
    "multiclass-labels-macro": (lambda r: (_labels(r, N), _labels(r, N)), dict(reduce="macro", num_classes=C)),
    "multiclass-labels-samples": (lambda r: (_labels(r, N), _labels(r, N)), dict(reduce="samples", num_classes=C)),
    "multiclass-labels-inferred": (lambda r: (_labels(r, N), _labels(r, N)), dict(reduce="micro")),
    "multiclass-logits-micro": (lambda r: (_probs(r, N, C), _labels(r, N)), dict(reduce="micro")),
    "multiclass-logits-macro": (lambda r: (_probs(r, N, C), _labels(r, N)), dict(reduce="macro", num_classes=C)),
    "multiclass-logits-samples": (lambda r: (_probs(r, N, C), _labels(r, N)), dict(reduce="samples")),
    "multiclass-logits-ties": (
        lambda r: (np.round(_probs(r, N, C) * 2) / 2, _labels(r, N)),  # many tied maxima
        dict(reduce="macro", num_classes=C),
    ),
    "multiclass-not-multiclass": (
        lambda r: (_probs(r, N, 2), _labels(r, N, high=2)),
        dict(reduce="micro", multiclass=False),
    ),
    "multilabel-micro": (lambda r: (_probs(r, N, C), _labels(r, N, C, high=2)), dict(reduce="micro")),
    "multilabel-macro": (lambda r: (_probs(r, N, C), _labels(r, N, C, high=2)), dict(reduce="macro", num_classes=C)),
    "multilabel-samples": (lambda r: (_probs(r, N, C), _labels(r, N, C, high=2)), dict(reduce="samples")),
    "multilabel-top2": (lambda r: (_probs(r, N, C), _labels(r, N, C, high=2)), dict(reduce="macro", num_classes=C, top_k=2)),
    "top2-micro": (lambda r: (_probs(r, N, C), _labels(r, N)), dict(reduce="micro", top_k=2)),
    "top2-macro": (lambda r: (_probs(r, N, C), _labels(r, N)), dict(reduce="macro", num_classes=C, top_k=2)),
    "ignore-index-macro": (lambda r: (_probs(r, N, C), _labels(r, N)), dict(reduce="macro", num_classes=C, ignore_index=1)),
    "ignore-index-micro": (lambda r: (_probs(r, N, C), _labels(r, N)), dict(reduce="micro", num_classes=C, ignore_index=1)),
    "ignore-index-labels-macro": (lambda r: (_labels(r, N), _labels(r, N)), dict(reduce="macro", num_classes=C, ignore_index=0)),
    "mdmc-global": (lambda r: (_probs(r, N, C, X), _labels(r, N, X)), dict(reduce="macro", num_classes=C, mdmc_reduce="global")),
    "mdmc-samplewise": (lambda r: (_probs(r, N, C, X), _labels(r, N, X)), dict(reduce="micro", mdmc_reduce="samplewise")),
    "mdmc-labels-global": (lambda r: (_labels(r, N, X), _labels(r, N, X)), dict(reduce="micro", num_classes=C, mdmc_reduce="global")),
    # scatter fast path: predicted labels >= num_classes are dropped
    "scatter-out-of-range-macro": (lambda r: (_labels(r, N, high=C + 3), _labels(r, N)), dict(reduce="macro", num_classes=C)),
    "scatter-out-of-range-micro": (lambda r: (_labels(r, N, high=C + 3), _labels(r, N)), dict(reduce="micro", num_classes=C)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stat_scores_update_bitwise(case):
    make, kwargs = CASES[case]
    preds, target = make(np.random.default_rng(sorted(CASES).index(case)))
    (jp, tp_), (jt, tt) = both(preds), both(target)
    want = jax_update(jp, jt, **kwargs)
    got = torch_update(tp_, tt, **kwargs)
    for g, w, name in zip(got, want, ("tp", "fp", "tn", "fn")):
        assert_bitwise(g, w, msg=f"{case} {name}")


@pytest.mark.parametrize("reduce", ["macro", "micro", "samples"])
def test_sample_mask_bitwise(reduce):
    rng = np.random.default_rng(11)
    preds, target, mask = _probs(rng, N, C), _labels(rng, N), rng.uniform(size=N) < 0.7
    kwargs = dict(reduce=reduce, num_classes=C)
    want = jax_update(jnp.asarray(preds), jnp.asarray(target), sample_mask=jnp.asarray(mask), **kwargs)
    got = torch_update(torch.from_numpy(preds), torch.from_numpy(target), sample_mask=torch.from_numpy(mask), **kwargs)
    for g, w in zip(got, want):
        assert_bitwise(g, w)


@pytest.mark.parametrize("reduce", ["macro", "micro"])
def test_negative_ignore_index_masks_rows(reduce):
    """A negative ignore_index masks its rows (the path Accuracy takes with ``mode``)."""
    rng = np.random.default_rng(12)
    preds, target = _probs(rng, N, C), _labels(rng, N)
    target[::4] = -1
    want = jax_update(jnp.asarray(preds), jnp.asarray(target), reduce=reduce, num_classes=C, ignore_index=-1,
                      mode=JaxDataType.MULTICLASS)
    got = torch_update(torch.from_numpy(preds), torch.from_numpy(target), reduce=reduce, num_classes=C,
                       ignore_index=-1, mode=TorchDataType.MULTICLASS)
    for g, w in zip(got, want):
        assert_bitwise(g, w)


def test_public_stat_scores_bitwise():
    rng = np.random.default_rng(13)
    preds, target = _probs(rng, N, C), _labels(rng, N)
    for reduce in ("micro", "macro", "samples"):
        want = mt_jax.ops.stat_scores(jnp.asarray(preds), jnp.asarray(target), reduce=reduce, num_classes=C)
        got = stat_scores(torch.from_numpy(preds), torch.from_numpy(target), reduce=reduce, num_classes=C)
        assert_bitwise(got, want, msg=reduce)


def test_helpers_match_the_jax_helpers():
    from metrics_tpu.utils import data as jax_data

    rng = np.random.default_rng(14)
    x = np.round(rng.uniform(size=(40, 6)).astype(np.float32) * 3) / 3  # ties
    x[5, :] = np.nan
    x[6, 2] = np.nan
    assert_bitwise(argmax_first(torch.from_numpy(x), dim=1).to(torch.int32), jax_data.argmax_first(jnp.asarray(x), axis=1))
    x = x[7:]
    for k in (1, 2, 3):
        assert_bitwise(select_topk(torch.from_numpy(x), k), jax_data.select_topk(jnp.asarray(x), k), msg=f"top{k}")
    labels = rng.integers(-2, 8, size=(30, 4))
    assert_bitwise(to_onehot(torch.from_numpy(labels), 6), jax_data.to_onehot(jnp.asarray(labels), 6))


# --------------------------------------------------------------------------- #
# metric values
# --------------------------------------------------------------------------- #
METRIC_INPUTS = {
    "binary": lambda r: (_probs(r, N), _labels(r, N, high=2)),
    "multiclass-logits": lambda r: (_probs(r, N, C), _labels(r, N)),
    "multiclass-labels": lambda r: (_labels(r, N), _labels(r, N)),
    "multilabel": lambda r: (_probs(r, N, C), _labels(r, N, C, high=2)),
}
AVERAGES = ["micro", "macro", "weighted", "none"]


def _metric_pair(name, **kwargs):
    # the JAX reference eager: its engines would compile each instance anew
    # (the port's engines are at their defaults, under test)
    ref = getattr(mt_jax, name)(compiled_update=False, compiled_compute=False, **kwargs)
    return ref, getattr(mt_torch, name)(device="cpu", **kwargs)


@pytest.mark.parametrize("name", ["Accuracy", "Precision", "Recall", "F1Score"])
@pytest.mark.parametrize("average", AVERAGES)
@pytest.mark.parametrize("inputs", ["multiclass-logits", "multiclass-labels", "multilabel"])
def test_metric_values_close(name, average, inputs):
    rng = np.random.default_rng(AVERAGES.index(average) * 10 + len(inputs))
    jax_metric, torch_metric = _metric_pair(name, num_classes=C, average=average)
    for _ in range(3):
        preds, target = METRIC_INPUTS[inputs](rng)
        jax_metric.update(jnp.asarray(preds), jnp.asarray(target))
        torch_metric.update(torch.from_numpy(preds), torch.from_numpy(target))
    for state in ("tp", "fp", "tn", "fn"):
        assert_bitwise(getattr(torch_metric, state), getattr(jax_metric, state), msg=state)
    assert_close(torch_metric.compute(), jax_metric.compute())


@pytest.mark.parametrize("name", ["Accuracy", "Precision", "Recall", "F1Score"])
def test_binary_metric_values_close(name):
    rng = np.random.default_rng(21)
    jax_metric, torch_metric = _metric_pair(name)
    for _ in range(3):
        preds, target = METRIC_INPUTS["binary"](rng)
        jax_metric.update(jnp.asarray(preds), jnp.asarray(target))
        torch_metric.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert_close(torch_metric.compute(), jax_metric.compute())


@pytest.mark.parametrize(
    "kwargs",
    [dict(top_k=2), dict(ignore_index=2), dict(subset_accuracy=True), dict(mdmc_average="samplewise")],
    ids=["top2", "ignore2", "subset", "samplewise"],
)
def test_accuracy_variants(kwargs):
    rng = np.random.default_rng(22)
    multidim = kwargs.get("subset_accuracy") or kwargs.get("mdmc_average")
    jax_metric, torch_metric = _metric_pair("Accuracy", num_classes=C, **kwargs)
    for _ in range(2):
        preds = _probs(rng, N, C, X) if multidim else _probs(rng, N, C)
        target = _labels(rng, N, X) if multidim else _labels(rng, N)
        jax_metric.update(jnp.asarray(preds), jnp.asarray(target))
        torch_metric.update(torch.from_numpy(preds), torch.from_numpy(target))
    for state in torch_metric._defaults:
        got, want = getattr(torch_metric, state), getattr(jax_metric, state)
        if isinstance(got, list):
            got, want = torch.cat(got), jnp.concatenate(want)
        assert_bitwise(got, want, msg=state)
    assert_close(torch_metric.compute(), jax_metric.compute())


def test_functional_values_close():
    rng = np.random.default_rng(23)
    preds, target = _probs(rng, N, C), _labels(rng, N)
    (jp, tp_), (jt, tt) = both(preds), both(target)
    pairs = [
        (accuracy(tp_, tt), mt_jax.ops.accuracy(jp, jt)),
        (precision(tp_, tt, average="macro", num_classes=C), mt_jax.ops.precision(jp, jt, average="macro", num_classes=C)),
        (recall(tp_, tt, average="weighted", num_classes=C), mt_jax.ops.recall(jp, jt, average="weighted", num_classes=C)),
        (f1_score(tp_, tt, average="none", num_classes=C), mt_jax.ops.f1_score(jp, jt, average="none", num_classes=C)),
        (fbeta_score(tp_, tt, beta=0.5, num_classes=C), mt_jax.ops.fbeta_score(jp, jt, beta=0.5, num_classes=C)),
    ]
    for got, want in pairs:
        assert_close(got, want)


def test_state_dtypes_match_the_jax_package():
    acc = mt_torch.Accuracy(num_classes=C, subset_accuracy=True, device="cpu")
    assert acc.correct.dtype == torch.int32 and acc.total.dtype == torch.int32
    macro = mt_torch.Precision(num_classes=C, average="macro", device="cpu")
    assert macro.tp.dtype == torch.int32 and macro.tp.shape == (C,)


def test_inputs_on_another_device_raise():
    metric = mt_torch.Accuracy(device="cpu")
    with pytest.raises(ValueError, match="lies on meta"):
        metric.update(torch.zeros(4, device="meta"), torch.zeros(4, dtype=torch.int64, device="meta"))


def test_invalid_inputs_raise_like_the_jax_package():
    rng = np.random.default_rng(24)
    preds, target = _probs(rng, N, C), _labels(rng, N)
    target[0] = C  # a label outside the class dimension
    for update, lib in ((jax_update, jnp.asarray), (torch_update, torch.from_numpy)):
        with pytest.raises(ValueError, match="label >="):
            update(lib(preds), lib(target), reduce="micro")
