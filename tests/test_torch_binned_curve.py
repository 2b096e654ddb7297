"""The binned PR-curve family: the port against the JAX package.

``BinnedPrecisionRecallCurve``, ``BinnedAveragePrecision`` and
``BinnedRecallAtFixedPrecision`` take the same seeded batches in both
packages. Their (C, T) float32 count states must match bit for bit; compute
results agree within rtol=1e-6, atol=1e-7, since the port integrates all
classes in one batched sum whose order may differ from the JAX per-class sums.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt_jax
import metrics_tpu_torch as mt_torch
from metrics_tpu.ops.classification.average_precision import (
    _average_precision_compute_with_precision_recall as jax_ap_from_curve,
)
from metrics_tpu_torch.utils.data import linspace_thresholds
from metrics_tpu_torch.ops.classification.average_precision import (
    _average_precision_compute_with_precision_recall as torch_ap_from_curve,
)
from tests.helpers.torch_port import assert_bitwise, assert_close, strict_float32

strict_float32()

N = 83


@pytest.mark.parametrize("num", [1, 2, 5, 21, 42, 48, 100, 101, 1000, 4097])
def test_linspace_thresholds_match_jnp_linspace(num):
    """Any one-ulp difference would move scores between buckets."""
    assert_bitwise(linspace_thresholds(num), jnp.linspace(0, 1.0, num))


def test_default_grid_is_jnp_linspace_across_t():
    # includes T where a plain `arange * step` misses the exact 1.0 endpoint
    for num in [*range(2, 40, 3), 42, 48, 56, 62, 83, 84, 95, 98, 108, 110, 111, 116, 122]:
        got = mt_torch.BinnedPrecisionRecallCurve(num_classes=1, thresholds=num, device="cpu").thresholds
        assert_bitwise(got, mt_jax.BinnedPrecisionRecallCurve(num_classes=1, thresholds=num).thresholds, msg=str(num))


def _batches(seed, num_classes, layout, n_batches=3):
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        if layout == "binary":
            yield rng.uniform(size=N).astype(np.float32), rng.integers(0, 2, size=N)
        elif layout == "multiclass":
            logits = rng.normal(size=(N, num_classes)).astype(np.float32)
            probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
            yield probs, rng.integers(0, num_classes, size=N)
        else:  # multilabel
            yield rng.uniform(size=(N, num_classes)).astype(np.float32), rng.integers(0, 2, size=(N, num_classes))


THRESHOLDS = {
    "int": (21, 21),
    "list": ([0.9, 0.1, 0.5, 0.5, 0.0, 1.0, 0.33], [0.9, 0.1, 0.5, 0.5, 0.0, 1.0, 0.33]),
    "tensor": (
        jnp.asarray(np.linspace(-0.1, 1.1, 15).astype(np.float32)),
        torch.from_numpy(np.linspace(-0.1, 1.1, 15).astype(np.float32)),
    ),
}
LAYOUTS = [("binary", 1), ("multiclass", 6), ("multilabel", 4)]


def _run_pair(name, layout, num_classes, thresholds, **kwargs):
    jax_thr, torch_thr = THRESHOLDS[thresholds]
    # the JAX reference eager: its engines would compile each instance anew
    jax_metric = getattr(mt_jax, name)(num_classes=num_classes, thresholds=jax_thr, compiled_update=False,
                                       compiled_compute=False, **kwargs)
    torch_metric = getattr(mt_torch, name)(num_classes=num_classes, thresholds=torch_thr, device="cpu", **kwargs)
    for preds, target in _batches(len(name) + num_classes, num_classes, layout):
        jax_metric.update(jnp.asarray(preds), jnp.asarray(target))
        torch_metric.update(torch.from_numpy(preds), torch.from_numpy(target))
    for state in ("TPs", "FPs", "FNs"):
        assert_bitwise(getattr(torch_metric, state), getattr(jax_metric, state), msg=state)
    return torch_metric.compute(), jax_metric.compute()


def _stack(x):
    if isinstance(x, list):
        return np.stack([np.asarray(v) for v in x])
    return np.asarray(x)


@pytest.mark.parametrize("thresholds", sorted(THRESHOLDS))
@pytest.mark.parametrize("layout,num_classes", LAYOUTS)
def test_binned_pr_curve(layout, num_classes, thresholds):
    got, want = _run_pair("BinnedPrecisionRecallCurve", layout, num_classes, thresholds)
    for g, w, part in zip(got, want, ("precision", "recall", "thresholds")):
        # elementwise float32 ratios: the same operations in the same order
        assert_bitwise(_stack(g), _stack(w), msg=part)


@pytest.mark.parametrize("thresholds", sorted(THRESHOLDS))
@pytest.mark.parametrize("layout,num_classes", LAYOUTS)
def test_binned_average_precision(layout, num_classes, thresholds):
    got, want = _run_pair("BinnedAveragePrecision", layout, num_classes, thresholds)
    assert isinstance(got, list) == isinstance(want, list)
    if isinstance(got, list):
        assert len(got) == len(want) == num_classes and all(g.shape == () for g in got)
    assert_close(_stack(got), _stack(want))


@pytest.mark.parametrize("min_precision", [0.0, 0.3, 0.8, 1.1])
@pytest.mark.parametrize("layout,num_classes", LAYOUTS)
def test_binned_recall_at_fixed_precision(layout, num_classes, min_precision):
    got, want = _run_pair("BinnedRecallAtFixedPrecision", layout, num_classes, "int", min_precision=min_precision)
    for g, w, part in zip(got, want, ("recall", "threshold")):
        assert_bitwise(g, w, msg=part)


@pytest.mark.parametrize("average", ["macro", "weighted", None])
def test_average_precision_from_curve_rows_and_lists(average):
    rng = np.random.default_rng(31)
    c, k = 5, 12
    precision = rng.uniform(size=(c, k)).astype(np.float32)
    recall = np.sort(rng.uniform(size=(c, k)).astype(np.float32), axis=1)[:, ::-1].copy()
    weights = rng.uniform(size=c).astype(np.float32)
    jax_args = ([jnp.asarray(p) for p in precision], [jnp.asarray(r) for r in recall], c, average, jnp.asarray(weights))
    want = _stack(jax_ap_from_curve(*jax_args))
    rows = torch_ap_from_curve(torch.from_numpy(precision), torch.from_numpy(recall), c, average, torch.from_numpy(weights))
    lists = torch_ap_from_curve(
        list(torch.from_numpy(precision)), list(torch.from_numpy(recall)), c, average, torch.from_numpy(weights)
    )
    assert_close(_stack(rows), want)
    assert_close(_stack(lists), want)


def test_ap_is_one_batched_expression_over_all_classes():
    """compute() at C=1000 runs no per-class Python loop: the result is still
    a list of 1000 0-d tensors, as in the JAX package."""
    metric = mt_torch.BinnedAveragePrecision(num_classes=1000, thresholds=5, device="cpu")
    rng = np.random.default_rng(32)
    metric.update(torch.from_numpy(rng.uniform(size=(64, 1000)).astype(np.float32)), torch.from_numpy(rng.integers(0, 1000, 64)))
    ap = metric.compute()
    assert isinstance(ap, list) and len(ap) == 1000 and ap[0].shape == ()


def test_thresholds_must_be_int_list_or_tensor():
    with pytest.raises(ValueError, match="thresholds"):
        mt_torch.BinnedPrecisionRecallCurve(num_classes=2, thresholds=(0.1, 0.2), device="cpu")


@pytest.mark.parametrize("label_dtype", [np.int32, np.int64, np.int16, np.float32])
@pytest.mark.parametrize("name", ["BinnedAveragePrecision", "BinnedPrecisionRecallCurve"])
def test_update_with_labels_matches_the_jax_metric(name, label_dtype):
    """(N, C) scores with (N,) labels, some out of range (-1 and C): the
    port's states, counted from the labels, equal the JAX metric's, counted
    from their one-hot."""
    rng = np.random.default_rng(40)
    num_classes = 6
    jax_metric = getattr(mt_jax, name)(num_classes=num_classes, thresholds=21)
    torch_metric = getattr(mt_torch, name)(num_classes=num_classes, thresholds=21, device="cpu")
    for _ in range(3):
        logits = rng.normal(size=(N, num_classes)).astype(np.float32)
        probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
        labels = rng.integers(-1, num_classes + 1, size=N).astype(label_dtype)
        jax_metric.update(jnp.asarray(probs), jnp.asarray(labels))
        torch_metric.update(torch.from_numpy(probs), torch.from_numpy(labels))
    for state in ("TPs", "FPs", "FNs"):
        assert_bitwise(getattr(torch_metric, state), getattr(jax_metric, state), msg=state)


def test_update_hands_labels_to_the_kernel_wrapper(monkeypatch):
    """No one-hot is built: binned_counts receives the (N,) labels as they are
    (int64 here), and the dense forms keep their (N, C) bool target."""
    from metrics_tpu_torch.classification import binned_precision_recall as bpr

    seen = []
    real = bpr.binned_counts

    def spy(preds, target, grid, *, plain=False):
        seen.append((tuple(target.shape), target.dtype))
        return real(preds, target, grid, plain=plain)

    monkeypatch.setattr(bpr, "binned_counts", spy)
    metric = mt_torch.BinnedAveragePrecision(num_classes=4, thresholds=5, device="cpu")
    metric.update(torch.rand(10, 4), torch.randint(0, 4, (10,)))
    metric.update(torch.rand(10, 4), torch.randint(0, 2, (10, 4)))
    binary = mt_torch.BinnedAveragePrecision(num_classes=1, thresholds=5, device="cpu")
    binary.update(torch.rand(10), torch.randint(0, 2, (10,)))
    assert seen == [((10,), torch.int64), ((10, 4), torch.bool), ((10, 1), torch.bool)]


def test_update_with_float_labels_that_match_no_class():
    """Float labels match the class they equal, as the one-hot compares them:
    2.5, NaN, -0.5 and C match none."""
    probs = np.random.default_rng(41).uniform(size=(6, 3)).astype(np.float32)
    labels = np.float32([0.0, 2.5, np.nan, 1.0, 3.0, -0.5])
    jax_metric = mt_jax.BinnedPrecisionRecallCurve(num_classes=3, thresholds=11)
    torch_metric = mt_torch.BinnedPrecisionRecallCurve(num_classes=3, thresholds=11, device="cpu")
    jax_metric.update(jnp.asarray(probs), jnp.asarray(labels))
    torch_metric.update(torch.from_numpy(probs), torch.from_numpy(labels))
    for state in ("TPs", "FPs", "FNs"):
        assert_bitwise(getattr(torch_metric, state), getattr(jax_metric, state), msg=state)
    positives = torch_metric.TPs[:, 0] + torch_metric.FNs[:, 0]
    assert positives.tolist() == [1.0, 1.0, 0.0]  # only the labels 0.0 and 1.0 are positives


@pytest.mark.parametrize("columns", [1, 3, 5])
def test_update_with_labels_refuses_scores_without_num_classes_columns(columns):
    """(N,) labels stand for a (N, num_classes) one-hot, so the scores must
    have num_classes columns; (N, 1) scores would otherwise count class 0 and
    broadcast it into every class's state."""
    metric = mt_torch.BinnedPrecisionRecallCurve(num_classes=4, thresholds=5, device="cpu")
    with pytest.raises(ValueError, match=r"\(N, 4\) scores"):
        metric.update(torch.rand(10, columns), torch.randint(0, 4, (10,)))
    assert not metric.TPs.any() and not metric.FNs.any()
