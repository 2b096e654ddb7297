"""Binned threshold counts: the port's plain version against the JAX package.

``metrics_tpu_torch.ops.classification.binned_counts`` holds the wrapper of
the CUDA kernel and its plain PyTorch version; on CPU tensors the wrapper runs
the plain version, which must equal, bit for bit, both the JAX Pallas kernel
(``use_pallas="force"``, run by the Pallas interpreter on this host, as
tests/classification/test_binned_pallas.py runs it) and the JAX bucketize
path (``use_pallas="never"``). The kernel itself is held against the plain
version on the card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.ops.classification.binned_pallas import _binned_counts_broadcast, binned_stat_counts
from metrics_tpu_torch.ops.classification.binned_counts import (
    KERNEL,
    binned_counts,
    binned_counts_plain,
    sort_thresholds,
)
from tests.helpers.torch_port import assert_bitwise, strict_float32

strict_float32()


def _inputs(seed, n, c):
    rng = np.random.default_rng(seed)
    preds = rng.uniform(size=(n, c)).astype(np.float32)
    target = rng.integers(0, 2, size=(n, c)).astype(bool)
    return preds, target


def _jax_counts(preds, target, thresholds, use_pallas):
    return binned_stat_counts(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(thresholds), use_pallas=use_pallas)


def _port_counts(preds, target, thresholds):
    return binned_counts(torch.from_numpy(preds), torch.from_numpy(target), sort_thresholds(torch.from_numpy(thresholds)))


def _assert_counts_equal(got, want, columns=slice(None)):
    for g, w, name in zip(got, want, ("TP", "FP", "FN")):
        assert_bitwise(g[:, columns], np.asarray(w)[:, columns], msg=name)


@pytest.mark.parametrize("use_pallas", ["force", "never"])
@pytest.mark.parametrize(
    "n,c,t",
    [(64, 3, 11), (300, 1, 100), (513, 5, 50), (7, 2, 1), (257, 7, 21), (1, 3, 5), (1030, 4, 100)],
)
def test_random_grids_bitwise(n, c, t, use_pallas):
    """n is never a multiple of the Pallas block (256): the padded tail is covered."""
    preds, target = _inputs(n * 1000 + c * 10 + t, n, c)
    thresholds = np.linspace(0.0, 1.0, t).astype(np.float32)
    _assert_counts_equal(_port_counts(preds, target, thresholds), _jax_counts(preds, target, thresholds, use_pallas))


@pytest.mark.parametrize("use_pallas", ["force", "never"])
def test_nan_scores_count_as_negative(use_pallas):
    preds, target = _inputs(1, 90, 3)
    preds[::7, 0] = np.nan
    preds[3, :] = np.nan
    thresholds = np.linspace(0.0, 1.0, 13).astype(np.float32)
    _assert_counts_equal(_port_counts(preds, target, thresholds), _jax_counts(preds, target, thresholds, use_pallas))


@pytest.mark.parametrize("use_pallas", ["force", "never"])
def test_unsorted_and_tied_thresholds(use_pallas):
    preds = np.asarray([[0.0], [0.5], [0.5], [1.0], [0.25], [0.75]], dtype=np.float32)
    target = np.asarray([[1], [1], [0], [1], [0], [1]]).astype(bool)
    thresholds = np.asarray([0.5, 0.0, 1.0, 0.5, 0.25, 0.75, 0.25], dtype=np.float32)
    _assert_counts_equal(_port_counts(preds, target, thresholds), _jax_counts(preds, target, thresholds, use_pallas))


@pytest.mark.parametrize("use_pallas", ["force", "never"])
def test_scores_on_thresholds_count_as_positive(use_pallas):
    """``score >= threshold``: a score equal to a threshold is predicted positive."""
    grid = np.linspace(0.0, 1.0, 21).astype(np.float32)
    preds = np.stack([grid, grid[::-1], np.roll(grid, 3)], axis=1)
    target = np.random.default_rng(2).integers(0, 2, size=preds.shape).astype(bool)
    _assert_counts_equal(_port_counts(preds, target, grid), _jax_counts(preds, target, grid, use_pallas))


def test_out_of_range_thresholds():
    preds, target = _inputs(3, 100, 2)
    thresholds = np.asarray([-np.inf, -0.5, 0.5, 1.5, np.inf], dtype=np.float32)
    got = _port_counts(preds, target, thresholds)
    _assert_counts_equal(got, _jax_counts(preds, target, thresholds, "never"))
    broadcast = _binned_counts_broadcast(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(thresholds))
    _assert_counts_equal(got, [np.asarray(x).astype(np.float32) for x in broadcast])  # int32 counts there
    # the Pallas kernel pads the last block with -inf scores, which count as
    # false positives at a -inf threshold; every other column agrees
    _assert_counts_equal(got, _jax_counts(preds, target, thresholds, "force"), columns=slice(1, None))


@pytest.mark.parametrize("use_pallas", ["force", "never"])
def test_empty_batch_gives_zeros(use_pallas):
    preds = np.zeros((0, 3), np.float32)
    target = np.zeros((0, 3), bool)
    thresholds = np.linspace(0.0, 1.0, 5).astype(np.float32)
    got = _port_counts(preds, target, thresholds)
    for g in got:
        assert_bitwise(g, np.zeros((3, 5), np.float32))
    _assert_counts_equal(got, _jax_counts(preds, target, thresholds, use_pallas))


def test_wrapper_on_cpu_is_the_plain_version():
    preds, target = _inputs(4, 77, 6)
    thresholds = np.random.default_rng(4).uniform(-0.2, 1.2, size=17).astype(np.float32)
    tp, tt, th = torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(thresholds)
    for a, b in zip(binned_counts(tp, tt, sort_thresholds(th)), binned_counts_plain(tp, tt, th)):
        assert_bitwise(a, b)
    # the uint8 target layout the kernel also takes gives the same counts
    for a, b in zip(binned_counts(tp, tt.to(torch.uint8), sort_thresholds(th)), binned_counts_plain(tp, tt, th)):
        assert_bitwise(a, b)


def test_sort_thresholds_keeps_the_permutation():
    thresholds = torch.tensor([0.5, 0.0, 1.0, 0.5, 0.25])
    grid = sort_thresholds(thresholds)
    assert grid.values.dtype == torch.float32 and grid.order.dtype == torch.int32
    assert torch.equal(grid.values, torch.tensor([0.0, 0.25, 0.5, 0.5, 1.0]))
    assert torch.equal(thresholds[grid.order.long()], grid.values)


def test_wrapper_rejects_other_devices_and_shapes():
    grid = sort_thresholds(torch.linspace(0, 1, 5))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        binned_counts(torch.zeros((4, 2), device="meta"), torch.zeros((4, 2), dtype=torch.bool, device="meta"), grid)
    with pytest.raises(ValueError, match=r"\(N, C\)"):
        binned_counts(torch.zeros(4), torch.zeros(4, dtype=torch.bool), grid)


def test_cpu_path_builds_and_launches_nothing():
    preds, target = _inputs(5, 40, 3)
    before = KERNEL.launches
    _port_counts(preds, target, np.linspace(0, 1, 9).astype(np.float32))
    assert KERNEL.launches == before
    assert KERNEL._lib is None


# --------------------------------------------------------------------------- #
# the label form: (N,) class labels standing for their one-hot
# --------------------------------------------------------------------------- #
def _labels(seed, n, c, low=0, high=None):
    """Labels in [low, high) (default [0, C)); -1 and C are out of range."""
    return np.random.default_rng(seed).integers(low, c if high is None else high, size=n)


@pytest.mark.parametrize("use_pallas", ["force", "never"])
@pytest.mark.parametrize("label_dtype", [np.int32, np.int64])
@pytest.mark.parametrize(
    "n,c,t,low,high",
    [(64, 3, 11, 0, None), (300, 1, 100, -1, 2), (513, 5, 50, -1, 6), (257, 7, 21, -3, 10), (1030, 12, 100, 0, None)],
)
def test_label_form_matches_the_one_hot_of_the_jax_package(n, c, t, low, high, label_dtype, use_pallas):
    """The plain label form against ``binned_stat_counts`` on
    ``to_onehot(labels) == 1``, as the JAX metric forms its target; labels
    outside [0, C), negatives included, give all-negative rows."""
    from metrics_tpu.utils.data import to_onehot as jax_to_onehot

    preds, _ = _inputs(n * 1000 + c * 10 + t + 7, n, c)
    labels = _labels(n + c + t, n, c, low, high).astype(label_dtype)
    thresholds = np.linspace(0.0, 1.0, t).astype(np.float32)
    onehot = jax_to_onehot(jnp.asarray(labels), num_classes=c) == 1
    want = binned_stat_counts(jnp.asarray(preds), onehot, jnp.asarray(thresholds), use_pallas=use_pallas)
    got = binned_counts(torch.from_numpy(preds), torch.from_numpy(labels), sort_thresholds(torch.from_numpy(thresholds)))
    _assert_counts_equal(got, want)
    for a, b in zip(binned_counts_plain(torch.from_numpy(preds), torch.from_numpy(labels), torch.from_numpy(thresholds)), got):
        assert_bitwise(a, b)


@pytest.mark.parametrize("label_dtype", [torch.int32, torch.int64])
def test_label_form_equals_the_dense_form_of_its_one_hot(label_dtype):
    preds, _ = _inputs(21, 400, 9)
    labels = torch.from_numpy(_labels(22, 400, 9, -2, 12)).to(label_dtype)
    labels[::17] += 2**31 - 1 if label_dtype == torch.int32 else 2**40  # far out of range
    thresholds = torch.from_numpy(np.random.default_rng(23).uniform(-0.1, 1.1, size=33).astype(np.float32))
    dense = labels[:, None] == torch.arange(9, dtype=label_dtype)
    p, grid = torch.from_numpy(preds), sort_thresholds(thresholds)
    for a, b in zip(binned_counts(p, labels, grid), binned_counts(p, dense, grid)):
        assert_bitwise(a, b)


def test_label_form_nan_scores_and_empty_batch():
    preds, _ = _inputs(31, 90, 4)
    preds[::5, 1] = np.nan
    labels = torch.from_numpy(_labels(32, 90, 4, -1, 5))
    thresholds = np.linspace(0.0, 1.0, 13).astype(np.float32)
    onehot = (labels[:, None] == torch.arange(4)).numpy()
    _assert_counts_equal(_port_counts(preds, onehot, thresholds), _jax_counts(preds, onehot, thresholds, "never"))
    got = binned_counts(torch.from_numpy(preds), labels, sort_thresholds(torch.from_numpy(thresholds)))
    _assert_counts_equal(got, _jax_counts(preds, onehot, thresholds, "never"))
    empty = binned_counts(torch.zeros((0, 4)), torch.zeros(0, dtype=torch.int64), sort_thresholds(torch.from_numpy(thresholds)))
    for g in empty:
        assert_bitwise(g, np.zeros((4, 13), np.float32))


def test_wrapper_rejects_labels_of_another_length():
    grid = sort_thresholds(torch.linspace(0, 1, 5))
    with pytest.raises(ValueError, match=r"\(N,\) labels"):
        binned_counts(torch.zeros((4, 3)), torch.zeros(5, dtype=torch.int64), grid)
    with pytest.raises(ValueError, match=r"\(N,\) labels"):
        binned_counts(torch.zeros((4, 3)), torch.zeros((4, 2), dtype=torch.bool), grid)
