"""MeanAveragePrecision's dense update through the compiled engine, against
the JAX package's compiled update (``metrics_tpu/detection/mean_ap.py``).

Both take COCO list-of-dicts batches, pad them eagerly and hand the dense
padded form to the engine (``_engine_accepts``); at the JAX package's mAP
defaults (``batch_buckets=True``, ``compiled_compute=False``) a ragged image
batch splits into power-of-two chunks. The port's steps run on the card's
replay path on the CPU (``use_card_replay_path``): the replay appends into
the static buffers in place. Buffer rows, counts and flags, the engine
counters and partitions, and the results are compared bit for bit.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt_jax
import metrics_tpu_torch as mt_torch
from metrics_tpu.utils.exceptions import MetricsUserError as JaxUserError
from metrics_tpu_torch.utils.exceptions import MetricsUserError
from tests.helpers import torch_parity as hp
from tests.helpers.torch_port import coco_dataset, use_card_replay_path

COUNTERS = ("eager_calls", "cache_misses", "cache_hits", "donated_calls", "bucketed_calls")


@pytest.fixture(autouse=True)
def _engines_at_defaults(monkeypatch):
    for pkg in (mt_jax, mt_torch):
        pkg.set_compiled_update(None)
        pkg.set_compiled_compute(None)
    use_card_replay_path(monkeypatch)


def _batches(seed, sizes):
    rng = np.random.default_rng(seed)
    return [coco_dataset(rng, n, n_classes=3) for n in sizes]


def _feed(sizes, seed, capacity):
    ref = mt_jax.MeanAveragePrecision(class_metrics=True, buffer_capacity=capacity)
    port = mt_torch.MeanAveragePrecision(class_metrics=True, buffer_capacity=capacity, device="cpu")
    warned = []
    for preds, targets in _batches(seed, sizes):
        jax_in = [[{k: jnp.asarray(v) for k, v in d.items()} for d in side] for side in (preds, targets)]
        torch_in = [[{k: torch.from_numpy(np.array(v)) for k, v in d.items()} for d in side] for side in (preds, targets)]
        flags = []
        for metric, args in ((ref, jax_in), (port, torch_in)):
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                metric.update(*args)
            flags.append(any("overflowed" in str(w.message) for w in rec))
        assert flags[0] == flags[1]
        warned.append(flags[1])
    return ref, port, warned


def test_dense_update_is_captured_as_the_jax_engine_compiles_it():
    # 8-image batches replay one captured step; the ragged 5 splits into 4 + 1
    ref, port, warned = _feed((8, 8, 8, 8, 5, 8), seed=31, capacity=64)
    assert not any(warned)
    assert hp.partition(port) == hp.partition(ref) == {
        "update": ("bucketed", "batch_buckets=True (pow2-bucketed per-metric engine)"),
        "compute": ("eager", "compiled_compute=False"),
    }
    stats, jstats = port.engine_stats()["update"], ref.engine_stats()["update"]
    assert {k: getattr(stats, k) for k in COUNTERS} == {k: getattr(jstats, k) for k in COUNTERS}
    assert stats.cache_hits >= 3
    hp.assert_same_states(ref, port, "mAP")
    hp.assert_same_result("MeanAveragePrecision", port.compute(), ref.compute(), bitwise=True)


def test_captured_results_equal_the_eager_update():
    batches = _batches(32, (8, 8, 8, 3))
    compiled = mt_torch.MeanAveragePrecision(class_metrics=True, buffer_capacity=32, device="cpu")
    eager = mt_torch.MeanAveragePrecision(class_metrics=True, buffer_capacity=32, device="cpu", compiled_update=False)
    for preds, targets in batches:
        for metric in (compiled, eager):
            metric.update(*[[{k: torch.from_numpy(np.array(v)) for k, v in d.items()} for d in side]
                             for side in (preds, targets)])
    assert compiled.engine_stats()["update"].cache_hits >= 1
    assert eager.engine_stats()["update"] is None
    for name in compiled._defaults:
        a, b = getattr(compiled, name), getattr(eager, name)
        assert len(a) == len(b) == 27
        assert torch.equal(a.to_array(), b.to_array()), name
    hp.assert_same_result("MeanAveragePrecision", compiled.compute(), eager.compute(), bitwise=True)


def test_an_overflowing_capture_warns_once_and_compute_raises_the_jax_text():
    # capacity 16: calls 1 (eager) and 2 (probe) fill it, call 3 replays past it
    ref, port, warned = _feed((8, 8, 8, 8), seed=33, capacity=16)
    assert warned == [False, False, True, False]
    assert len(port.det_boxes) == 32 and port.det_boxes.capacity == 16
    hp.assert_same_states(ref, port, "mAP")
    with pytest.raises(JaxUserError) as want:
        ref.compute()
    with pytest.raises(MetricsUserError) as got:
        port.compute()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("args,kwargs", [
    (([{}], [{}]), {}),  # list-of-dicts: padded first, then handed back
    (({"boxes": 0, "count": 0}, {"boxes": 0, "count": 0}), {"extra": 1}),
    (({"boxes": 0, "count": 0},), {}),
    (({"boxes": 0}, {"boxes": 0, "count": 0}), {}),
])
def test_the_engine_gate_declines_what_the_jax_gate_declines(args, kwargs):
    ref = mt_jax.MeanAveragePrecision()
    port = mt_torch.MeanAveragePrecision(device="cpu")
    assert not port._engine_accepts(args, kwargs)
    assert ref._engine_accepts(args, kwargs) == port._engine_accepts(args, kwargs)
    dense = ({"boxes": 0, "count": 0}, {"boxes": 0, "count": 0})
    assert port._engine_accepts(dense, {}) and ref._engine_accepts(dense, {})
