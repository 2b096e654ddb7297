"""The port's heavy-kernel registry and dispatch telemetry against the JAX package's.

``metrics_tpu_torch.ops.kernels`` keeps the JAX package's ``KERNELS`` spec
registry, its series (``metrics_tpu_heavy_kernel_calls{kernel,impl}``, the
``..._bucket_width`` histogram, ``..._fallbacks``), its ``kernel/dispatch``
and ``kernel/fallback`` events and its trace counts. The same inputs, made
from a seed with numpy, go through both packages on the CPU: the JAX wrappers
on their jit reference (``use_pallas="never"``, ``impl="jit"``), the port's
on the plain versions (``impl="torch"``); the series, the events and the
trace counts must be equal with ``jit`` read as ``torch``. The JAX jit
caches of the two kernels are cleared first, so that its trace counts start
from nothing, as the port's do after ``reset_trace_counts``.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu import observability as jobs
from metrics_tpu.observability import instruments as jinst
from metrics_tpu.ops import kernels as JK
from metrics_tpu.ops.kernels import cosine_matching as jcm
from metrics_tpu.ops.kernels import iou_matching as jim
from metrics_tpu_torch import observability as tobs
from metrics_tpu_torch.observability import instruments as tinst
from metrics_tpu_torch.ops import kernels as TK
from metrics_tpu_torch.parallel import sync as port_sync
from tests.helpers.torch_port import assert_bitwise, one_torch_thread  # noqa: F401  (the module fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

_CLASS_IDS = np.array([0, 1, 2, 0], np.int32)
_CLASS_MASK = np.array([True, True, True, False])
_AREA_RANGES = np.array([[0.0, 1e10], [0.0, 1024.0], [1024.0, 9216.0], [9216.0, 1e10]], np.float32)
_THRESHOLDS = np.linspace(0.5, 0.95, 10).astype(np.float32)


def _images(seed, n_images, pad_det, pad_gt=8):
    """pow2-padded ragged detection and ground-truth buffers and counts."""
    rng = np.random.default_rng(seed)

    def boxes(n, pad):
        xy = rng.uniform(0, 80, size=(pad, 2)).astype(np.float32)
        wh = rng.uniform(1, 40, size=(pad, 2)).astype(np.float32)
        out = np.concatenate([xy, xy + wh], axis=1)
        out[n:] = 0.0
        return out

    cols = {k: [] for k in ("det_boxes", "det_scores", "det_labels", "det_counts", "gt_boxes", "gt_labels", "gt_counts")}
    for _ in range(n_images):
        nd, ng = int(rng.integers(0, pad_det + 1)), int(rng.integers(0, pad_gt + 1))
        scores = rng.uniform(0, 1, size=pad_det).astype(np.float32)
        scores[nd:] = 0.0
        labels = rng.integers(0, 3, size=pad_det).astype(np.int32)
        labels[nd:] = -1
        glabels = rng.integers(0, 3, size=pad_gt).astype(np.int32)
        glabels[ng:] = -1
        for key, value in (("det_boxes", boxes(nd, pad_det)), ("det_scores", scores), ("det_labels", labels),
                           ("det_counts", nd), ("gt_boxes", boxes(ng, pad_gt)), ("gt_labels", glabels),
                           ("gt_counts", ng)):
            cols[key].append(value)
    out = {k: np.stack(v) if k not in ("det_counts", "gt_counts") else np.asarray(v, np.int32) for k, v in cols.items()}
    return {**out, "class_ids": _CLASS_IDS, "class_mask": _CLASS_MASK, "area_ranges": _AREA_RANGES,
            "thresholds": _THRESHOLDS}


def _embeddings(seed, b, p, r, d=16):
    rng = np.random.default_rng(seed)

    def unit(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)

    return (unit(b, 1, p, d), unit(b, 1, r, d), np.full((b, p), 1.0 / p, np.float32),
            np.full((b, r), 1.0 / r, np.float32))


# the shape sequences: repeats count once, a new width (or batch) once more
IOU_SEQUENCE = [(0, 4, 16), (1, 4, 16), (2, 2, 16), (3, 4, 32), (4, 4, 16)]
COSINE_SEQUENCE = [(0, 3, 8, 8), (1, 3, 8, 8), (2, 3, 16, 8), (3, 2, 8, 8)]
FEATURE_ROWS = [5, 4, 3, 8, 5, 1]


def _run_jax():
    jim._evaluate_padded.clear_cache()
    jcm._pr_f1_reference.clear_cache()
    JK.reset_trace_counts()
    for seed, n, pad in IOU_SEQUENCE:
        JK.evaluate_matches(**{k: jnp.asarray(v) for k, v in _images(seed, n, pad).items()}, max_det=100,
                            use_pallas="never")
    for seed, b, p, r in COSINE_SEQUENCE:
        JK.pairwise_cosine_pr(*map(jnp.asarray, _embeddings(seed, b, p, r)), use_pallas="never")
    fn = JK.maybe_bucketed(lambda x: x.reshape(x.shape[0], -1).sum(1), True)
    for n in FEATURE_ROWS:
        fn(jnp.ones((n, 2, 3), jnp.float32))
    return JK.trace_counts()


def _run_port():
    TK.reset_trace_counts()
    for seed, n, pad in IOU_SEQUENCE:
        TK.evaluate_matches(**{k: torch.from_numpy(v) for k, v in _images(seed, n, pad).items()}, max_det=100)
    for seed, b, p, r in COSINE_SEQUENCE:
        TK.pairwise_cosine_pr(*map(torch.from_numpy, _embeddings(seed, b, p, r)))
    fn = TK.maybe_bucketed(lambda x: x.reshape(x.shape[0], -1).sum(1), True)
    for n in FEATURE_ROWS:
        fn(torch.ones((n, 2, 3), dtype=torch.float32))
    return TK.trace_counts()


def _series(inst):
    """The heavy-kernel samples: (name, labels, value), ``jit`` read as ``torch``."""
    out = []
    for s in inst.REGISTRY.samples():
        if s.name.startswith("metrics_tpu_heavy_kernel"):
            labels = {k: ("torch" if (k, v) == ("impl", "jit") else v) for k, v in s.labels.items()}
            out.append((s.name, tuple(sorted(labels.items())), s.value))
    return sorted(out)


@pytest.fixture(scope="module")
def runs():
    """The same sequence through both packages under their tracers, each
    registry cleared first: (trace counts, series, dispatch events)."""
    out = {}
    for name, obs, inst, run in (("jax", jobs, jinst, _run_jax), ("torch", tobs, tinst, _run_port)):
        inst.REGISTRY.clear()
        with obs.trace() as tracer:
            counts = run()
        events = [(e.name, {k: ("torch" if (k, v) == ("impl", "jit") else v) for k, v in e.args.items()})
                  for e in tracer.events() if e.cat == "kernel"]
        out[name] = (counts, _series(inst), events)
        inst.REGISTRY.clear()
    return out


def test_kernel_specs_equal_the_jax_registry():
    assert list(TK.KERNELS) == list(JK.KERNELS) == ["iou_matching", "cosine_matching", "feature_extract"]
    assert [f.name for f in dataclasses.fields(TK.KernelSpec)] == [f.name for f in dataclasses.fields(JK.KernelSpec)]
    for name, spec in TK.KERNELS.items():
        want = JK.KERNELS[name]
        assert spec.name == name and spec.description == want.description and spec.pallas_scope
        assert spec.module == want.module.replace("metrics_tpu.", "metrics_tpu_torch.", 1)
        assert importlib.import_module(spec.module) is not None
    # the CUDA loader's entries are CUDA_KERNELS: the same five, none in KERNELS
    assert set(TK.CUDA_KERNELS) == {"binned_counts", "binned_counts_batched", "pairwise_iou", "greedy_match",
                                    "maxsim_tf32x3"}
    assert set(TK.launch_counts()) == set(TK.CUDA_KERNELS)


def test_trace_counts_equal_the_jax_packages(runs):
    assert runs["torch"][0] == runs["jax"][0] == {"iou_matching": 3, "cosine_matching": 3}


def test_series_equal_the_jax_packages(runs):
    got, want = runs["torch"][1], runs["jax"][1]
    assert got == want
    calls = {dict(labels)["kernel"]: value for name, labels, value in got if name == "metrics_tpu_heavy_kernel_calls"}
    assert calls == {"iou_matching": 5.0, "cosine_matching": 4.0, "feature_extract": 6.0}
    assert not [s for s in got if s[0] == "metrics_tpu_heavy_kernel_fallbacks"]


def test_dispatch_events_equal_the_jax_packages(runs):
    got, want = runs["torch"][2], runs["jax"][2]
    assert got == want
    assert [e for e, _ in got] == ["kernel/dispatch"] * 15
    assert got[0][1] == {"kernel": "iou_matching", "impl": "torch", "bucket_width": 16}


def test_prometheus_exposition_of_the_series_equals_the_jax_packages():
    texts = {}
    for name, obs, inst, module in (("jax", jobs, jinst, JK), ("torch", tobs, tinst, TK)):
        inst.REGISTRY.clear()
        module.record_dispatch("iou_matching", "torch", bucket_width=64)
        module.record_dispatch("feature_extract", "torch", bucket_width=100_000)
        module.record_fallback("cosine_matching", "synthetic: exposition test\nsecond line")
        texts[name] = [line for line in obs.to_prometheus_text(inst.REGISTRY).splitlines() if "heavy_kernel" in line]
        inst.REGISTRY.clear()
    assert texts["torch"] == texts["jax"] and texts["torch"]


def test_fallback_event_equals_the_jax_packages():
    events = {}
    for name, obs, module in (("jax", jobs, JK), ("torch", tobs, TK)):
        with obs.trace() as tracer:
            module.record_fallback("iou_matching", "synthetic: a\nb")
        events[name] = [(e.name, e.cat, e.args) for e in tracer.events()]
    assert events["torch"] == events["jax"] == [("kernel/fallback", "kernel", {"kernel": "iou_matching",
                                                                              "reason": "synthetic: a"})]


@pytest.mark.parametrize("mode", ["never", "force", "auto"])
@pytest.mark.parametrize("traced", [False, True])
def test_resolve_use_pallas_modes(mode, traced, monkeypatch):
    monkeypatch.delenv("METRICS_TPU_PALLAS", raising=False)
    use, interpret = JK.resolve_use_pallas(mode, traced=traced)
    # interpret mode has no CUDA counterpart: the port answers False for it
    assert TK.resolve_use_pallas(mode, traced=traced) == (use, False)
    # the port reads no environment variable
    monkeypatch.setenv("METRICS_TPU_PALLAS", "force")
    assert TK.resolve_use_pallas(mode, traced=traced) == (use, False)


def test_resolve_use_pallas_refuses_unknown_modes():
    for module in (JK, TK):
        with pytest.raises(ValueError, match="use_pallas must be"):
            module.resolve_use_pallas("sometimes")


def test_trace_counts_reset_and_explicit_bumps():
    TK.reset_trace_counts()
    TK.bump_trace_count("x")
    TK.bump_trace_count("x")
    TK.bump_trace_count("y", (torch.zeros(3), 7))
    TK.bump_trace_count("y", (torch.ones(3), 7))  # the same signature: values do not count
    TK.bump_trace_count("y", (torch.zeros(4), 7))
    TK.bump_trace_count("y", (torch.zeros(4), 8))
    assert TK.trace_counts() == {"x": 2, "y": 3}
    TK.reset_trace_counts()
    assert TK.trace_counts() == {}
    TK.bump_trace_count("y", (torch.zeros(3), 7))
    assert TK.trace_counts() == {"y": 1}
    TK.reset_trace_counts()


def test_quiet_runs_record_nothing():
    """A capture's second run and the CPU's stand-in for a replay run the
    wrappers quiet: no dispatch, no event, no trace count (the launch
    counters are the wrappers' own business)."""
    tinst.REGISTRY.clear()
    TK.reset_trace_counts()
    batch = {k: torch.from_numpy(v) for k, v in _images(5, 2, 8).items()}
    with tobs.trace() as tracer:
        with port_sync._quiet():
            quiet = TK.evaluate_matches(**batch, max_det=100)
            TK.pairwise_cosine_pr(*map(torch.from_numpy, _embeddings(6, 2, 4, 4)))
            TK.maybe_bucketed(lambda x: x * 2, True)(torch.ones(3))
        assert not [e for e in tracer.events() if e.cat == "kernel"] and not _series(tinst)
        assert TK.trace_counts() == {}
        loud = TK.evaluate_matches(**batch, max_det=100)
    for key in quiet:
        assert_bitwise(quiet[key], loud[key], msg=key)
    assert TK.trace_counts() == {"iou_matching": 1}
    assert [e.args["impl"] for e in tracer.events() if e.cat == "kernel"] == ["torch"]
    tinst.REGISTRY.clear()


def test_feature_counts_are_a_view_of_the_series():
    from metrics_tpu_torch.ops.kernels import features as feats

    feats.reset_feature_extract_counts()
    fn = TK.maybe_bucketed(lambda x: x.sum(1), True)
    for n in (5, 4, 3):
        fn(torch.ones((n, 2)))
    assert feats.feature_extract_counts() == {"forwards": 3, "widths": {4: 2, 8: 1}}
    tinst.REGISTRY.clear()  # the registry dropped: counted from nothing again
    fn(torch.ones((2, 2)))
    assert feats.feature_extract_counts() == {"forwards": 1, "widths": {2: 1}}
    feats.reset_feature_extract_counts()
    assert feats.feature_extract_counts() == {"forwards": 0, "widths": {}}


def test_map_compute_dispatches_once_a_chunk_and_retraces_nothing():
    """The JAX recompile guard on the port: a second compute of the same
    buffers adds dispatches, one a chunk, and no new signature."""
    import metrics_tpu_torch as mt

    rng = np.random.default_rng(7)
    metric = mt.MeanAveragePrecision(device="cpu")
    for n in (3, 5, 2):
        preds, target = [], []
        for _ in range(n):
            nd, ng = int(rng.integers(1, 6)), int(rng.integers(1, 4))
            xy = rng.uniform(0, 60, size=(nd + ng, 2)).astype(np.float32)
            boxes = np.concatenate([xy, xy + rng.uniform(1, 30, size=(nd + ng, 2)).astype(np.float32)], axis=1)
            preds.append({"boxes": torch.from_numpy(boxes[:nd]), "scores": torch.from_numpy(
                rng.uniform(0, 1, nd).astype(np.float32)), "labels": torch.from_numpy(
                rng.integers(0, 3, nd).astype(np.int32))})
            target.append({"boxes": torch.from_numpy(boxes[nd:]),
                           "labels": torch.from_numpy(rng.integers(0, 3, ng).astype(np.int32))})
        metric.update(preds, target)
    tinst.REGISTRY.clear()
    TK.reset_trace_counts()
    metric.compute()
    first = TK.trace_counts()["iou_matching"]
    metric._computed = None
    metric.compute()
    assert TK.trace_counts()["iou_matching"] == first == 1
    calls = [s.value for s in tinst.REGISTRY.samples() if s.name == "metrics_tpu_heavy_kernel_calls"]
    assert calls == [2.0]
    tinst.REGISTRY.clear()
