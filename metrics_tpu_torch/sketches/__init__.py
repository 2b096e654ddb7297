"""Mergeable sketches: fixed-size approximate state for unbounded streams
(counterpart of ``metrics_tpu/sketches``).

Each sketch is a bundle of tensors whose ``merge`` is a commutative
elementwise monoid. The ``"sketch"`` reduction tag of
:meth:`~metrics_tpu_torch.Metric.add_state` dispatches to it, and
:mod:`metrics_tpu_torch.parallel.sync` splits sketch leaves into their
components so they ride the existing ``(reduction, dtype)`` buckets.
"""
from metrics_tpu_torch.sketches.base import SKETCH_CLASSES, MergeableSketch, is_sketch, register_sketch
from metrics_tpu_torch.sketches.countmin import CountMinSketch, DyadicCountMinSketch
from metrics_tpu_torch.sketches.hll import HyperLogLogSketch
from metrics_tpu_torch.sketches.quantile import QuantileSketch

__all__ = [
    "MergeableSketch",
    "register_sketch",
    "is_sketch",
    "SKETCH_CLASSES",
    "QuantileSketch",
    "HyperLogLogSketch",
    "CountMinSketch",
    "DyadicCountMinSketch",
]
