"""Profiling helpers: ``torch.profiler`` annotations and a compiled-vs-eager
step timer, the **device-side half** of the observability story.

Counterpart of ``metrics_tpu/utils/profiling.py``. Where the JAX package
annotates the device timeline with ``jax.profiler.TraceAnnotation``, the
port uses ``torch.profiler.record_function``: the name shows on the host's
track of a ``torch.profiler`` trace and, on the card, as a
``gpu_user_annotation`` span over the kernels launched inside it. The host
timeline (engine dispatch lifecycle, sync bucket builds) is recorded by
:mod:`metrics_tpu_torch.observability`, whose engines run each dispatch
under a ``record_function`` named ``metrics_tpu/<Owner>.<kind>`` while the
tracer is on and a profiler records, so the two halves line up:
:func:`metrics_tpu_torch.observability.correlate_device_trace` joins a
``torch.profiler`` export with the host tracer's ``dispatch/*`` spans
through those names (built by :func:`dispatch_annotation`, re-exported here
from :mod:`metrics_tpu_torch.observability.shards`, and parsed by
:func:`parse_dispatch_annotation`).

``torch.cuda.synchronize`` takes the place of ``jax.block_until_ready``
wherever a timer needs the card's work finished.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Generator, Optional

import torch

from metrics_tpu_torch.observability.shards import (  # noqa: F401 — the bridge's public home
    ANNOTATION_PREFIX,
    dispatch_annotation,
    parse_dispatch_annotation,
)

_profiler: Optional["torch.profiler.profile"] = None


@contextmanager
def annotate(name: str) -> Generator:
    """Named region in the ``torch.profiler`` timeline.

    Wrap metric updates in eval loops so device traces show which metric a
    kernel belongs to::

        with annotate("metrics/accuracy.update"):
            acc.update(logits, target)
    """
    with torch.profiler.record_function(name):
        yield


def trace_metric(metric: Any, method: str = "update") -> None:
    """Wrap ``metric.update``/``compute`` with a profiler annotation in place."""
    fn: Callable = getattr(metric, method)
    name = f"metrics/{type(metric).__name__}.{method}"

    def wrapped(*args: Any, **kwargs: Any) -> Any:
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    setattr(metric, method, wrapped)


def _wait(metric: Any) -> None:
    """Wait for the card's work on the metric's device (nothing on the CPU)."""
    if metric.device.type == "cuda":
        torch.cuda.synchronize(metric.device)


def _timed_updates(metric: Any, args: tuple, kwargs: dict, steps: int) -> float:
    """Microseconds per ``metric.update`` over ``steps`` calls."""
    _wait(metric)
    t0 = time.perf_counter()
    for _ in range(steps):
        metric.update(*args, **kwargs)
    _wait(metric)
    return (time.perf_counter() - t0) / steps * 1e6


def time_update(
    metric: Any,
    *args: Any,
    steps: int = 100,
    warmup: int = 3,
    **kwargs: Any,
) -> Dict[str, float]:
    """Time the eager ``update`` against the compiled one (a captured CUDA
    graph replayed per call; on the CPU the same step with the checks off)
    for the same inputs.

    Returns ``{"eager_us", "compiled_us", "compile_s", "speedup"}``: the
    per-step microseconds of each path, the one-off warmup-and-capture
    latency (the first two calls of the signature), and their ratio. The
    metric is reset before each path and after; its engine flag is restored.
    """
    saved = metric._compiled_update
    try:
        # compiled path: call 1 of the signature runs eager, call 2 probes and captures
        metric._compiled_update = True
        metric.reset()
        _wait(metric)
        t0 = time.perf_counter()
        for _ in range(2):
            metric.update(*args, **kwargs)
        _wait(metric)
        compile_s = time.perf_counter() - t0
        for _ in range(warmup):
            metric.update(*args, **kwargs)
        compiled_us = _timed_updates(metric, args, kwargs, steps)

        # eager stateful path
        metric._compiled_update = False
        metric.reset()
        for _ in range(warmup):
            metric.update(*args, **kwargs)
        eager_us = _timed_updates(metric, args, kwargs, steps)
    finally:
        metric._compiled_update = saved
        metric.reset()

    return {
        "eager_us": eager_us,
        "compiled_us": compiled_us,
        "compile_s": compile_s,
        "speedup": eager_us / compiled_us if compiled_us > 0 else float("inf"),
    }


def start_trace(log_dir: str, host_tracer_level: Optional[int] = None) -> None:
    """Start a ``torch.profiler`` trace of the host and, where there is one,
    the card; :func:`stop_trace` writes it under ``log_dir`` for TensorBoard's
    profiler plugin or Perfetto."""
    global _profiler
    if _profiler is not None:
        raise RuntimeError("a trace is already running; call stop_trace() first")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)
    )
    prof.start()
    _profiler = prof


def stop_trace() -> None:
    """Stop the trace :func:`start_trace` began and write it."""
    global _profiler
    prof, _profiler = _profiler, None
    if prof is None:
        raise RuntimeError("no trace is running; call start_trace() first")
    prof.stop()
