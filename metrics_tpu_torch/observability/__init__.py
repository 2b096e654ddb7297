"""Runtime telemetry for the engines (counterpart of ``metrics_tpu/observability``).

* :mod:`~metrics_tpu_torch.observability.tracer`: an off-by-default bounded
  ring-buffer **event tracer** recording timestamped spans for every runtime
  lifecycle event: engine dispatch (warmup, probe-and-capture, replay,
  fallback), fused-streak detach/realias, partition builds and migrations,
  sync bucket builds with their collective tallies, shard placement, chaos
  faults, guard trips and buffer overflows.
* :mod:`~metrics_tpu_torch.observability.instruments`: an **instrument
  registry** putting every live engine's :class:`EngineStats`, the
  partition counters and the manual counters/gauges/histograms under the
  JAX package's Prometheus names; ``Metric.engine_stats()`` and
  ``MetricCollection.engine_stats()`` are views over it.
* :mod:`~metrics_tpu_torch.observability.export`: Chrome trace-event JSON
  (Perfetto), Prometheus text and JSON snapshots, summarize/diff analytics.
* :mod:`~metrics_tpu_torch.observability.server`: a stdlib background HTTP
  **scrape server** (``/metrics``, ``/stats.json``, ``/trace``,
  ``/healthz``) behind :func:`serve`/:func:`shutdown` and
  ``METRICS_TPU_OBS_PORT``, degrading to a push-to-spool fallback when the
  port is taken.
* :mod:`~metrics_tpu_torch.observability.shards`: per-host **trace shards**
  merged by :func:`merge_trace_shards` into one clock-aligned trace, and
  :func:`correlate_device_trace`, which joins the host's dispatch spans with
  a ``torch.profiler`` export of the same run through the
  ``record_function`` names the engines dispatch under while tracing.
* :mod:`~metrics_tpu_torch.observability.regress`: the bench regression
  watchdog over ``BENCH_r*.json`` rounds.

``python -m metrics_tpu_torch.observability`` dumps, summarizes, validates,
diffs and merges trace files, and runs the regression watchdog.

Quick start::

    from metrics_tpu_torch import observability as obs

    with obs.trace() as tracer:
        for logits, target in loader:
            coll.update(logits, target)
        values = coll.compute()
    obs.write_chrome_trace("run.trace.json", tracer)   # open in Perfetto
    print(obs.to_prometheus_text())                    # engine counters

The disabled path costs one module-attribute boolean check per
instrumentation site (``tracer.active``): nothing else runs, nothing is
read from the card.
"""
from metrics_tpu_torch.observability.tracer import (
    DEFAULT_CAPACITY,
    EVENT_CATALOG,
    EventTracer,
    TraceEvent,
    disable,
    enable,
    enabled,
    get_tracer,
    trace,
)
from metrics_tpu_torch.observability.instruments import (
    Counter,
    Gauge,
    Histogram,
    InstrumentRegistry,
    REGISTRY,
    Sample,
    get_registry,
)
from metrics_tpu_torch.observability.export import (
    diff_traces,
    load_trace,
    summarize_trace,
    to_chrome_trace,
    to_metrics_json,
    to_prometheus_text,
    validate_chrome_trace,
    write_chrome_trace,
)
from metrics_tpu_torch.observability.server import (
    ObservabilityServer,
    TraceSpool,
    get_server,
    serve,
    shutdown,
)
from metrics_tpu_torch.observability.shards import (
    build_trace_shard,
    correlate_device_trace,
    dispatch_annotation,
    merge_spool_dir,
    merge_trace_shards,
    parse_dispatch_annotation,
    write_trace_shard,
)
from metrics_tpu_torch.observability.regress import (
    RegressReport,
    check_paths,
    check_trajectory,
    load_rounds,
)

__all__ = [
    "DEFAULT_CAPACITY",
    "EVENT_CATALOG",
    "EventTracer",
    "TraceEvent",
    "enable",
    "disable",
    "enabled",
    "get_tracer",
    "trace",
    "Counter",
    "Gauge",
    "Histogram",
    "InstrumentRegistry",
    "REGISTRY",
    "Sample",
    "get_registry",
    "to_chrome_trace",
    "write_chrome_trace",
    "validate_chrome_trace",
    "load_trace",
    "summarize_trace",
    "diff_traces",
    "to_prometheus_text",
    "to_metrics_json",
    # off-host layer
    "ObservabilityServer",
    "TraceSpool",
    "serve",
    "shutdown",
    "get_server",
    "build_trace_shard",
    "write_trace_shard",
    "merge_trace_shards",
    "merge_spool_dir",
    "correlate_device_trace",
    "dispatch_annotation",
    "parse_dispatch_annotation",
    "RegressReport",
    "check_paths",
    "check_trajectory",
    "load_rounds",
]
