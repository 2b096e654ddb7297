"""The instrument registry: one namespace over every runtime counter.

Counterpart of ``metrics_tpu/observability/instruments.py``, with the same
Prometheus names. The registry puts the engines' :class:`EngineStats`
counters, the collective tallies folded into them and the partition
counters under Prometheus-style identities
(``metrics_tpu_engine_cache_hits{kind="update",owner="MulticlassF1Score"}``)
without moving the source of truth: the engines keep mutating their own
``EngineStats`` fields (no new work on the dispatch path), and the registry
holds *weak references* to the live engines and dispatchers, walking them
only when a snapshot is asked for. ``Metric.engine_stats()`` and
``MetricCollection.engine_stats()`` are views assembled by
:func:`engine_stats_view`, :func:`merge_member_reasons` and the partition
views over the same objects.

Manual instruments (:class:`Counter`, :class:`Gauge`, :class:`Histogram`) are
for the other subsystems: sync byte tallies, chaos faults, guard trips,
buffer overflows, scrape latency. They are plain Python objects guarded by
the GIL.

The tenant-set, ingest-pipeline and cluster bridges are here as API; the
modules that register with them (tenancy, serve, cluster) are not ported yet.

Export: :meth:`InstrumentRegistry.samples` yields flat ``Sample`` rows;
``export.to_prometheus_text`` / ``export.to_metrics_json`` render them.
"""
from __future__ import annotations

import math
import os
import threading
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

# name prefix for every sample this library exports
PREFIX = "metrics_tpu_"

# EngineStats integer fields exported one counter each (field name == suffix),
# with the help text the Prometheus exposition carries for the family
_ENGINE_COUNTER_FIELDS = (
    ("eager_calls", "Dispatches executed eagerly (warmup or fallback)."),
    ("cache_misses", "Dispatch keys that compiled a new executable."),
    ("cache_hits", "Dispatches served by an already-compiled executable."),
    ("donated_calls", "Compiled dispatches that donated the state buffers."),
    ("bucketed_calls", "Dispatches routed through pow2 batch bucketing."),
    ("key_fast_hits", "Dispatch keys resolved by the id-keyed signature memo."),
)

_ENGINE_HELP = {
    "compiled_calls": "Total compiled dispatches (cache hits + misses).",
    "compile_seconds": "Cumulative wall time spent probing and capturing.",
    "collective_ops": "Collective op count of the probed steps, by kind.",
    "collective_bytes": "Collective payload bytes of the probed steps, by kind.",
    "transport_bytes": "Sync payload bytes of the probed steps, by transport and wire/logical side.",
    "transport_refusals": "Buckets whose quantized transport the error-budget gate refused.",
    "fallback_active": "1 while the engine is permanently reverted to eager.",
    "last_fallback_step": "Dispatch index of the engine's permanent fallback.",
}


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


@dataclass
class Sample:
    """One exported time-series point: ``name{labels} value``."""

    name: str
    labels: Dict[str, str]
    value: float
    kind: str  # "counter" | "gauge" | "histogram_bucket" | "histogram_sum" | "histogram_count"
    help: str = ""


class Counter:
    """Monotonic accumulator."""

    __slots__ = ("name", "labels", "help", "value")

    def __init__(self, name: str, labels: Dict[str, str], help: str = "") -> None:
        self.name, self.labels, self.help = name, labels, help
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        self.value += amount

    def samples(self) -> List[Sample]:
        return [Sample(self.name, self.labels, self.value, "counter", self.help)]


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "labels", "help", "value")

    def __init__(self, name: str, labels: Dict[str, str], help: str = "") -> None:
        self.name, self.labels, self.help = name, labels, help
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def samples(self) -> List[Sample]:
        return [Sample(self.name, self.labels, self.value, "gauge", self.help)]


# log-spaced seconds buckets covering 100 us .. ~100 s — wide enough for both
# a host copy of a few MB and a cold probe-and-capture
DEFAULT_SECONDS_BUCKETS = (
    1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1, 1.0, 3.0, 10.0, 30.0, 100.0,
)


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: each bucket counts
    observations ``<= le``, with a final ``+Inf`` bucket equal to count)."""

    __slots__ = ("name", "labels", "help", "buckets", "counts", "sum", "count")

    def __init__(
        self,
        name: str,
        labels: Dict[str, str],
        buckets: Sequence[float] = DEFAULT_SECONDS_BUCKETS,
        help: str = "",
    ) -> None:
        self.name, self.labels, self.help = name, labels, help
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * len(self.buckets)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.sum += value
        self.count += 1
        for i, le in enumerate(self.buckets):
            if value <= le:
                self.counts[i] += 1

    def samples(self) -> List[Sample]:
        out = []
        for le, c in zip(self.buckets, self.counts):
            out.append(Sample(
                f"{self.name}_bucket", {**self.labels, "le": repr(float(le))},
                float(c), "histogram_bucket", self.help,
            ))
        out.append(Sample(
            f"{self.name}_bucket", {**self.labels, "le": "+Inf"},
            float(self.count), "histogram_bucket", self.help,
        ))
        out.append(Sample(f"{self.name}_sum", dict(self.labels), self.sum, "histogram_sum", self.help))
        out.append(Sample(f"{self.name}_count", dict(self.labels), float(self.count), "histogram_count", self.help))
        return out


class InstrumentRegistry:
    """Get-or-create registry of instruments plus weakly-held live engines.

    ``counter/gauge/histogram`` return the existing instrument when the
    ``(name, labels)`` identity was seen before, so call sites never need to
    cache handles. Engines self-register at construction
    (:func:`register_engine`); dead ones drop out of snapshots automatically
    via their weakrefs.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: Dict[Tuple[str, Tuple], Any] = {}
        self._engines: List[weakref.ref] = []
        self._dispatchers: List[weakref.ref] = []
        self._tenant_sets: List[weakref.ref] = []
        self._ingest_pipelines: List[weakref.ref] = []
        self._clusters: List[weakref.ref] = []

    # ------------------------------------------------------------------ #
    # manual instruments
    # ------------------------------------------------------------------ #
    def _get_or_create(self, cls: type, name: str, labels: Dict[str, str],
                       help: str = "", **kw: Any) -> Any:
        if not name.startswith(PREFIX):
            name = PREFIX + name
        key = (name, _label_key(labels))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name, dict(labels), help=help, **kw)
                self._instruments[key] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"instrument {name}{labels} already registered as "
                    f"{type(inst).__name__}, requested {cls.__name__}"
                )
            return inst

    def counter(self, name: str, help: str = "", **labels: str) -> Counter:
        return self._get_or_create(Counter, name, labels, help)

    def gauge(self, name: str, help: str = "", **labels: str) -> Gauge:
        return self._get_or_create(Gauge, name, labels, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_SECONDS_BUCKETS, **labels: str) -> Histogram:
        return self._get_or_create(Histogram, name, labels, help, buckets=buckets)

    # ------------------------------------------------------------------ #
    # engine registration — the EngineStats bridge
    # ------------------------------------------------------------------ #
    def register_engine(self, engine: Any) -> None:
        """Weakly track a live engine; its ``EngineStats`` fields appear in
        snapshots as ``metrics_tpu_engine_*{kind=...,owner=...}`` counters."""
        with self._lock:
            self._engines.append(weakref.ref(engine))

    def live_engines(self) -> List[Any]:
        out, kept = [], []
        with self._lock:
            for ref in self._engines:
                engine = ref()
                if engine is not None:
                    out.append(engine)
                    kept.append(ref)
            self._engines = kept
        return out

    # ------------------------------------------------------------------ #
    # dispatcher registration — the partition bridge
    # ------------------------------------------------------------------ #
    def register_dispatcher(self, dispatcher: Any) -> None:
        """Weakly track a collection's partition dispatcher; its member
        assignments and lifecycle counters appear in snapshots as
        ``metrics_tpu_partition_*{owner=...}`` series."""
        with self._lock:
            self._dispatchers.append(weakref.ref(dispatcher))

    def live_dispatchers(self) -> List[Any]:
        out, kept = [], []
        with self._lock:
            for ref in self._dispatchers:
                dispatcher = ref()
                if dispatcher is not None:
                    out.append(dispatcher)
                    kept.append(ref)
            self._dispatchers = kept
        return out

    # ------------------------------------------------------------------ #
    # tenant-set registration — the multi-tenant bridge
    # ------------------------------------------------------------------ #
    def register_tenant_set(self, tenant_set: Any) -> None:
        """Weakly track a tenant set (``TenantSet``); its occupancy
        and lifecycle counters appear in snapshots as
        ``metrics_tpu_tenant_*{owner=...}`` series, with a per-tenant label
        dimension on ``metrics_tpu_tenant_updates_total``."""
        with self._lock:
            self._tenant_sets.append(weakref.ref(tenant_set))

    def live_tenant_sets(self) -> List[Any]:
        out, kept = [], []
        with self._lock:
            for ref in self._tenant_sets:
                ts = ref()
                if ts is not None:
                    out.append(ts)
                    kept.append(ref)
            self._tenant_sets = kept
        return out

    # ------------------------------------------------------------------ #
    # ingest-pipeline registration — the serving bridge
    # ------------------------------------------------------------------ #
    def register_ingest_pipeline(self, pipeline: Any) -> None:
        """Weakly track an ingest pipeline (``IngestPipeline``); its queue
        depth, ledger, and dispatcher counters appear in snapshots as
        ``metrics_tpu_ingest_*{queue=...}`` series (alongside the admission
        counters/histograms the pipeline ticks directly)."""
        with self._lock:
            self._ingest_pipelines.append(weakref.ref(pipeline))

    def live_ingest_pipelines(self) -> List[Any]:
        out, kept = [], []
        with self._lock:
            for ref in self._ingest_pipelines:
                pipeline = ref()
                if pipeline is not None:
                    out.append(pipeline)
                    kept.append(ref)
            self._ingest_pipelines = kept
        return out

    def _ingest_samples(self) -> Iterable[Sample]:
        for pipeline in self.live_ingest_pipelines():
            labels = {"queue": pipeline.name}
            queue = pipeline.queue
            yield Sample(f"{PREFIX}ingest_queue_depth", dict(labels),
                         float(len(queue)), "gauge",
                         "Observation batches currently queued for dispatch.")
            yield Sample(f"{PREFIX}ingest_queue_capacity", dict(labels),
                         float(queue.capacity), "gauge",
                         "Admission bound of the ingest queue.")
            yield Sample(f"{PREFIX}ingest_draining", dict(labels),
                         1.0 if queue.closed else 0.0, "gauge",
                         "1 while the queue is closed to new admissions.")
            stats = pipeline.dispatcher.stats
            for fname, help_text in (
                ("dispatches", "Coalesced device dispatches applied."),
                ("observations", "Admitted observations applied to tenant state."),
                ("retries", "Transient dispatch faults retried by the consumer."),
                ("dead_letters", "Admitted observations parked on the dead-letter list."),
            ):
                yield Sample(f"{PREFIX}ingest_dispatch_{fname}_total", dict(labels),
                             float(getattr(stats, fname)), "counter", help_text)
            yield Sample(f"{PREFIX}ingest_last_coalesce_width", dict(labels),
                         float(stats.last_width), "gauge",
                         "Distinct tenants in the most recent coalesced dispatch.")

    # ------------------------------------------------------------------ #
    # cluster-coordinator registration — the scale-out serving tier
    # ------------------------------------------------------------------ #
    def register_cluster(self, coordinator: Any) -> None:
        """Weakly track a cluster coordinator (``ClusterCoordinator``);
        shard sizes, the shard-map epoch and replica liveness appear as
        ``metrics_tpu_cluster_*{cluster=...}`` gauges (migration counters and
        the fence-duration histogram are ticked by the coordinator itself)."""
        with self._lock:
            self._clusters.append(weakref.ref(coordinator))

    def live_clusters(self) -> List[Any]:
        out, kept = [], []
        with self._lock:
            for ref in self._clusters:
                coordinator = ref()
                if coordinator is not None:
                    out.append(coordinator)
                    kept.append(ref)
            self._clusters = kept
        return out

    def _cluster_samples(self) -> Iterable[Sample]:
        for coordinator in self.live_clusters():
            labels = {"cluster": coordinator.name}
            yield Sample(f"{PREFIX}cluster_epoch", dict(labels),
                         float(coordinator.shard_map.epoch), "gauge",
                         "Current shard-map epoch (the routing logical clock).")
            yield Sample(f"{PREFIX}cluster_replicas", dict(labels),
                         float(len(coordinator.replicas)), "gauge",
                         "Replicas in the shard map.")
            dead = sum(1 for r in coordinator.replicas.values() if not r.alive)
            yield Sample(f"{PREFIX}cluster_replicas_dead", dict(labels), float(dead),
                         "gauge", "Replicas currently lost (degraded serving).")
            for replica_id, replica in sorted(coordinator.replicas.items()):
                if replica.alive:
                    yield Sample(
                        f"{PREFIX}cluster_shard_tenants",
                        {**labels, "replica": replica_id},
                        float(replica.tenant_set.active_count), "gauge",
                        "Tenants resident on this replica's shard.",
                    )

    def _tenant_samples(self) -> Iterable[Sample]:
        for ts in self.live_tenant_sets():
            labels = {"owner": ts.name}
            yield Sample(f"{PREFIX}tenant_active", dict(labels),
                         float(ts.active_count), "gauge",
                         "Tenants currently admitted to this TenantSet.")
            yield Sample(f"{PREFIX}tenant_capacity", dict(labels),
                         float(ts.capacity), "gauge",
                         "Stacked slot capacity of this TenantSet.")
            yield Sample(f"{PREFIX}tenant_bucket_width", dict(labels),
                         float(ts.stats.last_bucket), "gauge",
                         "pow2 tenant bucket width of the most recent dispatch.")
            yield Sample(f"{PREFIX}tenant_executables", dict(labels),
                         float(ts.stats.compiles), "gauge",
                         "Distinct compiled executables serving this TenantSet.")
            for fname, help_text in (
                ("admits", "Tenants admitted over the set's lifetime."),
                ("evicts", "Tenants evicted over the set's lifetime."),
                ("resets", "Per-tenant resets over the set's lifetime."),
                ("dispatches", "Stacked update dispatches served."),
                ("cache_hits", "Dispatches served by a cached executable."),
            ):
                yield Sample(f"{PREFIX}tenant_{fname}_total", dict(labels),
                             float(getattr(ts.stats, fname)), "counter", help_text)
            # the per-tenant label dimension: one series per *active* tenant
            for tid, n in ts.tenant_update_counts().items():
                yield Sample(
                    f"{PREFIX}tenant_updates_total",
                    {**labels, "tenant": str(tid)},
                    float(n), "counter",
                    "Stacked updates applied to each active tenant.",
                )

    def _partition_samples(self) -> Iterable[Sample]:
        for dispatcher in self.live_dispatchers():
            owner = type(dispatcher.collection).__name__
            labels = {"owner": owner}
            view = dispatcher.partition_view()
            for kind in ("update", "compute"):
                counts: Dict[str, int] = {}
                for info in view[kind].values():
                    counts[info["path"]] = counts.get(info["path"], 0) + 1
                for path, n in sorted(counts.items()):
                    yield Sample(
                        f"{PREFIX}partition_members",
                        {**labels, "kind": kind, "path": path},
                        float(n), "gauge",
                        "Collection members currently assigned to each dispatch path.",
                    )
            stats = dispatcher.stats
            for fname, help_text in (
                ("builds", "Partitions constructed (first build + rebuilds)."),
                ("repartitions", "Partition rebuilds caused by a changed key."),
                ("migrations", "Members migrated to the eager set by a runtime fallback."),
                ("stable_hits", "Dispatches served by the cached partition."),
                ("probations", "Migrations granted a bounded re-probe schedule."),
                ("repromotions", "Probation trials that returned member(s) to the fused set."),
            ):
                yield Sample(
                    f"{PREFIX}partition_{fname}", dict(labels),
                    float(getattr(stats, fname)), "counter", help_text,
                )

    def _engine_samples(self) -> Iterable[Sample]:
        for engine in self.live_engines():
            stats = engine.stats
            labels = {"kind": engine._kind, "owner": engine._owner_name()}
            for fname, help_text in _ENGINE_COUNTER_FIELDS:
                yield Sample(f"{PREFIX}engine_{fname}", dict(labels),
                             float(getattr(stats, fname)), "counter", help_text)
            yield Sample(f"{PREFIX}engine_compiled_calls", dict(labels),
                         float(stats.compiled_calls), "counter",
                         _ENGINE_HELP["compiled_calls"])
            yield Sample(f"{PREFIX}engine_compile_seconds", dict(labels),
                         float(getattr(stats, "compile_seconds", 0.0)), "counter",
                         _ENGINE_HELP["compile_seconds"])
            for op, n in stats.collective_counts.items():
                yield Sample(f"{PREFIX}engine_collective_ops", {**labels, "op": op},
                             float(n), "counter", _ENGINE_HELP["collective_ops"])
            for op, n in stats.collective_bytes.items():
                yield Sample(f"{PREFIX}engine_collective_bytes", {**labels, "op": op},
                             float(n), "counter", _ENGINE_HELP["collective_bytes"])
            for transport, split in getattr(stats, "collective_bytes_by_transport", {}).items():
                for side, n in split.items():
                    yield Sample(
                        f"{PREFIX}engine_transport_bytes",
                        {**labels, "transport": transport, "side": side},
                        float(n), "counter", _ENGINE_HELP["transport_bytes"],
                    )
            refused = getattr(stats, "transport_refusals", 0)
            if refused:
                yield Sample(f"{PREFIX}engine_transport_refusals", dict(labels),
                             float(refused), "counter", _ENGINE_HELP["transport_refusals"])
            broken = 1.0 if getattr(engine, "broken", None) else 0.0
            yield Sample(f"{PREFIX}engine_fallback_active", dict(labels), broken,
                         "gauge", _ENGINE_HELP["fallback_active"])
            last_step = getattr(stats, "last_fallback_step", None)
            if last_step is not None:
                yield Sample(f"{PREFIX}engine_last_fallback_step", dict(labels),
                             float(last_step), "gauge",
                             _ENGINE_HELP["last_fallback_step"])

    # ------------------------------------------------------------------ #
    def samples(self) -> List[Sample]:
        """Flat snapshot of every instrument plus every live engine's stats
        plus the process/tracer gauges (RSS, ring saturation)."""
        out: List[Sample] = []
        with self._lock:
            instruments = list(self._instruments.values())
        for inst in instruments:
            out.extend(inst.samples())
        out.extend(self._engine_samples())
        out.extend(self._partition_samples())
        out.extend(self._tenant_samples())
        out.extend(self._ingest_samples())
        out.extend(self._cluster_samples())
        out.extend(_autotune_samples())
        out.extend(_process_samples())
        return out

    def snapshot(self) -> Dict[str, Any]:
        """JSON-friendly snapshot: ``{name: [{labels, value}, ...]}``."""
        grouped: Dict[str, Any] = {}
        for s in self.samples():
            grouped.setdefault(s.name, []).append(
                {"labels": s.labels, "value": s.value, "kind": s.kind}
            )
        return grouped

    def clear(self) -> None:
        """Drop every manual instrument and engine/dispatcher registration
        (tests)."""
        with self._lock:
            self._instruments.clear()
            self._engines.clear()
            self._dispatchers.clear()
            self._tenant_sets.clear()
            self._ingest_pipelines.clear()


def _rss_bytes() -> Optional[int]:
    """Resident set size via ``/proc`` (Linux), ``resource`` elsewhere."""
    try:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * (os.sysconf("SC_PAGE_SIZE") or 4096)
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource

        rss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return int(rss_kb) * 1024  # Linux reports KiB (peak, not current — best effort)
    except Exception:
        return None


def _autotune_samples() -> Iterable[Sample]:
    """Derived self-tuning-sync gauges read off the live controller at
    snapshot time (the per-decision counters/gauges are pushed by the
    controller itself; these cover the controller-level view). Lazy import:
    the autotune package imports the sync layer, which imports this module."""
    from metrics_tpu_torch.autotune import controller as _at

    enabled = _at.autotune_enabled()
    yield Sample(f"{PREFIX}autotune_enabled", {},
                 1.0 if enabled else 0.0, "gauge",
                 "1 while the self-tuning sync controller is active.")
    yield Sample(f"{PREFIX}autotune_decision_epoch", {},
                 float(_at.decision_epoch()), "gauge",
                 "Monotonic tuner decision epoch (cache keys re-trace on change).")
    if not enabled:
        return
    ctl = _at.get_controller()
    if ctl is None:
        return
    yield Sample(f"{PREFIX}autotune_pinned", {},
                 1.0 if ctl.pinned is not None else 0.0, "gauge",
                 "1 while a pinned tuned_plan bypasses exploration.")
    with ctl._lock:
        n_buckets = len(ctl.buckets) if ctl.pinned is None else len(ctl.pinned.buckets)
        committed = sum(
            1 for t in ctl.buckets.values() if t.phase == "committed"
        ) if ctl.pinned is None else n_buckets
    yield Sample(f"{PREFIX}autotune_tracked_buckets", {},
                 float(n_buckets), "gauge",
                 "Buckets the tuner currently tracks (or the pinned plan covers).")
    yield Sample(f"{PREFIX}autotune_committed_buckets", {},
                 float(committed), "gauge",
                 "Tracked buckets whose decision has committed.")


def _process_samples() -> Iterable[Sample]:
    """Process- and tracer-level samples computed at snapshot time.

    These are *derived* gauges, not stored instruments: the tracer's drop
    counter and ring fill are read off the live ring (so a scrape sees ring
    saturation the moment it happens — the "is my capacity too small" signal),
    and ``rss_bytes`` is read from the OS. Exported names:

    * ``metrics_tpu_tracer_dropped_events_total`` — events evicted by the
      ring bound since the last :meth:`EventTracer.clear`;
    * ``metrics_tpu_tracer_ring_events`` / ``_ring_capacity`` /
      ``_ring_utilization`` — current fill, bound, and their ratio;
    * ``metrics_tpu_tracer_active`` — 1 while tracing is enabled;
    * ``metrics_tpu_process_rss_bytes`` — resident set size.
    """
    from metrics_tpu_torch.observability import tracer as _tracer_mod

    tracer = _tracer_mod.get_tracer()
    dropped = float(tracer.dropped) if tracer is not None else 0.0
    events = float(len(tracer)) if tracer is not None else 0.0
    capacity = float(tracer.capacity) if tracer is not None else 0.0
    yield Sample(
        f"{PREFIX}tracer_dropped_events_total", {}, dropped, "counter",
        "Trace events evicted by the ring buffer bound.",
    )
    yield Sample(
        f"{PREFIX}tracer_ring_events", {}, events, "gauge",
        "Trace events currently buffered in the ring.",
    )
    yield Sample(
        f"{PREFIX}tracer_ring_capacity", {}, capacity, "gauge",
        "Ring buffer capacity (0 = no tracer constructed yet).",
    )
    yield Sample(
        f"{PREFIX}tracer_ring_utilization", {},
        (events / capacity) if capacity else 0.0, "gauge",
        "Ring fill fraction; 1.0 means the next event evicts the oldest.",
    )
    yield Sample(
        f"{PREFIX}tracer_active", {}, 1.0 if _tracer_mod.enabled() else 0.0, "gauge",
        "Whether runtime tracing is currently enabled.",
    )
    rss = _rss_bytes()
    if rss is not None:
        yield Sample(
            f"{PREFIX}process_rss_bytes", {}, float(rss), "gauge",
            "Resident set size of this process.",
        )


# the process-wide default registry; engines register here at construction
REGISTRY = InstrumentRegistry()


def register_engine(engine: Any) -> None:
    """Module-level convenience over ``REGISTRY.register_engine``."""
    REGISTRY.register_engine(engine)


def register_dispatcher(dispatcher: Any) -> None:
    """Module-level convenience over ``REGISTRY.register_dispatcher``."""
    REGISTRY.register_dispatcher(dispatcher)


def register_tenant_set(tenant_set: Any) -> None:
    """Module-level convenience over ``REGISTRY.register_tenant_set``."""
    REGISTRY.register_tenant_set(tenant_set)


def register_ingest_pipeline(pipeline: Any) -> None:
    """Module-level convenience over ``REGISTRY.register_ingest_pipeline``."""
    REGISTRY.register_ingest_pipeline(pipeline)


def register_cluster(coordinator: Any) -> None:
    """Module-level convenience over ``REGISTRY.register_cluster``."""
    REGISTRY.register_cluster(coordinator)


def get_registry() -> InstrumentRegistry:
    return REGISTRY


# --------------------------------------------------------------------------- #
# legacy engine_stats() views
# --------------------------------------------------------------------------- #
def engine_stats_view(update_engine: Any, compute_engine: Any) -> Dict[str, Any]:
    """The exact dict ``Metric.engine_stats()`` has always returned, assembled
    from the live engines (``None`` slots for engines not yet built):
    ``{"update": EngineStats|None, "compute": EngineStats|None,
    "fallback_reasons": {"<kind>:<Owner>": why}}``."""
    stats: Dict[str, Any] = {
        "update": update_engine.stats if update_engine is not None else None,
        "compute": compute_engine.stats if compute_engine is not None else None,
    }
    reasons: Dict[str, str] = {}
    for kind, s in stats.items():
        if s is not None:
            for owner, why in s.fallback_reasons.items():
                reasons[f"{kind}:{owner}"] = why
    stats["fallback_reasons"] = reasons
    return stats


def merge_member_reasons(reasons: Dict[str, str], member_name: str,
                         member_reasons: Dict[str, str]) -> None:
    """Fold one collection member's fallback reasons into the collection-level
    dict, prefixed with the member's *name* — two members sharing a metric
    class (``{"a": F1(), "b": F1()}``) must not collide on ``"update:F1"``."""
    for key, why in member_reasons.items():
        reasons[f"{member_name}.{key}"] = why


def collection_partition_view(coll: Any) -> Dict[str, Any]:
    """The ``engine_stats()["partition"]`` payload for a collection: member
    name -> assigned dispatch path + classification reason per kind, plus the
    partition lifecycle counters. Lazy import: the engine module imports this
    one at load time."""
    from metrics_tpu_torch.core import engine as _engine

    return _engine.collection_partition_view(coll)


def metric_partition_view(metric: Any) -> Dict[str, Any]:
    """The single-metric ``engine_stats()["partition"]`` payload."""
    from metrics_tpu_torch.core import engine as _engine

    return _engine.metric_partition_view(metric)
