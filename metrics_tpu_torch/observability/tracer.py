"""The event tracer: a bounded ring buffer of timestamped runtime spans.

Counterpart of ``metrics_tpu/observability/tracer.py``, with the same event
catalog letter for letter. Every lifecycle event of the engines and their
satellite subsystems (engine dispatch: eager warmup, probe-and-capture,
replay, permanent fallback; fused-streak detach and realias; sync bucket
builds; shard placement) is recorded here as a :class:`TraceEvent` while
tracing is on. The categories whose emitters are not ported yet
(checkpoint, tenancy, serve, cluster, kernel) stay in the catalog.

Off by default, and the disabled path is a **single flag check**: every
instrumentation site reads the module-level :data:`active` boolean and skips
everything else when it is ``False``. No tracer object is consulted, no
clock is read, no string is built, nothing is read from the device.

Design notes:

- **Ring buffer, not a log.** Events land in a ``collections.deque`` with a
  fixed ``maxlen``; when full, the oldest are evicted and ``dropped`` counts
  them, so a tracer left on for a long run holds the *last* ``capacity``
  events and cannot exhaust the host's memory.
- **Host-side only.** Events are plain Python objects; recording never reads
  a tensor, so it never synchronizes with the card. Sites inside a step the
  engine probes (the sync's bucket build) record once per probe, which is
  when the JAX package records them at trace time; the capture's second run
  of the step and the replays record nothing.
- **Clock**: ``time.perf_counter_ns() // 1000``, monotonic microseconds, the
  unit Chrome trace events use. ``tid`` is the recording thread.

Enable with :func:`enable`, the ``METRICS_TPU_TRACE=1`` environment variable,
or scoped with the :func:`trace` context manager::

    from metrics_tpu_torch import observability as obs

    with obs.trace() as tracer:
        coll.update(logits, target)
        coll.compute()
    obs.write_chrome_trace("trace.json", tracer)
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, Generator, Iterable, List, Optional, Tuple

import contextlib

_ENV_FLAG = "METRICS_TPU_TRACE"
_ENV_CAPACITY = "METRICS_TPU_TRACE_CAPACITY"

DEFAULT_CAPACITY = 65536

# Phase constants (Chrome trace-event "ph" vocabulary subset we emit).
PH_COMPLETE = "X"  # span with ts + dur
PH_INSTANT = "i"  # zero-duration marker
PH_METADATA = "M"  # process/thread naming (added by the exporter)

# The event catalog — every `name` the runtime emits, by category. Kept here
# so tests and the exporter's summarize view can assert against one source
# of truth; the names are the JAX package's.
EVENT_CATALOG: Dict[str, Tuple[str, ...]] = {
    "engine": (
        "dispatch/eager",  # warmup / fallback execution of the raw update
        "dispatch/compile",  # first compiled call of a signature: probe + capture (dur = wall)
        "dispatch/cached",  # steady-state call: a graph replay (arg donated=True/False)
        "dispatch/fallback",  # permanent revert to eager (arg reason)
    ),
    "streak": (
        "streak/detach",  # fused streak begins: members detach from leaders
        "streak/realias",  # observation point: members realias to leader state
    ),
    "partition": (
        "partition/build",  # first classification into {fused,bucketed,eager}
        "partition/rebuild",  # partition key changed: flags/placement re-keyed
        "partition/migrate",  # runtime fallback moved member(s) to the eager set
        "partition/repromote",  # probation trial succeeded: member(s) rejoined fused
    ),
    "sync": (
        "sync/bucket_build",  # one sync_state build (args: collective tallies)
        "sync/transport_refused",  # error-budget gate fell a bucket back to exact (args: reason)
        "sync/incremental_emit",  # one in-streak incremental emission (args: emission, fold/replace leaves, tallies)
        "sync/tune_decision",  # autotune controller decision (args: bucket, from, to, reason, cadence, predicted bytes/bound)
    ),
    "shard": (
        "shard/place",  # Metric.shard_state placement
        "shard/unshard",  # Metric.unshard_state gather-back
        "mesh/build",  # parallel.mesh.make_mesh
    ),
    "checkpoint": (
        "checkpoint/save/snapshot",  # build_shard: live state -> payload pytree
        "checkpoint/save/host_copy",  # device->host transfer of the payload
        "checkpoint/save/write",  # npz + sidecar into the pending dir (fsync)
        "checkpoint/save/commit",  # manifest + COMMIT + atomic rename
        "checkpoint/restore/verify",  # manifest/checksum/fingerprint checks
        "checkpoint/restore/apply",  # folded state applied to the live object
        "checkpoint/restore/fallback",  # newest step corrupt: older verifiable step used
        "ckpt/retry",  # one storage-op retry scheduled (or giveup) by RetryPolicy
        "ckpt/overlap_copy",  # overlapped device->host drain on the async-save thread (args: bytes, enqueue_s)
    ),
    "chaos": (
        "chaos/fault",  # the fault-injection harness fired a scheduled fault
    ),
    "tenancy": (
        "tenancy/dispatch",  # one stacked update dispatch (args: tenants, bucket, tenant ids)
        "tenancy/compute",  # one stacked compute dispatch over the active tenants
        "tenancy/reset",  # masked per-tenant reset (args: tenant ids)
        "tenancy/admit",  # tenant admitted to a stacked slot (args: tenant, slot)
        "tenancy/evict",  # tenant evicted, slot returned to the free list
    ),
    "guard": (
        "guard/nonfinite",  # non-finite state detected at a guarded boundary
    ),
    "buffer": (
        "buffer/overflow",  # sticky CatBuffer overflow flag first flipped (args: owner, capacity)
    ),
    "kernel": (
        "kernel/dispatch",  # one heavy-kernel dispatch (args: kernel, impl, bucket_width)
        "kernel/fallback",  # hand kernel failed; its plain version used (args: kernel, reason)
    ),
    "serve": (
        "serve/ingest",  # one observation admitted to the ingest queue
        "serve/reject",  # one observation rejected at admission (args: reason)
        "serve/coalesce",  # consumer pulled a distinct-tenant batch (args: width)
        "serve/dispatch",  # coalesced batch applied to the TenantSet (args: attempts)
        "serve/read",  # staleness-bounded tenant read served
        "serve/drain",  # graceful drain: every admitted batch accounted for
        "serve/dead_letter",  # a batch parked on the dead-letter list (args: error)
    ),
    "cluster": (
        "cluster/fence",  # migration: src stops admitting the tenant (args: tenant, src, dst)
        "cluster/drain",  # migration: waiting for the src ledger to settle
        "cluster/export",  # migration: single-row gather of the tenant's state
        "cluster/transfer",  # migration: checksummed frames streaming to dst
        "cluster/import",  # migration: single-row scatter + ledger seed on dst
        "cluster/cutover",  # migration: shard-map epoch bump pins tenant to dst
        "cluster/abort",  # migration rolled back (args: phase, error)
        "cluster/rebalance",  # one rebalance pass (args: moves, committed)
        "cluster/replica_lost",  # a replica died; cluster serves degraded
        "cluster/replica_restored",  # lost replica recovered from checkpoint
    ),
}


@dataclass
class TraceEvent:
    """One timeline entry. Field names mirror the Chrome trace-event schema
    (``ts``/``dur`` in microseconds) so export is a dict copy, not a mapping."""

    name: str
    cat: str
    ph: str
    ts: int  # microseconds (monotonic clock)
    dur: int = 0  # microseconds; 0 for instants
    tid: int = 0
    args: Dict[str, Any] = field(default_factory=dict)


def _now_us() -> int:
    return time.perf_counter_ns() // 1000


class EventTracer:
    """Bounded ring-buffer recorder. Thread-safe: the deque append is atomic
    and the drop counter sits behind the GIL; ``events()`` snapshots."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        if capacity <= 0:
            raise ValueError(f"tracer capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self._events: deque = deque(maxlen=self.capacity)
        self.dropped = 0  # events evicted by the ring bound
        self.started_us = _now_us()

    def __len__(self) -> int:
        return len(self._events)

    def record(
        self,
        name: str,
        cat: str,
        ph: str = PH_INSTANT,
        ts: Optional[int] = None,
        dur: int = 0,
        args: Optional[Dict[str, Any]] = None,
    ) -> TraceEvent:
        event = TraceEvent(
            name=name,
            cat=cat,
            ph=ph,
            ts=_now_us() if ts is None else int(ts),
            dur=int(dur),
            tid=threading.get_ident() & 0xFFFFFFFF,
            args=args or {},
        )
        if len(self._events) == self.capacity:
            self.dropped += 1
        self._events.append(event)
        return event

    def events(self) -> List[TraceEvent]:
        """Snapshot of the buffered events, oldest first."""
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()
        self.dropped = 0
        self.started_us = _now_us()

    def counts_by_name(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self._events:
            out[e.name] = out.get(e.name, 0) + 1
        return out


# --------------------------------------------------------------------------- #
# the global switch — THE single flag every hot site checks
# --------------------------------------------------------------------------- #
# `active` is the gate: instrumentation sites read this one module attribute
# and do nothing else when it is False. It is redundant with
# `_tracer is not None` by construction; it exists so the disabled check is a
# plain boolean load with no comparison against None-able state.
active: bool = False
_tracer: Optional[EventTracer] = None
_lock = threading.Lock()


def enabled() -> bool:
    """Whether runtime tracing is currently on."""
    return active


def get_tracer() -> Optional[EventTracer]:
    """The live tracer (``None`` while disabled)."""
    return _tracer


def enable(capacity: Optional[int] = None) -> EventTracer:
    """Turn tracing on process-wide; returns the (possibly new) tracer.

    Re-enabling with the same capacity keeps the existing buffer (events
    accumulate across enable/disable cycles until :meth:`EventTracer.clear`);
    passing a different ``capacity`` swaps in a fresh ring.
    """
    global active, _tracer
    with _lock:
        cap = capacity if capacity is not None else int(
            os.environ.get(_ENV_CAPACITY, DEFAULT_CAPACITY)
        )
        if _tracer is None or _tracer.capacity != cap:
            _tracer = EventTracer(cap)
        active = True
        return _tracer


def disable() -> Optional[EventTracer]:
    """Turn tracing off; the buffer is kept (inspect/export it afterwards)."""
    global active
    with _lock:
        active = False
        return _tracer


@contextlib.contextmanager
def trace(capacity: Optional[int] = None) -> Generator[EventTracer, None, None]:
    """Enable tracing for the duration of the block (restores the prior state).

    Yields a *fresh* tracer so the block's events are exactly the buffer
    contents — nested use shares the outer tracer instead.
    """
    global _tracer
    if active:  # nested: ride the outer tracer
        yield _tracer  # type: ignore[misc]
        return
    prev = _tracer
    with _lock:
        _tracer = EventTracer(capacity if capacity is not None else DEFAULT_CAPACITY)
    tracer = enable(_tracer.capacity)
    try:
        yield tracer
    finally:
        disable()
        with _lock:
            if prev is not None:
                _tracer = prev


# --------------------------------------------------------------------------- #
# emit helpers (call sites MUST gate on `active` themselves — these assume
# tracing is on so the disabled path never pays a function call)
# --------------------------------------------------------------------------- #
def emit_instant(name: str, cat: str, **args: Any) -> None:
    """Record a zero-duration marker (gate on :data:`active` first)."""
    tracer = _tracer
    if tracer is not None:
        tracer.record(name, cat, PH_INSTANT, args=args)


def emit_complete(name: str, cat: str, ts_us: int, dur_us: int, **args: Any) -> None:
    """Record a finished span from explicit timestamps (microseconds)."""
    tracer = _tracer
    if tracer is not None:
        tracer.record(name, cat, PH_COMPLETE, ts=ts_us, dur=max(int(dur_us), 0), args=args)


@contextlib.contextmanager
def span(name: str, cat: str, **args: Any) -> Generator[Dict[str, Any], None, None]:
    """Record the block as a complete event. Yields the ``args`` dict so the
    body can attach results (byte tallies, step indices) before the span
    closes. Safe to enter with tracing off (no-op) — but hot sites should
    still gate on :data:`active` to skip the context-manager machinery."""
    if not active:
        yield {}
        return
    t0 = _now_us()
    try:
        yield args
    finally:
        emit_complete(name, cat, t0, _now_us() - t0, **args)


def _env_autostart() -> None:
    if os.environ.get(_ENV_FLAG, "0").lower() in ("1", "true", "on"):
        enable()


_env_autostart()
