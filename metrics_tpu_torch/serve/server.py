"""The ingestion front-end: HTTP ingest -> bounded queue -> TenantSet -> reads.

Counterpart of ``metrics_tpu/serve/server.py``: the same endpoints, status
codes, headers and JSON documents. The TenantSet behind it holds its state on
the card (a template built there); the pipeline moves device values to the
host explicitly where they leave it (:func:`host_value` in :meth:`IngestPipeline.read`).

Two layers:

* :class:`IngestPipeline` — the transport-free core: admission control
  (tenant capacity + the queue's bounds), the per-tenant **ledger**
  (admitted / applied / dead-lettered counts — the staleness source of
  truth), the dispatcher thread, staleness-bounded reads, and graceful
  drain. Everything a test or an in-process caller needs works here with no
  socket.
* :class:`IngestServer` — the stdlib HTTP skin over a pipeline, on the same
  bind/port-0/daemon-thread lifecycle as the observability scrape server
  (:mod:`metrics_tpu_torch.utils.httpd`). Endpoints:

  - ``POST /ingest/<tenant_id>`` — one observation batch. Bodies:
    ``application/json`` (``{"args": [...], "kwargs": {...}}``, arrays as
    nested lists or ``{"data": ..., "dtype": ...}``), ``application/x-npy``
    (one raw ``np.save`` array = one positional arg), or
    ``application/x-npz`` (``np.savez`` with ``arg0..argN`` / ``kw_<name>``
    entries — the byte-exact path). Answers 200 with the admission echo,
    **429 + Retry-After** on backpressure (``queue_full`` / ``tenant_cap``
    / ``tenant_capacity``), 503 + Retry-After while draining or on an
    injected ingress fault — a rejection is always surfaced, never silent.
  - ``GET /read/<tenant_id>[?max_staleness_steps=K&timeout_s=T]`` — the
    tenant's ``compute()`` values plus the explicit staleness contract:
    ``last_applied_step`` (batches applied to device state),
    ``admitted_steps``, and ``staleness_steps`` (admitted-but-unapplied).
    With ``max_staleness_steps`` the read blocks until the dispatcher has
    caught up to within ``K`` steps; a timeout answers 503 + Retry-After
    and ticks ``ingest_deadline_missed_total``.
  - ``GET /healthz`` / ``GET /stats.json`` — liveness + the full pipeline
    counters (queue, ledger, dispatcher, TenantSet executable stats).

Steady-state serving captures nothing new: arrival raggedness is absorbed by
the coalescer (distinct-tenant batches of any width) and the TenantSet's
pow2 bucketing, so queue-depth churn replays the same captured steps —
``stats()["tenant_set"]["compiles"]`` is the number of distinct bucket widths
the traffic has reached (update and compute), and the partition
dispatcher's ``builds`` stays 1.

Module lifecycle mirrors the scrape server: :func:`serve` starts the
process-wide singleton (``METRICS_TPU_SERVE_PORT``; port 0 = OS-assigned),
:func:`shutdown` drains and stops it. A taken port with
``fallback_local=True`` degrades to the bare pipeline (kind ``"local"``)
instead of killing the job — the shared-pod rule, implemented once in
:mod:`metrics_tpu_torch.utils.httpd`.
"""
from __future__ import annotations

import io
import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

import torch

from metrics_tpu_torch.observability import tracer as _otrace
from metrics_tpu_torch.observability import instruments as _instruments
from metrics_tpu_torch.observability.instruments import REGISTRY as _REGISTRY
from metrics_tpu_torch.resilience import chaos as _chaos
from metrics_tpu_torch.serve.coalesce import Admission, BoundedIngestQueue, Observation
from metrics_tpu_torch.serve.dispatcher import Dispatcher
from metrics_tpu_torch.utils import httpd as _httpd
from metrics_tpu_torch.utils.exceptions import MetricsUserError

PORT_ENV = "METRICS_TPU_SERVE_PORT"

# the shard-map version header on every clustered response; a 307 carries the
# owning replica in the body (and Location when the owner's URL is known)
SHARD_EPOCH_HEADER = "X-Metrics-Shard-Epoch"

JSON_CONTENT_TYPE = "application/json"
NPY_CONTENT_TYPE = "application/x-npy"
NPZ_CONTENT_TYPE = "application/x-npz"

ENDPOINTS = (
    "/ingest/<tenant>",
    "/read/<tenant>",  # ?max_staleness_steps=K&timeout_s=S&quantiles=0.5,0.99
    "/healthz",
    "/stats.json",
)


def host_value(value: Any) -> np.ndarray:
    """A metric value on the host: a tensor copied off its device, a list of
    tensors (BinnedAveragePrecision's per-class values) copied element by
    element and stacked, as ``np.asarray`` stacks a list of arrays."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, (list, tuple)):
        return np.asarray([host_value(v) for v in value])
    return np.asarray(value)


class DeadlineMissed(Exception):
    """A staleness-bounded read timed out waiting for the dispatcher."""

    def __init__(self, tenant_id: Any, pending: int, bound: int) -> None:
        super().__init__(
            f"read deadline missed: tenant {tenant_id!r} is {pending} steps "
            f"stale (bound {bound})"
        )
        self.tenant_id = tenant_id
        self.pending = pending
        self.bound = bound


class UnknownTenant(KeyError):
    pass


class IngestPipeline:
    """ingest -> batch -> dispatch -> serve, minus the HTTP skin.

    Args:
        tenant_set: the :class:`metrics_tpu_torch.tenancy.TenantSet` to feed (a
            Metric/MetricCollection template is wrapped into one).
        queue_capacity / per_tenant_cap / retry_after_s: admission bounds
            (see :class:`~metrics_tpu_torch.serve.coalesce.BoundedIngestQueue`).
        max_coalesce_width: widest device dispatch the coalescer builds.
        read_timeout_s: default wait bound for staleness-constrained reads.
        name: label for the ``metrics_tpu_ingest_*`` series.
    """

    kind = "local"

    def __init__(
        self,
        tenant_set: Any,
        queue_capacity: int = 256,
        per_tenant_cap: Optional[int] = None,
        retry_after_s: float = 1.0,
        max_coalesce_width: int = 64,
        read_timeout_s: float = 5.0,
        max_retries: int = 8,
        name: str = "ingest",
    ) -> None:
        from metrics_tpu_torch.tenancy import TenantSet

        if not getattr(tenant_set, "_is_tenant_set", False):
            tenant_set = TenantSet(tenant_set)
        self.tenant_set = tenant_set
        self.name = name
        self.read_timeout_s = float(read_timeout_s)
        self.queue = BoundedIngestQueue(
            capacity=queue_capacity,
            per_tenant_cap=per_tenant_cap,
            retry_after_s=retry_after_s,
            name=name,
        )
        # the ledger: per-tenant admitted/applied/dead counts behind one
        # condition — every staleness question is answered here
        self._cond = threading.Condition()
        self._admitted: Dict[Any, int] = {}
        self._applied: Dict[Any, int] = {}
        self._dead: Dict[Any, int] = {}
        self._known: set = set(tenant_set.tenant_ids())
        # per-tenant migration fences: tenant -> Retry-After hint (seconds).
        # A fenced tenant is rejected with "tenant_fenced" (429) while the
        # cluster tier moves its state — distinct from the global "draining".
        self._fenced: Dict[Any, float] = {}
        # optional shard-ownership gate installed by the cluster tier: a
        # callable ``(tenant_id) -> Optional[dict]`` returning redirect info
        # ({"owner", "epoch", optional "location"}) for tenants this replica
        # does not own, or None when the post may proceed.
        self.shard_gate: Optional[Any] = None
        self.apply_lock = threading.Lock()
        self.dispatcher = Dispatcher(
            tenant_set,
            self.queue,
            apply_lock=self.apply_lock,
            on_applied=self._on_applied,
            on_dead_letter=self._on_dead_letter,
            max_width=max_coalesce_width,
            max_retries=max_retries,
            name=f"{name}-dispatcher",
        )
        self.started_monotonic = time.monotonic()
        _instruments.register_ingest_pipeline(self)

    # ------------------------------------------------------------------ #
    # ledger callbacks (dispatcher thread)
    # ------------------------------------------------------------------ #
    def _on_applied(self, ids: Sequence[Any], seqs: Sequence[int]) -> None:
        with self._cond:
            for tid in ids:
                self._applied[tid] = self._applied.get(tid, 0) + 1
            self._cond.notify_all()

    def _on_dead_letter(self, ids: Sequence[Any], seqs: Sequence[int]) -> None:
        with self._cond:
            for tid in ids:
                self._dead[tid] = self._dead.get(tid, 0) + 1
            self._cond.notify_all()

    # ------------------------------------------------------------------ #
    # ingest
    # ------------------------------------------------------------------ #
    def post(self, tenant_id: Union[str, int], *args: Any, **kwargs: Any) -> Admission:
        """Offer one observation batch; returns the admission verdict.

        Rejects (never raises) on backpressure. An injected ingress fault
        (:class:`~metrics_tpu_torch.resilience.chaos.ChaosError` at
        ``serve/ingest``) propagates so the HTTP layer can answer 503 — an
        in-process caller sees it for the same reason: surfaced, not silent.
        """
        # one critical section from the fence check to the ledger's count:
        # a fence set meanwhile either rejects this post or finds it counted,
        # so drain_tenant cannot settle while an admitted step is uncounted
        with self._cond:
            fence_retry = self._fenced.get(tenant_id)
            if fence_retry is not None:
                return self.queue.reject(
                    Observation(tenant_id), "tenant_fenced", retry_after_s=fence_retry,
                )
            if self.shard_gate is not None and self.shard_gate.check(tenant_id) is not None:
                return self.queue.reject(Observation(tenant_id), "not_owner")
            if tenant_id not in self._known and len(self._known) >= self.tenant_set.capacity:
                return self.queue.reject(Observation(tenant_id), "tenant_capacity")
            admission = self.queue.offer(Observation(tenant_id, args, dict(kwargs)))
            if admission.admitted:
                self._known.add(tenant_id)
                self._admitted[tenant_id] = self._admitted.get(tenant_id, 0) + 1
        return admission

    # ------------------------------------------------------------------ #
    # per-tenant fencing + ledger surgery (the cluster migration protocol)
    # ------------------------------------------------------------------ #
    def fence_tenant(self, tenant_id: Any, retry_after_s: Optional[float] = None) -> None:
        """Reject new posts for one tenant with ``"tenant_fenced"`` (429).

        Already-admitted observations keep draining through the dispatcher —
        fencing is admission control only, so a migration can wait for the
        ledger to settle (:meth:`drain_tenant`) without pausing other
        tenants. ``retry_after_s`` is the hint echoed to clients (defaults
        to the queue's).
        """
        with self._cond:
            self._fenced[tenant_id] = (
                self.queue.retry_after_s if retry_after_s is None
                else float(retry_after_s)
            )

    def unfence_tenant(self, tenant_id: Any) -> None:
        with self._cond:
            self._fenced.pop(tenant_id, None)
            self._cond.notify_all()

    def fenced_tenants(self) -> Tuple[Any, ...]:
        with self._cond:
            return tuple(sorted(self._fenced, key=str))

    def pending_steps(self, tenant_id: Any) -> int:
        """Admitted-but-unaccounted steps for one tenant (queue + in flight)."""
        with self._cond:
            return (
                self._admitted.get(tenant_id, 0)
                - self._applied.get(tenant_id, 0)
                - self._dead.get(tenant_id, 0)
            )

    def drain_tenant(self, tenant_id: Any, timeout: float = 30.0) -> bool:
        """Block until one tenant's admitted steps are all applied or
        dead-lettered. Unlike :meth:`drain` this does not close admission —
        fence the tenant first or the wait may never settle under load.
        Returns ``False`` on timeout."""
        with self._cond:
            return self._cond.wait_for(
                lambda: (
                    self._admitted.get(tenant_id, 0)
                    - self._applied.get(tenant_id, 0)
                    - self._dead.get(tenant_id, 0)
                ) <= 0,
                timeout,
            )

    def seed_ledger(self, tenant_id: Any, applied_steps: int) -> None:
        """Install a migrated tenant's ledger row (admitted == applied).

        Called by the cluster tier after ``import_tenant`` so
        ``last_applied_step`` continues monotonically on the destination
        replica instead of restarting at zero.
        """
        steps = int(applied_steps)
        with self._cond:
            self._known.add(tenant_id)
            self._admitted[tenant_id] = steps
            self._applied[tenant_id] = steps
            self._dead.setdefault(tenant_id, 0)
            self._cond.notify_all()

    def forget_tenant(self, tenant_id: Any) -> None:
        """Drop a tenant's ledger row and fence (after migrating it away)."""
        with self._cond:
            self._known.discard(tenant_id)
            self._admitted.pop(tenant_id, None)
            self._applied.pop(tenant_id, None)
            self._dead.pop(tenant_id, None)
            self._fenced.pop(tenant_id, None)
            self._cond.notify_all()

    def last_applied_steps(self) -> Dict[str, int]:
        """``{tenant: applied steps}`` — the coordinator's occupancy signal."""
        with self._cond:
            return {str(t): self._applied.get(t, 0) for t in sorted(self._known, key=str)}

    # ------------------------------------------------------------------ #
    # serve
    # ------------------------------------------------------------------ #
    def staleness(self, tenant_id: Any) -> Tuple[int, int, int]:
        """``(admitted, applied, dead)`` ledger row for one tenant."""
        with self._cond:
            return (
                self._admitted.get(tenant_id, 0),
                self._applied.get(tenant_id, 0),
                self._dead.get(tenant_id, 0),
            )

    def read(
        self,
        tenant_id: Union[str, int],
        max_staleness_steps: Optional[int] = None,
        timeout_s: Optional[float] = None,
        quantiles: Optional[Sequence[float]] = None,
    ) -> Dict[str, Any]:
        """One tenant's metric values with the explicit staleness contract.

        ``max_staleness_steps=K`` blocks until at most ``K`` admitted steps
        remain unapplied (dead-lettered steps can never apply, so they do
        not count against the bound — they are surfaced separately); a wait
        past ``timeout_s`` raises :class:`DeadlineMissed`.

        ``quantiles`` evaluates extra quantiles from every ``QuantileSketch``
        state of the tenant (see :meth:`TenantSet.read_quantiles`) into a
        ``"quantiles"`` key — readers are not limited to the ``q`` the
        template metric was constructed with.
        """
        if _chaos.active:
            _chaos.maybe_fail("serve/read", tenant=str(tenant_id))
        t0_us = _otrace._now_us() if _otrace.active else 0
        with self._cond:
            if tenant_id not in self._known:
                raise UnknownTenant(tenant_id)
            if max_staleness_steps is not None:
                bound = int(max_staleness_steps)
                deadline = timeout_s if timeout_s is not None else self.read_timeout_s

                def _caught_up() -> bool:
                    pending = (
                        self._admitted.get(tenant_id, 0)
                        - self._applied.get(tenant_id, 0)
                        - self._dead.get(tenant_id, 0)
                    )
                    return pending <= bound

                if not self._cond.wait_for(_caught_up, deadline):
                    pending = (
                        self._admitted.get(tenant_id, 0)
                        - self._applied.get(tenant_id, 0)
                        - self._dead.get(tenant_id, 0)
                    )
                    _REGISTRY.counter(
                        "ingest_deadline_missed_total",
                        "Staleness-bounded reads that timed out waiting for "
                        "the dispatcher.",
                        queue=self.name,
                    ).inc()
                    raise DeadlineMissed(tenant_id, pending, bound)
            admitted = self._admitted.get(tenant_id, 0)
            applied = self._applied.get(tenant_id, 0)
            dead = self._dead.get(tenant_id, 0)
        values: Optional[Dict[str, Any]] = None
        quantile_values: Optional[Dict[str, Dict[str, float]]] = None
        # the apply lock serializes compute against the dispatcher's stacked
        # update, so a read never sees a half-applied dispatch
        with self.apply_lock:
            if tenant_id in self.tenant_set._slot_of:
                raw = self.tenant_set.compute([tenant_id])[tenant_id]
                values = {k: host_value(v).tolist() for k, v in raw.items()}
                if quantiles is not None:
                    quantile_values = {
                        name: {repr(float(q)): v for q, v in zip(quantiles, vals)}
                        for name, vals in self.tenant_set.read_quantiles(
                            tenant_id, quantiles
                        ).items()
                    }
        doc = {
            "tenant": tenant_id,
            "values": values,
            "last_applied_step": applied,
            "admitted_steps": admitted,
            "staleness_steps": max(0, admitted - applied - dead),
            "dead_lettered_steps": dead,
        }
        if max_staleness_steps is not None:
            doc["max_staleness_steps"] = int(max_staleness_steps)
        if quantile_values is not None:
            doc["quantiles"] = quantile_values
        if _otrace.active:
            _otrace.emit_complete(
                "serve/read", "serve", t0_us, _otrace._now_us() - t0_us,
                tenant=str(tenant_id), staleness=doc["staleness_steps"],
            )
        return doc

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def start(self) -> "IngestPipeline":
        self.dispatcher.start()
        return self

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until every admitted observation is applied (or
        dead-lettered — accounted, either way). Returns False on timeout."""
        t0_us = _otrace._now_us() if _otrace.active else 0
        deadline = time.monotonic() + timeout

        def _accounted() -> bool:
            with self._cond:
                admitted = sum(self._admitted.values())
                applied = sum(self._applied.values())
                dead = sum(self._dead.values())
            return len(self.queue) == 0 and admitted == applied + dead

        while not _accounted():
            if time.monotonic() >= deadline:
                return False
            with self._cond:
                self._cond.wait(0.05)
        if _otrace.active:
            _otrace.emit_complete(
                "serve/drain", "serve", t0_us, _otrace._now_us() - t0_us,
                applied=sum(self._applied.values()),
            )
        return True

    def stop(self, drain: bool = True, timeout: float = 30.0) -> bool:
        """Graceful shutdown: close admission, drain, stop the dispatcher.

        With ``drain=True`` (the default) every already-admitted batch is
        applied before the consumer exits — offers arriving during the
        drain are rejected with ``"draining"``. Returns the drain verdict.
        """
        self.queue.close()
        ok = self.drain(timeout) if drain else True
        self.dispatcher.stop(timeout)
        return ok

    # ------------------------------------------------------------------ #
    def stats(self) -> Dict[str, Any]:
        """The full serving-state document (also ``GET /stats.json``)."""
        with self._cond:
            admitted = dict(self._admitted)
            applied = dict(self._applied)
            dead = dict(self._dead)
            fenced = tuple(sorted(self._fenced, key=str))
        ts = self.tenant_set
        part = ts.partition_view()
        return {
            "name": self.name,
            "uptime_s": round(time.monotonic() - self.started_monotonic, 3),
            "queue": {
                "depth": len(self.queue),
                "capacity": self.queue.capacity,
                "per_tenant_cap": self.queue.per_tenant_cap,
                "closed": self.queue.closed,
                "admitted_total": self.queue.admitted_total,
                "rejected_total": self.queue.rejected_total,
            },
            "ledger": {
                "tenants": len(self._known),
                "admitted": sum(admitted.values()),
                "applied": sum(applied.values()),
                "dead_lettered": sum(dead.values()),
                "fenced": [str(t) for t in fenced],
                "per_tenant": {
                    str(t): {
                        "admitted": admitted.get(t, 0),
                        "applied": applied.get(t, 0),
                        "dead_lettered": dead.get(t, 0),
                        "last_applied_step": applied.get(t, 0),
                        "pending": max(
                            0,
                            admitted.get(t, 0) - applied.get(t, 0) - dead.get(t, 0),
                        ),
                    }
                    for t in sorted(self._known, key=str)
                },
            },
            "dispatcher": {
                "running": self.dispatcher.running,
                "dispatches": self.dispatcher.stats.dispatches,
                "observations": self.dispatcher.stats.observations,
                "retries": self.dispatcher.stats.retries,
                "dead_letters": self.dispatcher.stats.dead_letters,
                "max_width": self.dispatcher.stats.max_width,
                "last_width": self.dispatcher.stats.last_width,
                "error": self.dispatcher.error,
            },
            "tenant_set": {
                "capacity": ts.capacity,
                "active": ts.active_count,
                "compiles": ts.stats.compiles,
                "cache_hits": ts.stats.cache_hits,
                "dispatches": ts.stats.dispatches,
                "last_bucket": ts.stats.last_bucket,
                "partition_builds": part["builds"],
                "partition_stable_hits": part["stable_hits"],
            },
        }


# --------------------------------------------------------------------------- #
# body codecs
# --------------------------------------------------------------------------- #
def decode_body(content_type: str, body: bytes) -> Tuple[Tuple, Dict[str, Any]]:
    """``(args, kwargs)`` from a request body (see the module docstring)."""
    ctype = (content_type or "").split(";", 1)[0].strip().lower()
    if ctype == NPY_CONTENT_TYPE:
        arr = np.load(io.BytesIO(body), allow_pickle=False)
        return (arr,), {}
    if ctype == NPZ_CONTENT_TYPE:
        with np.load(io.BytesIO(body), allow_pickle=False) as npz:
            positional: List[Tuple[int, np.ndarray]] = []
            kwargs: Dict[str, Any] = {}
            for key in npz.files:
                if key.startswith("arg"):
                    positional.append((int(key[3:]), npz[key]))
                elif key.startswith("kw_"):
                    kwargs[key[3:]] = npz[key]
                else:
                    raise ValueError(
                        f"npz entry {key!r}: expected 'arg<i>' or 'kw_<name>'"
                    )
            positional.sort()
            return tuple(a for _, a in positional), kwargs
    if ctype in (JSON_CONTENT_TYPE, "", "text/json"):
        doc = json.loads(body.decode("utf-8"))
        if not isinstance(doc, dict):
            raise ValueError("JSON body must be an object with 'args'/'kwargs'")
        args = tuple(_json_leaf(a) for a in doc.get("args", ()))
        kwargs = {k: _json_leaf(v) for k, v in (doc.get("kwargs") or {}).items()}
        return args, kwargs
    raise ValueError(f"unsupported Content-Type {content_type!r}")


def _json_leaf(value: Any) -> Any:
    if isinstance(value, dict) and "data" in value:
        return np.asarray(value["data"], dtype=np.dtype(value.get("dtype", "float32")))
    if isinstance(value, list):
        return np.asarray(value)
    return value  # static config scalar


def encode_npz(*args: np.ndarray, **kwargs: np.ndarray) -> bytes:
    """The byte-exact body for ``POST /ingest`` (client helper + tests)."""
    buf = io.BytesIO()
    np.savez(
        buf,
        **{f"arg{i}": np.asarray(a) for i, a in enumerate(args)},
        **{f"kw_{k}": np.asarray(v) for k, v in kwargs.items()},
    )
    return buf.getvalue()


# marker entry of a batched npz body: its scalar value is the step count and
# every arg/kw array carries that count as a leading axis
STEPS_KEY = "__steps__"


def encode_npz_steps(*args: np.ndarray, **kwargs: np.ndarray) -> bytes:
    """A batched ``POST /ingest`` body: one request, many steps.

    Every array carries a leading *step* axis of equal length S; the server
    slices the body back into S per-step observations and admits them in
    order, amortizing the HTTP round trip over the whole window. Slicing is
    byte-exact, so ``offline_replay`` of the per-step log stays the bitwise
    oracle for batched posts too.
    """
    arrays = [np.asarray(a) for a in args] + [np.asarray(v) for v in kwargs.values()]
    if not arrays:
        raise ValueError("a batched body needs at least one array argument")
    lead = {a.shape[0] if a.ndim else None for a in arrays}
    if None in lead or len(lead) != 1:
        raise ValueError(
            f"every array must share one leading step axis, got shapes "
            f"{[a.shape for a in arrays]}"
        )
    steps = lead.pop()
    if steps < 1:
        raise ValueError("a batched body needs at least one step")
    buf = io.BytesIO()
    np.savez(
        buf,
        **{STEPS_KEY: np.asarray(steps, dtype=np.int64)},
        **{f"arg{i}": np.asarray(a) for i, a in enumerate(args)},
        **{f"kw_{k}": np.asarray(v) for k, v in kwargs.items()},
    )
    return buf.getvalue()


def decode_steps(content_type: str, body: bytes) -> Tuple[List[Tuple[Tuple, Dict[str, Any]]], bool]:
    """``([(args, kwargs), ...], batched)`` from a request body.

    A plain body (:func:`decode_body` vocabulary) decodes to one step with
    ``batched=False``. An ``application/x-npz`` body carrying the
    :data:`STEPS_KEY` marker decodes to S per-step ``(args, kwargs)`` tuples
    — numpy basic slicing of the step axis, byte-exact — with
    ``batched=True``.
    """
    ctype = (content_type or "").split(";", 1)[0].strip().lower()
    if ctype == NPZ_CONTENT_TYPE:
        with np.load(io.BytesIO(body), allow_pickle=False) as npz:
            if STEPS_KEY in npz.files:
                steps = int(npz[STEPS_KEY])
                if steps < 1:
                    raise ValueError(f"{STEPS_KEY} must be >= 1, got {steps}")
                positional: List[Tuple[int, np.ndarray]] = []
                kwargs: Dict[str, np.ndarray] = {}
                for key in npz.files:
                    if key == STEPS_KEY:
                        continue
                    if key.startswith("arg"):
                        positional.append((int(key[3:]), npz[key]))
                    elif key.startswith("kw_"):
                        kwargs[key[3:]] = npz[key]
                    else:
                        raise ValueError(
                            f"npz entry {key!r}: expected 'arg<i>', 'kw_<name>', or {STEPS_KEY!r}"
                        )
                positional.sort()
                for label, arr in [(f"arg{i}", a) for i, a in positional] + [
                    (f"kw_{k}", v) for k, v in kwargs.items()
                ]:
                    if arr.ndim == 0 or arr.shape[0] != steps:
                        raise ValueError(
                            f"batched npz entry {label!r} has shape {arr.shape}; "
                            f"expected a leading step axis of {steps}"
                        )
                return [
                    (
                        tuple(a[i] for _, a in positional),
                        {k: v[i] for k, v in kwargs.items()},
                    )
                    for i in range(steps)
                ], True
    return [decode_body(content_type, body)], False


# --------------------------------------------------------------------------- #
# the HTTP skin
# --------------------------------------------------------------------------- #
class _IngestHandler(BaseHTTPRequestHandler):
    ingest_server: "IngestServer"

    protocol_version = "HTTP/1.1"
    # a response is two writes (headers, then body): with Nagle's algorithm
    # on, the body waits for the client's delayed ACK of the headers, about
    # 40 ms a request on a kept-alive connection
    disable_nagle_algorithm = True

    def log_message(self, format: str, *args: Any) -> None:  # noqa: A002
        pass  # ingest traffic is telemetry, not log lines

    # -------------------------------------------------------------- #
    def _send_json(self, status: int, doc: Dict[str, Any],
                   retry_after: Optional[str] = None,
                   extra_headers: Optional[Dict[str, str]] = None) -> None:
        body = json.dumps(doc).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if retry_after is not None:
            self.send_header("Retry-After", retry_after)
        gate = self.ingest_server.pipeline.shard_gate
        if gate is not None:
            # every clustered response advertises the map version, so a
            # client with a stale map learns about a cutover from any reply
            self.send_header(SHARD_EPOCH_HEADER, str(gate.epoch))
        for name, value in (extra_headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def _tenant_from(self, path: str, prefix: str) -> str:
        return urllib.parse.unquote(path[len(prefix):])

    def _shard_redirect(self, tenant_id: str, prefix: str) -> bool:
        """Answer ``307 + X-Metrics-Shard-Epoch`` if another replica owns
        this tenant; returns True when the response was sent."""
        gate = self.ingest_server.pipeline.shard_gate
        if gate is None:
            return False
        info = gate.check(tenant_id)
        if info is None:
            return False
        headers: Dict[str, str] = {}
        location = info.get("location")
        if location:
            headers["Location"] = f"{location}{prefix}{urllib.parse.quote(str(tenant_id))}"
        self._send_json(
            307,
            {
                "error": "not_owner",
                "tenant": tenant_id,
                "owner": str(info.get("owner")),
                "epoch": int(info.get("epoch", 0)),
            },
            extra_headers=headers,
        )
        return True

    # -------------------------------------------------------------- #
    def do_POST(self) -> None:  # noqa: N802 — http.server API
        try:
            path = self.path.split("?", 1)[0]
            if not path.startswith("/ingest/"):
                self._send_json(404, {"error": f"unknown path {path!r}",
                                      "endpoints": list(ENDPOINTS)})
                return
            tenant_id = self._tenant_from(path, "/ingest/")
            if not tenant_id:
                self._send_json(400, {"error": "missing tenant id"})
                return
            if self._shard_redirect(tenant_id, "/ingest/"):
                return
            length = int(self.headers.get("Content-Length", "0") or "0")
            if length > self.ingest_server.max_body_bytes:
                self._send_json(413, {"error": "body too large",
                                      "max_bytes": self.ingest_server.max_body_bytes})
                return
            body = self.rfile.read(length)
            try:
                steps, batched = decode_steps(self.headers.get("Content-Type", ""), body)
            except Exception as err:  # noqa: BLE001 — malformed bodies -> 400
                self._send_json(400, {"error": f"bad body: {err}"})
                return
            # admit the steps in order; the first rejection stops the batch so
            # the admitted prefix is exactly what offline_replay will see, and
            # the client knows from admitted_steps where to resume
            seqs: List[int] = []
            admission = None
            try:
                for args, kwargs in steps:
                    admission = self.ingest_server.pipeline.post(tenant_id, *args, **kwargs)
                    if not admission.admitted:
                        break
                    seqs.append(admission.seq)
            except _chaos.ChaosError as err:
                # injected ingress fault: surfaced as a retryable 503
                doc = {"admitted": False, "reason": "fault", "error": str(err)}
                if batched:
                    doc.update(steps=len(steps), admitted_steps=len(seqs), seqs=seqs)
                self._send_json(503, doc, retry_after="1")
                return
            if admission is not None and admission.admitted:
                doc = {
                    "admitted": True,
                    "tenant": tenant_id,
                    "seq": admission.seq,
                    "queue_depth": admission.queue_depth,
                }
                if batched:
                    doc.update(steps=len(steps), admitted_steps=len(seqs), seqs=seqs)
                self._send_json(200, doc)
            else:
                status = 503 if admission.reason == "draining" else 429
                doc = {
                    "admitted": False,
                    "tenant": tenant_id,
                    "reason": admission.reason,
                    "queue_depth": admission.queue_depth,
                    "retry_after_s": admission.retry_after_s,
                }
                if batched:
                    doc.update(steps=len(steps), admitted_steps=len(seqs), seqs=seqs)
                self._send_json(status, doc, retry_after=admission.retry_after_header)
        except BrokenPipeError:
            return
        except Exception as err:  # noqa: BLE001 — a request must never kill the thread
            try:
                self._send_json(500, {"error": f"{type(err).__name__}: {err}"})
            except Exception:
                pass

    # -------------------------------------------------------------- #
    def do_GET(self) -> None:  # noqa: N802 — http.server API
        try:
            path, _, query = self.path.partition("?")
            params = urllib.parse.parse_qs(query)
            if path.startswith("/read/"):
                tenant_id = self._tenant_from(path, "/read/")
                if self._shard_redirect(tenant_id, "/read/"):
                    return
                self._get_read(tenant_id, params)
            elif path == "/healthz":
                self._get_healthz()
            elif path == "/stats.json":
                self._send_json(200, self.ingest_server.pipeline.stats())
            else:
                self._send_json(404, {"error": f"unknown path {path!r}",
                                      "endpoints": list(ENDPOINTS)})
        except BrokenPipeError:
            return
        except Exception as err:  # noqa: BLE001
            try:
                self._send_json(500, {"error": f"{type(err).__name__}: {err}"})
            except Exception:
                pass

    def _get_read(self, tenant_id: str, params: Dict[str, List[str]]) -> None:
        max_staleness = params.get("max_staleness_steps")
        timeout = params.get("timeout_s")
        raw_qs = params.get("quantiles")
        quantiles: Optional[List[float]] = None
        if raw_qs:
            try:
                quantiles = [float(q) for q in raw_qs[0].split(",") if q.strip()]
            except ValueError:
                self._send_json(
                    400, {"error": f"malformed quantiles={raw_qs[0]!r}: expected "
                                   "a comma-separated list of floats in [0, 1]"})
                return
        try:
            doc = self.ingest_server.pipeline.read(
                tenant_id,
                max_staleness_steps=int(max_staleness[0]) if max_staleness else None,
                timeout_s=float(timeout[0]) if timeout else None,
                quantiles=quantiles,
            )
        except MetricsUserError as err:
            self._send_json(400, {"error": str(err), "tenant": tenant_id})
            return
        except UnknownTenant:
            self._send_json(404, {"error": f"unknown tenant {tenant_id!r}"})
            return
        except DeadlineMissed as err:
            self._send_json(
                503,
                {
                    "error": str(err),
                    "reason": "deadline_missed",
                    "tenant": tenant_id,
                    "staleness_steps": err.pending,
                    "max_staleness_steps": err.bound,
                },
                retry_after="1",
            )
            return
        except _chaos.ChaosError as err:
            self._send_json(503, {"error": str(err), "reason": "fault",
                                  "tenant": tenant_id}, retry_after="1")
            return
        self._send_json(200, doc)

    def _get_healthz(self) -> None:
        pipeline = self.ingest_server.pipeline
        dispatcher = pipeline.dispatcher
        # queue depth, dead letters and the per-tenant applied watermark are
        # the coordinator's rebalance inputs — healthz is the one endpoint a
        # cluster control loop polls, so the occupancy signal lives here too
        self._send_json(200, {
            "status": "degraded" if dispatcher.error else "ok",
            "uptime_s": round(time.monotonic() - pipeline.started_monotonic, 3),
            "queue_depth": len(pipeline.queue),
            "queue_capacity": pipeline.queue.capacity,
            "draining": pipeline.queue.closed,
            "dispatcher_alive": dispatcher.running,
            "dead_letters": dispatcher.stats.dead_letters,
            "tenants": pipeline.tenant_set.active_count,
            "fenced_tenants": [str(t) for t in pipeline.fenced_tenants()],
            "last_applied_step": pipeline.last_applied_steps(),
        })


def _make_handler(server: "IngestServer") -> type:
    return type("IngestHandler", (_IngestHandler,), {"ingest_server": server})


class IngestServer:
    """The HTTP ingestion server; usually managed through :func:`serve`."""

    kind = "http"

    def __init__(
        self,
        tenant_set: Any,
        port: int = 0,
        host: str = "127.0.0.1",
        max_body_bytes: int = 64 * 1024 * 1024,
        **pipeline_kwargs: Any,
    ) -> None:
        if getattr(tenant_set, "kind", None) == "local" and hasattr(tenant_set, "queue"):
            self.pipeline: IngestPipeline = tenant_set  # pre-built pipeline
        else:
            self.pipeline = IngestPipeline(tenant_set, **pipeline_kwargs)
        self.host = host
        self.max_body_bytes = int(max_body_bytes)
        self._life = _httpd.DaemonHTTPServer(
            _make_handler(self), host=host, port=port,
            thread_name="metrics-tpu-ingest-server",
        )

    # ------------------------------------------------------------------ #
    @property
    def port(self) -> int:
        return self._life.port

    @property
    def url(self) -> str:
        return self._life.url

    @property
    def running(self) -> bool:
        return self._life.running

    @property
    def tenant_set(self) -> Any:
        return self.pipeline.tenant_set

    def start(self) -> "IngestServer":
        """Bind (raises ``OSError`` on a taken port — :func:`serve` turns
        that into the local-pipeline fallback) and start the dispatcher."""
        self._life.start()
        self.pipeline.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> bool:
        """Graceful shutdown: stop accepting, drain, stop everything."""
        self.pipeline.queue.close()  # reject new work before the socket dies
        ok = self.pipeline.stop(drain=drain, timeout=timeout)
        self._life.stop(timeout=min(timeout, 5.0))
        return ok

    def drain(self, timeout: float = 30.0) -> bool:
        """Wait for the queue to be fully applied without closing admission."""
        return self.pipeline.drain(timeout)

    def stats(self) -> Dict[str, Any]:
        return self.pipeline.stats()


ServerOrLocal = Union[IngestServer, IngestPipeline]

# process-wide singleton managed by serve()/shutdown()
_server: Optional[ServerOrLocal] = None
_server_lock = threading.Lock()


def serve(
    tenant_set: Any = None,
    port: Optional[int] = None,
    host: str = "127.0.0.1",
    fallback_local: bool = False,
    **kwargs: Any,
) -> ServerOrLocal:
    """Start (or return) the process-wide ingestion server.

    ``port`` defaults to ``$METRICS_TPU_SERVE_PORT``, else 0 (OS-assigned).
    When binding fails and ``fallback_local=True``, degrades to the bare
    :class:`IngestPipeline` (kind ``"local"``) — ingest/read keep working
    in-process and the shared-pod job survives the taken port. Idempotent:
    a second call returns the live handle.
    """
    global _server
    with _server_lock:
        if _server is not None and (
            _server.kind == "local" or _server.running
        ):
            return _server
        if tenant_set is None:
            raise MetricsUserError(
                "metrics_tpu_torch.serve.serve() needs a TenantSet (or a "
                "Metric/MetricCollection template) on first call"
            )
        port = _httpd.resolve_port(port, PORT_ENV)
        server = IngestServer(tenant_set, port=port, host=host, **kwargs)

        def _fallback(err: OSError) -> IngestPipeline:
            pipeline = server.pipeline
            pipeline.fallback_reason = f"bind {host}:{port} failed: {err}"
            return pipeline.start()

        _server = _httpd.start_with_fallback(
            server.start, _fallback if fallback_local else None,
        )
        return _server


def get_server() -> Optional[ServerOrLocal]:
    """The live process-wide server/pipeline handle (``None`` when stopped)."""
    return _server


def shutdown(drain: bool = True, timeout: float = 30.0) -> None:
    """Drain and stop the process-wide server (if any). Idempotent."""
    global _server
    with _server_lock:
        server, _server = _server, None
    if server is not None:
        server.stop(drain=drain, timeout=timeout)
