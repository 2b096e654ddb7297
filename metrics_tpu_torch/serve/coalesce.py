"""The bounded ingest queue and ragged-arrival coalescer.

Counterpart of ``metrics_tpu/serve/coalesce.py``: host code only, the same
queue, admission rules, coalescing and chaos sites.

This is the backpressure point of the serving stack: every observation batch
a client posts lands here as one :class:`Observation` (one tenant's rows for
one logical step), and the dispatcher thread drains it. The queue enforces
two admission rules **at offer time**, so overload is surfaced to the client
as an explicit rejection instead of unbounded memory growth or silent drops:

* **global bound** — at most ``capacity`` observations queued; a full queue
  rejects with ``"queue_full"`` and a ``Retry-After`` hint;
* **per-tenant fairness cap** — at most ``per_tenant_cap`` queued
  observations per tenant, so one hot tenant saturating the ingress cannot
  starve everyone else's slots (rejects with ``"tenant_cap"``).

The consumer side coalesces: :meth:`BoundedIngestQueue.pop_coalesced` takes
the longest FIFO-respecting prefix of queued observations with **distinct
tenants** and one argument signature, up to ``max_width`` — exactly the shape
:meth:`metrics_tpu_torch.tenancy.TenantSet.update` wants (one row per tenant,
pow2-bucketed on the device side, so queue-depth churn never retraces). Two
queued observations from the same tenant stay ordered: only the first
occurrence per tenant joins a coalesced batch, the rest wait for the next
one. While the device executes the current batch the queue keeps admitting —
the ingest/compute overlap the fused-collective papers apply on the device,
applied host-side.

Chaos: the admission path is a fault point (``serve/ingest``); an injected
fault is surfaced to the client as a rejection (``"fault"``), never a silent
drop. The consumer pull is another (``serve/coalesce``) — a latency fault
there is the deterministic "slow consumer" scenario that fills the queue.
"""
from __future__ import annotations

import math
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from metrics_tpu_torch.observability import tracer as _otrace
from metrics_tpu_torch.observability.instruments import REGISTRY as _REGISTRY
from metrics_tpu_torch.resilience import chaos as _chaos

# pow2 buckets for the coalesce-width histogram — widths are pow2-bucketed
# downstream, so these are the natural bin edges
COALESCE_WIDTH_BUCKETS = tuple(float(2 ** i) for i in range(11))  # 1 .. 1024


def _leaf_signature(value: Any) -> Tuple:
    if isinstance(value, np.ndarray):
        return ("a", value.shape, str(value.dtype))
    return ("s", type(value).__name__, repr(value))


@dataclass
class Observation:
    """One tenant's posted batch: the unit of admission, queueing, dispatch.

    ``args``/``kwargs`` leaves are host ``np.ndarray`` rows (one logical
    update step for this tenant) or hashable static config. ``seq`` is the
    queue-assigned global admission number — the offline-replay order.
    """

    tenant_id: Any
    args: Tuple[Any, ...] = ()
    kwargs: Dict[str, Any] = field(default_factory=dict)
    seq: int = -1

    def signature(self) -> Tuple:
        """Stacking compatibility key: treedef + per-leaf shape/dtype."""
        return (
            tuple(_leaf_signature(a) for a in self.args),
            tuple(sorted((k, _leaf_signature(v)) for k, v in self.kwargs.items())),
        )


@dataclass(frozen=True)
class Admission:
    """The queue's verdict on one offer — what the HTTP layer echoes back."""

    admitted: bool
    seq: int = -1
    queue_depth: int = 0
    # "" | "queue_full" | "tenant_cap" | "tenant_capacity" | "draining" |
    # "fault" | "tenant_fenced" (a live migration is moving this tenant) |
    # "not_owner" (this replica does not own the tenant's shard)
    reason: str = ""
    retry_after_s: float = 0.0

    @property
    def retry_after_header(self) -> str:
        """``Retry-After`` as HTTP delta-seconds (integer, >= 1)."""
        return str(max(1, math.ceil(self.retry_after_s)))


class BoundedIngestQueue:
    """Bounded FIFO of :class:`Observation` with per-tenant fairness caps.

    Thread-safe: offers come from HTTP handler threads, pops from the one
    dispatcher thread, all under one condition variable. ``close()`` starts
    the graceful drain — new offers are rejected (``"draining"``) while the
    consumer keeps popping until empty, so every admitted observation is
    still applied.
    """

    def __init__(
        self,
        capacity: int = 256,
        per_tenant_cap: Optional[int] = None,
        retry_after_s: float = 1.0,
        name: str = "ingest",
    ) -> None:
        if capacity < 1:
            raise ValueError(f"ingest queue capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        # default cap: a quarter of the queue (min 1) — one tenant can burst,
        # but can never take every slot
        self.per_tenant_cap = (
            int(per_tenant_cap) if per_tenant_cap is not None
            else max(1, self.capacity // 4)
        )
        if self.per_tenant_cap < 1:
            raise ValueError("per_tenant_cap must be >= 1")
        self.retry_after_s = float(retry_after_s)
        self.name = name
        self._items: deque = deque()
        self._per_tenant: Dict[Any, int] = {}
        self._cond = threading.Condition()
        self._seq = 0
        self._closed = False
        self.admitted_total = 0
        self.rejected_total = 0

    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        return len(self._items)

    @property
    def closed(self) -> bool:
        return self._closed

    def tenant_depth(self, tenant_id: Any) -> int:
        with self._cond:
            return self._per_tenant.get(tenant_id, 0)

    # ------------------------------------------------------------------ #
    def offer(self, obs: Observation) -> Admission:
        """Admit or reject one observation; never blocks the caller."""
        if _chaos.active:
            # an ingress fault is a *rejection surfaced to the client* — the
            # handler catches ChaosError and answers 503 + Retry-After
            _chaos.maybe_fail("serve/ingest", tenant=str(obs.tenant_id))
        with self._cond:
            if self._closed:
                return self._reject(obs, "draining")
            if len(self._items) >= self.capacity:
                return self._reject(obs, "queue_full")
            if self._per_tenant.get(obs.tenant_id, 0) >= self.per_tenant_cap:
                return self._reject(obs, "tenant_cap")
            self._seq += 1
            obs.seq = self._seq
            self._items.append(obs)
            self._per_tenant[obs.tenant_id] = self._per_tenant.get(obs.tenant_id, 0) + 1
            self.admitted_total += 1
            depth = len(self._items)
            self._cond.notify_all()
        _REGISTRY.counter(
            "ingest_admitted_total",
            "Observation batches admitted to the ingest queue.",
            queue=self.name,
        ).inc()
        if _otrace.active:
            _otrace.emit_instant(
                "serve/ingest", "serve",
                tenant=str(obs.tenant_id), seq=obs.seq, queue_depth=depth,
            )
        return Admission(True, seq=obs.seq, queue_depth=depth)

    def reject(
        self, obs: Observation, reason: str,
        retry_after_s: Optional[float] = None,
    ) -> Admission:
        """Record a rejection decided *outside* the queue's own bounds.

        The pipeline uses this for admission verdicts the queue cannot see —
        tenant-set capacity, a per-tenant migration fence, shard ownership —
        so every rejection ticks the same ``ingest_rejected_total`` counter
        and carries the same ``Retry-After`` contract.
        """
        with self._cond:
            return self._reject(obs, reason, retry_after_s=retry_after_s)

    def _reject(
        self, obs: Observation, reason: str,
        retry_after_s: Optional[float] = None,
    ) -> Admission:
        # called under the lock
        self.rejected_total += 1
        depth = len(self._items)
        _REGISTRY.counter(
            "ingest_rejected_total",
            "Observation batches rejected at admission, by reason.",
            queue=self.name, reason=reason,
        ).inc()
        if _otrace.active:
            _otrace.emit_instant(
                "serve/reject", "serve",
                tenant=str(obs.tenant_id), reason=reason, queue_depth=depth,
            )
        return Admission(
            False, queue_depth=depth, reason=reason,
            retry_after_s=(
                self.retry_after_s if retry_after_s is None else float(retry_after_s)
            ),
        )

    # ------------------------------------------------------------------ #
    def pop_coalesced(
        self, max_width: int = 64, timeout: Optional[float] = 0.5
    ) -> Optional[List[Observation]]:
        """The longest distinct-tenant, one-signature FIFO prefix (<= width).

        Blocks up to ``timeout`` for the first item; returns ``None`` on an
        empty timeout or a closed-and-drained queue. The chaos site
        ``serve/coalesce`` fires only when there is work to pull, so an
        error fault never loses an observation (nothing was removed yet) and
        a latency fault models the slow consumer.
        """
        with self._cond:
            if not self._items:
                if self._closed:
                    return None
                self._cond.wait(timeout)
            if not self._items:
                return None
        if _chaos.active:
            _chaos.maybe_fail("serve/coalesce")
        with self._cond:
            if not self._items:
                return None
            head = self._items[0]
            sig = head.signature()
            taken: List[Observation] = []
            seen: set = set()
            kept: deque = deque()
            for obs in self._items:
                if (
                    len(taken) < max_width
                    and obs.tenant_id not in seen
                    and obs.signature() == sig
                ):
                    taken.append(obs)
                    seen.add(obs.tenant_id)
                else:
                    kept.append(obs)
            self._items = kept
            for obs in taken:
                n = self._per_tenant.get(obs.tenant_id, 0) - 1
                if n <= 0:
                    self._per_tenant.pop(obs.tenant_id, None)
                else:
                    self._per_tenant[obs.tenant_id] = n
            self._cond.notify_all()
        _REGISTRY.histogram(
            "ingest_coalesce_width",
            "Distinct tenants coalesced into one device dispatch.",
            buckets=COALESCE_WIDTH_BUCKETS, queue=self.name,
        ).observe(float(len(taken)))
        if _otrace.active:
            _otrace.emit_instant(
                "serve/coalesce", "serve",
                width=len(taken), queue_depth=len(self._items),
            )
        return taken

    # ------------------------------------------------------------------ #
    def close(self) -> None:
        """Stop admitting; wakes the consumer so it can drain and exit."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def reopen(self) -> None:
        """Accept traffic again (tests / rolling restarts)."""
        with self._cond:
            self._closed = False
            self._cond.notify_all()

    def wait_empty(self, timeout: Optional[float] = None) -> bool:
        """Block until every queued observation has been popped."""
        with self._cond:
            return self._cond.wait_for(lambda: not self._items, timeout)
