"""One ingestion replica as the cluster coordinator sees it.

Counterpart of ``metrics_tpu/cluster/replica.py``.

A :class:`Replica` wraps a full serve stack — an
:class:`~metrics_tpu_torch.serve.IngestPipeline` (or the pipeline inside an
:class:`~metrics_tpu_torch.serve.IngestServer`) over its own TenantSet — and gives
the coordinator the handful of verbs the migration protocol needs: fence /
drain / export on the source side, import / ledger-seed on the destination,
occupancy for the rebalance planner, and checkpoint save/restore for
crash recovery. It also installs the :class:`ShardGate` that makes the
replica answer ``307 + X-Metrics-Shard-Epoch`` for tenants it does not own.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional

from metrics_tpu_torch.serve.server import IngestPipeline, IngestServer

__all__ = ["Replica", "ReplicaLost", "ShardGate"]


class ReplicaLost(RuntimeError):
    """The replica's serve stack is gone (crash / kill) — callers must treat
    in-flight work against it as failed and re-route after recovery."""

    def __init__(self, replica_id: str, action: str) -> None:
        super().__init__(f"replica {replica_id!r} is lost ({action})")
        self.replica_id = replica_id


class ShardGate:
    """The ownership check a clustered pipeline consults on every request.

    ``check(tenant)`` returns ``None`` when this replica owns the tenant
    under the coordinator's *live* shard map, else the redirect document the
    HTTP layer turns into ``307 + Location + X-Metrics-Shard-Epoch``. The
    gate holds no map copy — it reads through ``map_source`` so one epoch
    bump at the coordinator re-routes every replica atomically.
    """

    def __init__(
        self,
        replica_id: str,
        map_source: Callable[[], Any],
        url_of: Optional[Callable[[str], Optional[str]]] = None,
    ) -> None:
        self.replica_id = replica_id
        self._map_source = map_source
        self._url_of = url_of or (lambda _replica: None)

    @property
    def epoch(self) -> int:
        return self._map_source().epoch

    def check(self, tenant_id: Any) -> Optional[Dict[str, Any]]:
        shard_map = self._map_source()
        owner = shard_map.owner(tenant_id)
        if owner == self.replica_id:
            return None
        return {
            "owner": owner,
            "epoch": shard_map.epoch,
            "location": self._url_of(owner),
        }


class Replica:
    """Coordinator-side handle on one serve stack (in-process or HTTP)."""

    def __init__(self, replica_id: str, stack: Any) -> None:
        if isinstance(stack, IngestServer):
            self.server: Optional[IngestServer] = stack
            self.pipeline: IngestPipeline = stack.pipeline
        elif isinstance(stack, IngestPipeline):
            self.server = None
            self.pipeline = stack
        else:
            self.server = None
            self.pipeline = IngestPipeline(stack, name=f"cluster-{replica_id}")
        self.replica_id = replica_id
        self._lock = threading.Lock()
        self._alive = True

    # ------------------------------------------------------------------ #
    @property
    def alive(self) -> bool:
        return self._alive

    @property
    def url(self) -> Optional[str]:
        return self.server.url if self.server is not None and self.server.running else None

    @property
    def tenant_set(self) -> Any:
        return self.pipeline.tenant_set

    def _require_alive(self, action: str) -> None:
        if not self._alive:
            raise ReplicaLost(self.replica_id, action)

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def install_gate(self, gate: ShardGate) -> None:
        self.pipeline.shard_gate = gate

    def start(self) -> "Replica":
        if self.server is not None:
            self.server.start()
        else:
            self.pipeline.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> bool:
        self._alive = False
        if self.server is not None:
            return self.server.stop(drain=drain, timeout=timeout)
        return self.pipeline.stop(drain=drain, timeout=timeout)

    def kill(self) -> None:
        """Simulated crash: the stack dies without drain; admitted-but-
        unapplied work is lost exactly as a real process death loses it."""
        self._alive = False
        if self.server is not None:
            self.server.stop(drain=False, timeout=1.0)
        else:
            self.pipeline.stop(drain=False, timeout=1.0)

    def revive(self, stack: Any) -> None:
        """Install a fresh serve stack after crash recovery (the coordinator
        restores its TenantSet from the latest verifiable checkpoint)."""
        gate = self.pipeline.shard_gate
        if isinstance(stack, IngestServer):
            self.server = stack
            self.pipeline = stack.pipeline
        elif isinstance(stack, IngestPipeline):
            self.server = None
            self.pipeline = stack
        else:
            self.server = None
            self.pipeline = IngestPipeline(stack, name=f"cluster-{self.replica_id}")
        self.pipeline.shard_gate = gate
        self._alive = True

    # ------------------------------------------------------------------ #
    # the migration verbs
    # ------------------------------------------------------------------ #
    def fence_tenant(self, tenant_id: Any, retry_after_s: Optional[float] = None) -> None:
        self._require_alive("fence")
        self.pipeline.fence_tenant(tenant_id, retry_after_s)

    def unfence_tenant(self, tenant_id: Any) -> None:
        if self._alive:
            self.pipeline.unfence_tenant(tenant_id)

    def drain_tenant(self, tenant_id: Any, timeout: float = 30.0) -> bool:
        self._require_alive("drain")
        return self.pipeline.drain_tenant(tenant_id, timeout)

    def export_tenant(self, tenant_id: Any) -> Dict[str, Any]:
        self._require_alive("export")
        # the apply lock serializes the single-row gather against the
        # dispatcher's stacked update (other tenants keep applying around it,
        # just never *during* the read); the snapshot comes back on the host
        with self.pipeline.apply_lock:
            return self.tenant_set.export_tenant(tenant_id)

    def import_tenant(self, tenant_id: Any, snapshot: Dict[str, Any]) -> int:
        self._require_alive("import")
        with self.pipeline.apply_lock:
            slot = self.tenant_set.import_tenant(tenant_id, snapshot)
        self.pipeline.seed_ledger(tenant_id, int(snapshot.get("update_count", 0)))
        return slot

    def evict_tenant(self, tenant_id: Any) -> None:
        if not self._alive:
            return
        with self.pipeline.apply_lock:
            if tenant_id in self.tenant_set._slot_of:
                self.tenant_set.evict(tenant_id)
        self.pipeline.forget_tenant(tenant_id)

    # ------------------------------------------------------------------ #
    # planner inputs
    # ------------------------------------------------------------------ #
    def occupancy(self) -> Dict[str, float]:
        """Per-tenant load weight: applied steps + live queue contribution."""
        self._require_alive("occupancy")
        weights: Dict[str, float] = dict(
            (t, float(n)) for t, n in self.pipeline.last_applied_steps().items()
        )
        for tenant in list(weights):
            weights[tenant] += float(self.pipeline.queue.tenant_depth(tenant))
        return weights

    def tenant_ids(self) -> tuple:
        return tuple(self.tenant_set.tenant_ids()) if self._alive else ()

    def status(self) -> Dict[str, Any]:
        doc: Dict[str, Any] = {"replica": self.replica_id, "alive": self._alive}
        if self._alive:
            doc.update(
                tenants=self.tenant_set.active_count,
                queue_depth=len(self.pipeline.queue),
                dead_letters=self.pipeline.dispatcher.stats.dead_letters,
                fenced=[str(t) for t in self.pipeline.fenced_tenants()],
                url=self.url,
            )
        return doc
