"""The cluster coordinator: shard map authority, migration orchestration, recovery.

Counterpart of ``metrics_tpu/cluster/coordinator.py``.

One coordinator owns the versioned :class:`~metrics_tpu_torch.cluster.ShardMap`
and a handle on every ingestion replica. Replicas never talk to each other —
the coordinator drives every control-plane action:

* **routing authority** — each replica's :class:`ShardGate` reads the
  coordinator's live map, so one epoch bump under the map lock re-routes the
  whole cluster atomically (replicas answer ``307 + X-Metrics-Shard-Epoch``
  for tenants they stopped owning, clients refresh and follow);
* **migration orchestration** — :meth:`migrate` runs the fence → drain → export →
  transfer → import → cutover state machine (:mod:`.migrate`), serialized so
  two moves can never race one tenant; :meth:`plan_rebalance` /
  :meth:`rebalance` apply the occupancy cost model over the replicas'
  ledgers;
* **failure domain** — a dead replica leaves the cluster *degraded but
  serving*: every other shard keeps ingesting and reading, and
  :meth:`recover_replica` restores the lost shard from its latest
  verifiable checkpoint (``metrics_tpu_torch.checkpoint``), re-seeds the ledger
  from the restored update counts, and bumps the epoch so clients re-learn
  the topology.

Everything is stdlib: the optional status endpoint is the same
:class:`~metrics_tpu_torch.utils.httpd.DaemonHTTPServer` lifecycle as the obs
scrape server and the ingest server. ``metrics_tpu_cluster_*`` Prometheus
series come from the instruments registry; every phase emits a ``cluster/*``
tracer event when tracing is on.
"""
from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler
from typing import Any, Callable, Dict, List, Optional, Sequence

from metrics_tpu_torch.observability import instruments as _instruments
from metrics_tpu_torch.observability import tracer as _otrace
from metrics_tpu_torch.observability.instruments import REGISTRY as _REGISTRY
from metrics_tpu_torch.resilience import chaos as _chaos
from metrics_tpu_torch.utils import httpd as _httpd
from metrics_tpu_torch.utils.exceptions import MetricsUserError
from metrics_tpu_torch.cluster.migrate import MigrationRecord, run_migration
from metrics_tpu_torch.cluster.replica import Replica, ShardGate
from metrics_tpu_torch.cluster.shardmap import Move, ShardMap, plan_rebalance

__all__ = ["ClusterCoordinator", "CoordinatorServer"]

# fence windows span sub-millisecond in-process moves to multi-second
# wide-tenant transfers
FENCE_SECONDS_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class ClusterCoordinator:
    """N disjoint tenant shards behind one versioned routing table."""

    def __init__(
        self,
        replicas: Dict[str, Any],
        shard_map: Optional[ShardMap] = None,
        checkpoint_root: Optional[str] = None,
        name: str = "cluster",
    ) -> None:
        if not replicas:
            raise MetricsUserError("ClusterCoordinator needs at least one replica")
        self.name = name
        self.checkpoint_root = checkpoint_root
        self.replicas: Dict[str, Replica] = {
            rid: stack if isinstance(stack, Replica) else Replica(rid, stack)
            for rid, stack in replicas.items()
        }
        self._map = shard_map or ShardMap(tuple(sorted(self.replicas)))
        missing = set(self._map.replicas) - set(self.replicas)
        if missing:
            raise MetricsUserError(
                f"shard map names replicas with no handle: {sorted(missing)}"
            )
        self._map_lock = threading.RLock()
        self._migration_lock = threading.Lock()
        self.migrations: List[MigrationRecord] = []
        for rid, replica in self.replicas.items():
            replica.install_gate(
                ShardGate(rid, lambda: self._map, self._url_of)
            )
        _instruments.register_cluster(self)

    # ------------------------------------------------------------------ #
    # routing
    # ------------------------------------------------------------------ #
    @property
    def shard_map(self) -> ShardMap:
        return self._map

    def owner(self, tenant: Any) -> str:
        return self._map.owner(tenant)

    def replica_of(self, tenant: Any) -> Replica:
        return self.replicas[self._map.owner(tenant)]

    def _url_of(self, replica_id: str) -> Optional[str]:
        replica = self.replicas.get(replica_id)
        return replica.url if replica is not None else None

    def _bump_map(self, fn: Callable[[ShardMap], ShardMap]) -> int:
        with self._map_lock:
            self._map = fn(self._map)
            return self._map.epoch

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def start(self) -> "ClusterCoordinator":
        for replica in self.replicas.values():
            replica.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> bool:
        ok = True
        for replica in self.replicas.values():
            if replica.alive:
                ok = replica.stop(drain=drain, timeout=timeout) and ok
        return ok

    # ------------------------------------------------------------------ #
    # migration
    # ------------------------------------------------------------------ #
    def migrate(
        self,
        tenant: Any,
        dst: str,
        src: Optional[str] = None,
        *,
        chunk_bytes: int = 1 << 20,
        drain_timeout: float = 30.0,
        retry_after_s: Optional[float] = None,
        on_phase: Optional[Callable[[str], None]] = None,
    ) -> MigrationRecord:
        """Move one tenant to ``dst``; returns the committed/aborted record.

        ``src`` defaults to the current owner. Serialized cluster-wide: the
        shard map is the single source of routing truth and two concurrent
        moves of one tenant would race the cutover.
        """
        if dst not in self.replicas:
            raise MetricsUserError(f"unknown destination replica {dst!r}")
        src_id = src if src is not None else self._map.owner(tenant)
        if src_id not in self.replicas:
            raise MetricsUserError(f"unknown source replica {src_id!r}")
        if src_id == dst:
            raise MetricsUserError(
                f"tenant {tenant!r} already lives on {dst!r}; nothing to migrate"
            )
        with self._migration_lock:
            record = run_migration(
                tenant,
                self.replicas[src_id],
                self.replicas[dst],
                self._cutover,
                chunk_bytes=chunk_bytes,
                drain_timeout=drain_timeout,
                retry_after_s=retry_after_s,
                on_phase=on_phase,
            )
            self.migrations.append(record)
        _REGISTRY.counter(
            "cluster_migrations_total",
            "Tenant migrations by deepest phase reached and outcome.",
            cluster=self.name, phase=record.phase, outcome=record.outcome,
        ).inc()
        if record.downtime_s:
            _REGISTRY.histogram(
                "cluster_fence_seconds",
                "Per-tenant write-unavailability window of one migration "
                "(fence to cutover).",
                buckets=FENCE_SECONDS_BUCKETS, cluster=self.name,
            ).observe(record.downtime_s)
        return record

    def _cutover(self, tenant: str, dst: str) -> int:
        return self._bump_map(lambda m: m.with_pin(tenant, dst))

    # ------------------------------------------------------------------ #
    # rebalance
    # ------------------------------------------------------------------ #
    def occupancy(self) -> Dict[str, Dict[str, float]]:
        """Per-replica per-tenant load weights from the live ledgers."""
        return {
            rid: replica.occupancy()
            for rid, replica in self.replicas.items()
            if replica.alive
        }

    def plan_rebalance(
        self, *, tolerance: float = 0.10, max_moves: Optional[int] = None,
    ) -> List[Move]:
        return plan_rebalance(
            self._map, self.occupancy(), tolerance=tolerance, max_moves=max_moves,
        )

    def rebalance(
        self,
        plan: Optional[Sequence[Move]] = None,
        *,
        tolerance: float = 0.10,
        max_moves: Optional[int] = None,
        chunk_bytes: int = 1 << 20,
    ) -> List[MigrationRecord]:
        """Execute a rebalance plan (or compute one) move by move."""
        moves = list(plan) if plan is not None else self.plan_rebalance(
            tolerance=tolerance, max_moves=max_moves,
        )
        records = [
            self.migrate(m.tenant, m.dst, src=m.src, chunk_bytes=chunk_bytes)
            for m in moves
        ]
        if _otrace.active:
            _otrace.emit_instant(
                "cluster/rebalance", "cluster",
                moves=len(moves),
                committed=sum(1 for r in records if r.outcome == "committed"),
            )
        return records

    def add_replica(self, replica_id: str, stack: Any) -> Replica:
        """Grow the cluster by one replica (2 → 3 is the canonical scale-out).

        Every live tenant is pinned to its current owner *before* the
        replica list changes, so consistent-hash churn cannot route reads at
        a replica that holds no state — a follow-up :meth:`rebalance`
        migrates tenants onto the new shard explicitly.
        """
        if replica_id in self.replicas:
            raise MetricsUserError(f"replica {replica_id!r} already exists")
        replica = stack if isinstance(stack, Replica) else Replica(replica_id, stack)
        live: List[str] = []
        for other in self.replicas.values():
            live.extend(str(t) for t in other.tenant_ids())
        self.replicas[replica_id] = replica
        replica.install_gate(ShardGate(replica_id, lambda: self._map, self._url_of))
        self._bump_map(
            lambda m: m.with_replicas(
                tuple(sorted((*m.replicas, replica_id))), live,
            )
        )
        replica.start()
        return replica

    # ------------------------------------------------------------------ #
    # failure + recovery
    # ------------------------------------------------------------------ #
    def checkpoint_replica(self, replica_id: str, step: int) -> Optional[str]:
        """Snapshot one replica's TenantSet shard under the cluster root."""
        if self.checkpoint_root is None:
            return None
        from metrics_tpu_torch.checkpoint import save_checkpoint

        replica = self.replicas[replica_id]
        root = os.path.join(self.checkpoint_root, replica_id)
        with replica.pipeline.apply_lock:
            return save_checkpoint(replica.tenant_set, root, step)

    def checkpoint_all(self, step: int) -> Dict[str, Optional[str]]:
        return {
            rid: self.checkpoint_replica(rid, step)
            for rid, replica in sorted(self.replicas.items())
            if replica.alive
        }

    def mark_lost(self, replica_id: str) -> None:
        """Record a replica death; the rest of the cluster keeps serving."""
        replica = self.replicas[replica_id]
        if replica.alive:
            replica.kill()
        if _otrace.active:
            _otrace.emit_instant(
                "cluster/replica_lost", "cluster", replica=replica_id,
            )
        _REGISTRY.counter(
            "cluster_replica_losses_total",
            "Replica deaths observed by the coordinator.",
            cluster=self.name, replica=replica_id,
        ).inc()

    def recover_replica(self, replica_id: str, stack: Any) -> Replica:
        """Bring a lost replica back from its latest verifiable checkpoint.

        ``stack`` is a fresh serve stack (or template) whose TenantSet the
        restore is applied to. The ledger is re-seeded from the restored
        update counts — ``last_applied_step`` resumes at the checkpointed
        watermark, and anything a client posted after that checkpoint was
        never acknowledged as applied, so its retry loop replays it. Ends
        with an epoch bump so stale clients re-learn the topology.
        """
        replica = self.replicas[replica_id]
        if replica.alive:
            raise MetricsUserError(f"replica {replica_id!r} is not lost")
        if _chaos.active:
            _chaos.maybe_fail("cluster/recover", replica=replica_id)
        replica.revive(stack)
        if self.checkpoint_root is not None:
            from metrics_tpu_torch.checkpoint import restore_checkpoint

            root = os.path.join(self.checkpoint_root, replica_id)
            restore_checkpoint(
                replica.tenant_set, root, fallback_to_verified=True,
            )
            ts = replica.tenant_set
            for tid in ts.tenant_ids():
                replica.pipeline.seed_ledger(
                    tid, int(ts._update_counts[ts._slot_of[tid]])
                )
        replica.start()
        self._bump_map(lambda m: m)  # epoch bump: clients refresh routing
        if _otrace.active:
            _otrace.emit_instant(
                "cluster/replica_restored", "cluster",
                replica=replica_id, tenants=replica.tenant_set.active_count,
            )
        return replica

    # ------------------------------------------------------------------ #
    def status(self) -> Dict[str, Any]:
        """The operator document (also ``GET /status.json``)."""
        committed = sum(1 for r in self.migrations if r.outcome == "committed")
        aborted = sum(1 for r in self.migrations if r.outcome == "aborted")
        replicas = {
            rid: replica.status() for rid, replica in sorted(self.replicas.items())
        }
        return {
            "name": self.name,
            "epoch": self._map.epoch,
            "degraded": any(not r.alive for r in self.replicas.values()),
            "replicas": replicas,
            "shard_sizes": {
                rid: replicas[rid].get("tenants", 0) for rid in replicas
            },
            "pins": len(self._map.pins),
            "migrations": {
                "total": len(self.migrations),
                "committed": committed,
                "aborted": aborted,
                "last": self.migrations[-1].to_dict() if self.migrations else None,
            },
        }

    def serve_status(self, port: int = 0, host: str = "127.0.0.1") -> "CoordinatorServer":
        return CoordinatorServer(self, port=port, host=host).start()


# --------------------------------------------------------------------------- #
# the read-only status endpoint
# --------------------------------------------------------------------------- #
class _CoordinatorHandler(BaseHTTPRequestHandler):
    coordinator_server: "CoordinatorServer"

    protocol_version = "HTTP/1.1"

    def log_message(self, format: str, *args: Any) -> None:  # noqa: A002
        pass

    def _send_json(self, status: int, doc: Dict[str, Any]) -> None:
        body = json.dumps(doc).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 — http.server API
        try:
            coordinator = self.coordinator_server.coordinator
            path = self.path.split("?", 1)[0]
            if path == "/status.json":
                self._send_json(200, coordinator.status())
            elif path == "/shardmap":
                self._send_json(200, coordinator.shard_map.to_dict())
            elif path == "/healthz":
                degraded = any(not r.alive for r in coordinator.replicas.values())
                self._send_json(200, {
                    "status": "degraded" if degraded else "ok",
                    "epoch": coordinator.shard_map.epoch,
                    "replicas": len(coordinator.replicas),
                    "uptime_s": round(
                        time.monotonic() - self.coordinator_server.started_monotonic, 3
                    ),
                })
            else:
                self._send_json(404, {
                    "error": f"unknown path {path!r}",
                    "endpoints": ["/status.json", "/shardmap", "/healthz"],
                })
        except BrokenPipeError:
            return
        except Exception as err:  # noqa: BLE001 — a request must never kill the thread
            try:
                self._send_json(500, {"error": f"{type(err).__name__}: {err}"})
            except Exception:
                pass


class CoordinatorServer:
    """Read-only cluster introspection over HTTP (status / shardmap / healthz)."""

    def __init__(
        self, coordinator: ClusterCoordinator, port: int = 0, host: str = "127.0.0.1",
    ) -> None:
        self.coordinator = coordinator
        self.started_monotonic = time.monotonic()
        handler = type(
            "CoordinatorHandler", (_CoordinatorHandler,),
            {"coordinator_server": self},
        )
        self._life = _httpd.DaemonHTTPServer(
            handler, host=host, port=port,
            thread_name="metrics-tpu-cluster-coordinator",
        )

    @property
    def port(self) -> int:
        return self._life.port

    @property
    def url(self) -> str:
        return self._life.url

    @property
    def running(self) -> bool:
        return self._life.running

    def start(self) -> "CoordinatorServer":
        self._life.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._life.stop(timeout=timeout)
