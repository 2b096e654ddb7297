"""The live-migration state machine: one tenant, src → dst, never half-moved.

Counterpart of ``metrics_tpu/cluster/migrate.py``.

Phase order and the invariant each one protects::

    fence     src rejects new posts for the tenant (per-tenant 429 +
              Retry-After, reason "tenant_fenced" — the global drain is a
              different verdict). Nothing admitted after this point can race
              the move; rejected clients replay after cutover.
    drain     wait for the src ledger to settle: every admitted step for the
              tenant is applied or dead-lettered. Dead-lettered steps stay
              dead — they were accounted to the client when they died.
    export    single-row gather of the tenant's state under the apply lock,
              copied to the host (``TenantSet.export_tenant``).
    transfer  checksummed frames, one leaf resident at a time (wire.py);
              truncation or corruption fails verification, never imports.
    import    single-row scatter on dst (a captured write on its device)
              + ledger seed at the snapshot's
              update count, so ``last_applied_step`` continues monotonically.
    cutover   one shard-map epoch bump pinning the tenant to dst — the only
              step that changes routing, and it is atomic under the
              coordinator's map lock.
    (post-commit) evict the tenant from src and lift the fence.

Every phase boundary is a chaos site (``cluster/*``) that fires **before**
the phase mutates anything, so an injected fault aborts a move that has not
happened yet. Abort is total rollback: a partial import is evicted from dst,
the fence lifts, the map never changed — the tenant's one true copy is still
on src and no step was lost or double-applied. The chaos suite proves this
bitwise against the ``offline_replay`` oracle at every site plus a src kill.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from metrics_tpu_torch.observability import tracer as _otrace
from metrics_tpu_torch.resilience import chaos as _chaos
from metrics_tpu_torch.cluster.replica import Replica
from metrics_tpu_torch.cluster.wire import TenantTransfer, iter_frames

__all__ = ["MigrationError", "MigrationRecord", "PHASES", "run_migration"]

PHASES = ("fence", "drain", "export", "transfer", "import", "cutover", "done")


class MigrationError(RuntimeError):
    """A migration phase failed; the move was rolled back (state on src)."""


@dataclass
class MigrationRecord:
    """One migration attempt — phase reached, outcome, and its timings
    (``downtime_s`` is the fence → cutover window during which the tenant's
    writes are rejected-with-retry)."""

    tenant: str
    src: str
    dst: str
    phase: str = "pending"
    outcome: str = "pending"   # "committed" | "aborted"
    error: str = ""
    epoch: int = 0
    frames: int = 0
    bytes: int = 0
    downtime_s: float = 0.0
    started_monotonic: float = field(default_factory=time.monotonic)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "tenant": self.tenant, "src": self.src, "dst": self.dst,
            "phase": self.phase, "outcome": self.outcome, "error": self.error,
            "epoch": self.epoch, "frames": self.frames, "bytes": self.bytes,
            "downtime_s": round(self.downtime_s, 6),
        }


def _enter(record: MigrationRecord, phase: str,
           on_phase: Optional[Callable[[str], None]]) -> None:
    record.phase = phase
    if _otrace.active:
        _otrace.emit_instant(
            f"cluster/{phase}", "cluster",
            tenant=record.tenant, src=record.src, dst=record.dst,
        )
    if on_phase is not None:
        on_phase(phase)


def run_migration(
    tenant: Any,
    src: Replica,
    dst: Replica,
    bump_map: Callable[[str, str], int],
    *,
    chunk_bytes: int = 1 << 20,
    drain_timeout: float = 30.0,
    retry_after_s: Optional[float] = None,
    on_phase: Optional[Callable[[str], None]] = None,
) -> MigrationRecord:
    """Drive one tenant move; returns the record, committed or aborted.

    ``bump_map(tenant, dst_id)`` is the coordinator's atomic cutover — it
    pins the tenant and returns the new epoch. ``on_phase`` is called at
    every phase entry (progress reporting; the chaos suite also uses it to
    kill the source mid-move).
    """
    tenant_key = str(tenant)
    record = MigrationRecord(tenant=tenant_key, src=src.replica_id, dst=dst.replica_id)
    fenced_at: Optional[float] = None
    imported = False
    try:
        if tenant not in src.pipeline._known and tenant_key not in map(
            str, src.tenant_ids()
        ):
            raise MigrationError(
                f"tenant {tenant!r} is not resident on {src.replica_id!r}"
            )
        _enter(record, "fence", on_phase)
        if _chaos.active:
            _chaos.maybe_fail("cluster/fence", tenant=tenant_key, src=src.replica_id)
        src.fence_tenant(tenant, retry_after_s)
        fenced_at = time.monotonic()

        _enter(record, "drain", on_phase)
        if not src.drain_tenant(tenant, drain_timeout):
            raise MigrationError(
                f"drain of {tenant!r} on {src.replica_id!r} timed out after "
                f"{drain_timeout}s ({src.pipeline.pending_steps(tenant)} pending)"
            )

        _enter(record, "export", on_phase)
        if _chaos.active:
            _chaos.maybe_fail("cluster/export", tenant=tenant_key, src=src.replica_id)
        snapshot = src.export_tenant(tenant)

        _enter(record, "transfer", on_phase)
        receiver = TenantTransfer()
        for frame in iter_frames(snapshot, chunk_bytes):
            if _chaos.active:
                _chaos.maybe_fail(
                    "cluster/transfer", tenant=tenant_key, seq=frame.seq,
                )
            receiver.feed(frame, frame.digest)
            record.frames += 1
            record.bytes += len(frame.payload)
        verified = receiver.finish()

        _enter(record, "import", on_phase)
        if _chaos.active:
            _chaos.maybe_fail("cluster/import", tenant=tenant_key, dst=dst.replica_id)
        dst.import_tenant(tenant, verified)
        imported = True

        _enter(record, "cutover", on_phase)
        if _chaos.active:
            _chaos.maybe_fail("cluster/cutover", tenant=tenant_key, dst=dst.replica_id)
        record.epoch = bump_map(tenant_key, dst.replica_id)

        # post-commit: routing already points at dst; clearing src is
        # best-effort and can never un-commit the move
        src.evict_tenant(tenant)
        record.downtime_s = time.monotonic() - fenced_at
        record.phase = "done"
        record.outcome = "committed"
    except BaseException as err:  # noqa: BLE001 — every failure rolls back
        record.outcome = "aborted"
        record.error = f"{type(err).__name__}: {err}"
        if fenced_at is not None:
            record.downtime_s = time.monotonic() - fenced_at
        # rollback: the one true copy stays on src; a partial import on dst
        # is discarded so nothing can ever double-apply
        if imported:
            try:
                dst.evict_tenant(tenant)
            except Exception:  # noqa: BLE001 — rollback is best-effort
                pass
        try:
            src.unfence_tenant(tenant)
        except Exception:  # noqa: BLE001
            pass
        if _otrace.active:
            _otrace.emit_instant(
                "cluster/abort", "cluster",
                tenant=tenant_key, phase=record.phase, error=record.error,
            )
    return record
