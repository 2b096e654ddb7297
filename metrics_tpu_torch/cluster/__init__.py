"""metrics_tpu_torch.cluster — the scale-out serving tier.

Counterpart of ``metrics_tpu/cluster/``: host code around the port's
serve stacks, whose TenantSets hold their state on the card.

N ingestion replicas (each a full :mod:`metrics_tpu_torch.serve` stack over its own
TenantSet) own disjoint tenant shards behind a versioned
:class:`ShardMap` (rendezvous placement, explicit pins). The
:class:`ClusterCoordinator` is the control plane: it drives live tenant
migration (fence → drain → export → streamed transfer → import → epoch-bump
cutover, chaos-proofed so no step is ever lost or double-applied), plans and
executes rebalances from ledger occupancy, and restores a dead replica's
shard from its latest verifiable checkpoint while the rest of the cluster
keeps serving. :class:`ClusterClient` routes directly on a map copy and
follows ``307 + X-Metrics-Shard-Epoch`` redirects when stale.
"""
from metrics_tpu_torch.cluster.client import ClusterClient
from metrics_tpu_torch.cluster.coordinator import ClusterCoordinator, CoordinatorServer
from metrics_tpu_torch.cluster.migrate import (
    MigrationError,
    MigrationRecord,
    PHASES,
    run_migration,
)
from metrics_tpu_torch.cluster.replica import Replica, ReplicaLost, ShardGate
from metrics_tpu_torch.cluster.shardmap import Move, ShardMap, plan_rebalance, rendezvous_owner
from metrics_tpu_torch.cluster.wire import (
    Frame,
    TenantTransfer,
    TransferError,
    TransferPlan,
    decode_tenant_snapshot,
    encode_tenant_snapshot,
    iter_frames,
    plan_transfer,
)

__all__ = [
    "ClusterClient",
    "ClusterCoordinator",
    "CoordinatorServer",
    "Frame",
    "MigrationError",
    "MigrationRecord",
    "Move",
    "PHASES",
    "Replica",
    "ReplicaLost",
    "ShardGate",
    "ShardMap",
    "TenantTransfer",
    "TransferError",
    "TransferPlan",
    "decode_tenant_snapshot",
    "encode_tenant_snapshot",
    "iter_frames",
    "plan_rebalance",
    "plan_transfer",
    "rendezvous_owner",
    "run_migration",
]
