"""``python -m metrics_tpu_torch.cluster`` — cluster status / plan / migrate / rebalance.

Counterpart of ``metrics_tpu/cluster/__main__.py``. The demo cluster's
TenantSets live on the card (``--device cuda``, the default); ``--device
cpu`` runs it on the host. Without a card and without ``--device cpu`` the
demo raises, as a metric built on the card without one does.

Subcommands::

    status    --url http://coordinator:PORT    poll a live coordinator's
              /status.json (or --demo for an in-process cluster)
    plan      --demo [--device D]              print the rebalance plan the
              occupancy cost model proposes
    migrate   --demo --tenant T --dst R [--src R] [--device D]
                                               run one live migration and
              print the phase/outcome record
    rebalance --demo [--add-replica] [--device D]
                                               plan + execute; with
              --add-replica, grow the cluster by one replica first (the
              2 → 3 scale-out) and rebalance onto it

Every command prints one JSON document to stdout. ``--demo`` builds a
deterministic in-process cluster (2 replicas, 8 tenants with skewed load) so
the control-plane verbs can be exercised, demonstrated and tested without
any deployment; point ``--url`` at a :class:`CoordinatorServer` for the real
thing.
"""
from __future__ import annotations

import argparse
import json
import sys
import urllib.request
from typing import Any, Dict, Tuple


def _demo_collection(device: str) -> Any:
    from metrics_tpu_torch import Accuracy, MeanSquaredError, MetricCollection

    return MetricCollection({
        "acc": Accuracy(num_classes=4, average="micro", device=device),
        "mse": MeanSquaredError(device=device),
    })


def _build_demo(replicas: int = 2, tenants: int = 8, device: str = "cuda") -> Tuple[Any, Any]:
    """A deterministic in-process cluster with skewed tenant load."""
    import numpy as np

    from metrics_tpu_torch.serve import IngestPipeline
    from metrics_tpu_torch.cluster import ClusterClient, ClusterCoordinator

    coordinator = ClusterCoordinator({
        f"r{i}": IngestPipeline(_demo_collection(device), name=f"demo-r{i}")
        for i in range(replicas)
    }, name="demo").start()
    client = ClusterClient(
        {rid: rep for rid, rep in coordinator.replicas.items()}, coordinator,
    )
    rng = np.random.default_rng(0)
    for i in range(tenants):
        steps = 1 + 3 * (i % 3)  # skewed: every third tenant is 4x hot
        for _ in range(steps):
            preds = rng.integers(0, 4, size=(8,)).astype(np.int32)
            target = rng.integers(0, 4, size=(8,)).astype(np.int32)
            client.post_with_retry(f"tenant-{i}", preds, target)
    for replica in coordinator.replicas.values():
        replica.pipeline.drain(30.0)
    return coordinator, client


def _emit(doc: Dict[str, Any]) -> None:
    json.dump(doc, sys.stdout, indent=2, sort_keys=True)
    sys.stdout.write("\n")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m metrics_tpu_torch.cluster",
        description="Cluster serving tier: status, rebalance planning, live migration.",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p_status = sub.add_parser("status", help="cluster status document")
    p_status.add_argument("--url", help="coordinator base URL")
    p_status.add_argument("--demo", action="store_true")

    p_plan = sub.add_parser("plan", help="print the proposed rebalance moves")
    p_plan.add_argument("--demo", action="store_true", required=True)
    p_plan.add_argument("--tolerance", type=float, default=0.10)

    p_migrate = sub.add_parser("migrate", help="move one tenant between replicas")
    p_migrate.add_argument("--demo", action="store_true", required=True)
    p_migrate.add_argument("--tenant", required=True)
    p_migrate.add_argument("--dst", required=True)
    p_migrate.add_argument("--src")

    p_rebalance = sub.add_parser("rebalance", help="plan and execute a rebalance")
    p_rebalance.add_argument("--demo", action="store_true", required=True)
    p_rebalance.add_argument("--add-replica", action="store_true",
                             help="grow the cluster by one replica first")
    p_rebalance.add_argument("--tolerance", type=float, default=0.10)

    for p in (p_status, p_plan, p_migrate, p_rebalance):
        p.add_argument("--device", default="cuda",
                       help="where the demo cluster's state lives (default: cuda)")

    args = parser.parse_args(argv)

    if args.command == "status":
        if args.url:
            with urllib.request.urlopen(
                f"{args.url.rstrip('/')}/status.json", timeout=10
            ) as resp:
                _emit(json.loads(resp.read().decode()))
            return 0
        if not args.demo:
            parser.error("status needs --url or --demo")
        coordinator, _ = _build_demo(device=args.device)
        try:
            _emit(coordinator.status())
        finally:
            coordinator.stop()
        return 0

    coordinator, client = _build_demo(device=args.device)
    try:
        if args.command == "plan":
            moves = coordinator.plan_rebalance(tolerance=args.tolerance)
            _emit({
                "epoch": coordinator.shard_map.epoch,
                "occupancy": coordinator.occupancy(),
                "moves": [m.to_dict() for m in moves],
            })
        elif args.command == "migrate":
            record = coordinator.migrate(args.tenant, args.dst, src=args.src)
            _emit(record.to_dict())
            return 0 if record.outcome == "committed" else 1
        elif args.command == "rebalance":
            if args.add_replica:
                from metrics_tpu_torch.serve import IngestPipeline

                new_id = f"r{len(coordinator.replicas)}"
                coordinator.add_replica(new_id, IngestPipeline(
                    _demo_collection(args.device), name=f"demo-{new_id}",
                ))
            records = coordinator.rebalance(tolerance=args.tolerance)
            _emit({
                "epoch": coordinator.shard_map.epoch,
                "migrations": [r.to_dict() for r in records],
                "shard_sizes": coordinator.status()["shard_sizes"],
            })
            return 0 if all(r.outcome == "committed" for r in records) else 1
    finally:
        coordinator.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
