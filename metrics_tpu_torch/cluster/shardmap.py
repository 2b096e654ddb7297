"""The versioned tenant → replica routing table and the rebalance planner.

Counterpart of ``metrics_tpu/cluster/shardmap.py``: host code, the same
digests, owners, epochs and plans.

A :class:`ShardMap` answers one question — *which replica owns this tenant?*
— deterministically on every host that holds a copy:

* **rendezvous hashing** (highest-random-weight over a stable BLAKE2 digest,
  never Python's randomized ``hash``) places tenants the map has no opinion
  about, so any two processes with the same replica list agree on fresh
  placements with no coordination;
* **explicit pins** override rendezvous for tenants whose state physically
  lives somewhere — every migration ends by pinning the tenant to its new
  home, and growing the replica list first pins all live tenants in place so
  consistent-hash churn can never point routing at a replica that does not
  hold the state.

Maps are immutable; every change (pin, unpin, replica-list change) returns a
new map with ``epoch + 1``. The epoch is the cluster's logical clock: replicas
stamp it on every response (``X-Metrics-Shard-Epoch``) and clients refresh
their copy whenever they see a newer one — the cutover step of a live
migration is exactly one epoch bump.

:func:`plan_rebalance` is the hot-shard/occupancy cost model: given per-tenant
load weights (applied steps and queue depth from each replica's ledger) it
proposes the smallest deterministic sequence of single-tenant moves that
brings every replica within ``tolerance`` of the mean load.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

__all__ = ["Move", "ShardMap", "plan_rebalance", "rendezvous_owner"]

WIRE_VERSION = 1


def _score(tenant: str, replica: str) -> int:
    # stable across processes and PYTHONHASHSEED values; 8 bytes is plenty
    digest = hashlib.blake2b(
        f"{tenant}\x00{replica}".encode("utf-8"), digest_size=8
    ).digest()
    return int.from_bytes(digest, "big")


def rendezvous_owner(tenant: Any, replicas: Sequence[str]) -> str:
    """Highest-random-weight owner of ``tenant`` among ``replicas``."""
    if not replicas:
        raise ValueError("rendezvous over an empty replica list")
    t = str(tenant)
    # ties (astronomically unlikely) break toward the lexically smaller id so
    # every host picks the same winner
    return max(sorted(replicas), key=lambda r: _score(t, r))


@dataclass(frozen=True)
class ShardMap:
    """Immutable, versioned tenant → replica assignment."""

    replicas: Tuple[str, ...]
    epoch: int = 1
    pins: Mapping[str, str] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if not self.replicas:
            raise ValueError("ShardMap needs at least one replica")
        if len(set(self.replicas)) != len(self.replicas):
            raise ValueError(f"duplicate replica ids: {self.replicas}")
        bad = {t: r for t, r in self.pins.items() if r not in self.replicas}
        if bad:
            raise ValueError(f"pins reference unknown replicas: {bad}")

    # ------------------------------------------------------------------ #
    def owner(self, tenant: Any) -> str:
        """The replica that owns ``tenant`` under this map version."""
        pinned = self.pins.get(str(tenant))
        if pinned is not None:
            return pinned
        return rendezvous_owner(tenant, self.replicas)

    def assignment(self, tenants: Iterable[Any]) -> Dict[str, List[str]]:
        """``{replica: [tenant, ...]}`` for a tenant population (sorted)."""
        out: Dict[str, List[str]] = {r: [] for r in self.replicas}
        for t in sorted((str(t) for t in tenants)):
            out[self.owner(t)].append(t)
        return out

    # ------------------------------------------------------------------ #
    # every mutation is a new map one epoch later
    # ------------------------------------------------------------------ #
    def with_pin(self, tenant: Any, replica: str) -> "ShardMap":
        if replica not in self.replicas:
            raise ValueError(f"cannot pin {tenant!r} to unknown replica {replica!r}")
        pins = dict(self.pins)
        pins[str(tenant)] = replica
        return ShardMap(self.replicas, self.epoch + 1, pins)

    def without_pin(self, tenant: Any) -> "ShardMap":
        pins = dict(self.pins)
        pins.pop(str(tenant), None)
        return ShardMap(self.replicas, self.epoch + 1, pins)

    def with_replicas(
        self, replicas: Sequence[str], live_tenants: Iterable[Any] = (),
    ) -> "ShardMap":
        """Change the replica list, pinning ``live_tenants`` in place first.

        Consistent-hash churn from a membership change may re-place a tenant
        whose state never moved; pinning every live tenant to its *current*
        owner before the list changes keeps routing truthful — a later
        rebalance migrates state and re-pins explicitly.
        """
        new = tuple(replicas)
        pins = dict(self.pins)
        for t in live_tenants:
            pins.setdefault(str(t), self.owner(t))
        kept = {t: r for t, r in pins.items() if r in new}
        dropped = {t: r for t, r in pins.items() if r not in new}
        if dropped:
            raise ValueError(
                f"cannot drop replicas still owning pinned tenants: {dropped} "
                "(migrate them away first)"
            )
        return ShardMap(new, self.epoch + 1, kept)

    # ------------------------------------------------------------------ #
    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": WIRE_VERSION,
            "replicas": list(self.replicas),
            "epoch": self.epoch,
            "pins": dict(sorted(self.pins.items())),
        }

    @classmethod
    def from_dict(cls, doc: Mapping[str, Any]) -> "ShardMap":
        version = int(doc.get("version", WIRE_VERSION))
        if version != WIRE_VERSION:
            raise ValueError(f"unsupported ShardMap wire version {version}")
        return cls(
            tuple(doc["replicas"]), int(doc.get("epoch", 1)),
            dict(doc.get("pins") or {}),
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ShardMap":
        return cls.from_dict(json.loads(text))


# --------------------------------------------------------------------------- #
# the rebalance cost model
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class Move:
    """One proposed migration: ``tenant`` from ``src`` to ``dst``."""

    tenant: str
    src: str
    dst: str
    weight: float

    def to_dict(self) -> Dict[str, Any]:
        return {
            "tenant": self.tenant, "src": self.src, "dst": self.dst,
            "weight": self.weight,
        }


def plan_rebalance(
    shard_map: ShardMap,
    occupancy: Mapping[str, Mapping[str, float]],
    *,
    tolerance: float = 0.10,
    max_moves: Optional[int] = None,
) -> List[Move]:
    """Single-tenant moves that flatten the hot shards, fewest first.

    ``occupancy`` is ``{replica: {tenant: weight}}`` — the load signal (the
    coordinator uses ledger applied-step counts plus live queue depth).
    Greedy and deterministic: while some replica carries more than
    ``mean * (1 + tolerance)``, move the heaviest tenant that fits into the
    lightest replica's headroom (falling back to the src's lightest tenant so
    a single giant tenant cannot wedge the planner). Ties break on tenant id.
    """
    loads: Dict[str, float] = {r: 0.0 for r in shard_map.replicas}
    weights: Dict[str, Dict[str, float]] = {r: {} for r in shard_map.replicas}
    for replica, tenants in occupancy.items():
        if replica not in loads:
            raise ValueError(f"occupancy names unknown replica {replica!r}")
        for tenant, weight in tenants.items():
            weights[replica][str(tenant)] = float(weight)
            loads[replica] += float(weight)
    total = sum(loads.values())
    if total <= 0 or len(shard_map.replicas) < 2:
        return []
    mean = total / len(shard_map.replicas)
    high = mean * (1.0 + tolerance)
    moves: List[Move] = []
    cap = max_moves if max_moves is not None else sum(len(w) for w in weights.values())
    while len(moves) < cap:
        src = max(loads, key=lambda r: (loads[r], r))
        dst = min(loads, key=lambda r: (loads[r], r))
        if src == dst or loads[src] <= high or not weights[src]:
            break
        headroom = loads[src] - loads[dst]
        # heaviest tenant that still shrinks the spread; weight ties and the
        # final fallback both resolve on tenant id for determinism
        candidates = sorted(
            weights[src].items(), key=lambda kv: (-kv[1], kv[0])
        )
        pick = next(
            ((t, w) for t, w in candidates if w < headroom),
            candidates[-1],
        )
        tenant, weight = pick
        if weight >= headroom:
            break  # any move would just swap which replica is hot
        del weights[src][tenant]
        weights[dst][tenant] = weight
        loads[src] -= weight
        loads[dst] += weight
        moves.append(Move(tenant=tenant, src=src, dst=dst, weight=weight))
    return moves
