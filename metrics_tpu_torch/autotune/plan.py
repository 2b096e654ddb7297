"""The ``tuned_plan`` artifact: an exportable, pinnable sync configuration.

Counterpart of ``metrics_tpu/autotune/plan.py``; the two packages read and
write the same JSON, so a plan exported by either pins the other. A plan
freezes the controller's per-bucket decisions (transport and cadence per
(reduction, dtype, kind) bucket) plus the decision log that produced them.
Pinning a plan (``set_autotune(plan)`` or
``METRICS_TPU_AUTOTUNE=/path/to/plan.json``) bypasses exploration: the pinned
transports flow into the sync layer as *requested* transports, so the
error-budget gate still has the final word and a stale pin can only fall
back to exact, never loosen the gate. :func:`plan_drift` reports where a
pinned plan no longer matches a live collection.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from metrics_tpu_torch.parallel import sync as _sync

PLAN_VERSION = 1

# Reductions the tuner keys on: the elementwise psum buckets plus the
# pseudo-reduction "reshard" for sharded leaves (mesh-width independent).
TUNABLE_KINDS = ("psum", "reshard")


def dtype_name(dtype: Any) -> str:
    """A dtype's name as numpy spells it (``"int32"``), for a ``torch.dtype``,
    a numpy dtype or a name alike."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    try:
        return np.dtype(dtype).name
    except TypeError:  # a name numpy does not know, such as "bfloat16"
        return str(dtype)


def bucket_key(red: Any, dtype: Any, kind: str = "psum") -> str:
    """Canonical tuner bucket key, ``"<reduction>|<dtype>|<kind>"``, with the
    dtype named as numpy names it (``torch.int32`` and ``np.int32`` both give
    ``"sum|int32|psum"``), so both packages key alike.

    Reshard buckets have no meaningful reduction tag, so they all key under
    the pseudo-reduction ``"reshard"``; tenancy-stacked buckets flatten into
    the same (reduction, dtype) keys as their unstacked forms, which is what
    makes tuning decisions independent of tenant count N.
    """
    red_tag = "reshard" if kind == "reshard" else str(red)
    return f"{red_tag}|{dtype_name(dtype)}|{kind}"


@dataclass
class TunedPlan:
    """A pinned/exported snapshot of the controller's decisions."""

    version: int = PLAN_VERSION
    config: Dict[str, Any] = field(default_factory=dict)
    cadence: int = 1
    buckets: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    decisions: List[Dict[str, Any]] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": int(self.version),
            "config": dict(self.config),
            "cadence": int(self.cadence),
            "buckets": {k: dict(v) for k, v in self.buckets.items()},
            "decisions": [dict(d) for d in self.decisions],
        }

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "TunedPlan":
        if not isinstance(data, dict):
            raise ValueError(f"tuned_plan must be a dict, got {type(data).__name__}")
        version = int(data.get("version", PLAN_VERSION))
        if version != PLAN_VERSION:
            raise ValueError(
                f"unsupported tuned_plan version {version} (expected {PLAN_VERSION})"
            )
        buckets = data.get("buckets", {})
        for key, entry in buckets.items():
            transport = entry.get("transport")
            if transport not in _sync.TRANSPORTS:
                raise ValueError(
                    f"tuned_plan bucket {key!r} pins unknown transport "
                    f"{transport!r}; expected one of {_sync.TRANSPORTS}"
                )
        cadence = max(1, int(data.get("cadence", 1)))
        return cls(
            version=version,
            config=dict(data.get("config", {})),
            cadence=cadence,
            buckets={k: dict(v) for k, v in buckets.items()},
            decisions=[dict(d) for d in data.get("decisions", [])],
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "TunedPlan":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def transport_for(self, key: str) -> str:
        """The pinned transport for a bucket key (``"exact"`` for buckets the
        plan does not cover: the stale-pin fallback :func:`plan_drift` reports)."""
        entry = self.buckets.get(key)
        return entry["transport"] if entry else "exact"


def plan_drift(
    plan: TunedPlan,
    live_entries: Sequence[Dict[str, Any]],
    world: Optional[int] = None,
) -> List[Dict[str, Any]]:
    """Compare a pinned plan against the live collection's transport-plan
    entries (``sync.transport_plan`` output) and report every mismatch.

    Drift kinds (each a ``{"kind", "bucket", "detail"}`` record):

    - ``missing_bucket``  — the plan pins a bucket the live collection no
      longer produces (dead weight; harmless but stale).
    - ``stale_bucket``    — the live collection produces a tunable bucket the
      plan does not cover; under the pin it silently syncs ``exact``.
    - ``inadmissible_transport`` — the plan's pinned transport would be
      refused (or routed to exact as inapplicable) by today's gate for the
      live bucket's parameters; the pin silently falls back to exact.
    """
    drift: List[Dict[str, Any]] = []
    live: Dict[str, Dict[str, Any]] = {}
    for entry in live_entries:
        kind = entry.get("kind", "psum")
        red = entry.get("reduction")
        if kind not in TUNABLE_KINDS:
            continue
        if kind == "psum" and red not in _sync._ELEMENTWISE:
            continue
        key = bucket_key(red, entry["dtype"], kind)
        agg = live.setdefault(key, dict(entry))
        agg["elements"] = max(int(agg.get("elements", 0)), int(entry["elements"]))

    for key, pinned in sorted(plan.buckets.items()):
        if key not in live:
            drift.append(
                {
                    "kind": "missing_bucket",
                    "bucket": key,
                    "detail": f"pinned bucket {key!r} not produced by the live collection",
                }
            )
            continue
        entry = live[key]
        transport = pinned.get("transport", "exact")
        if transport == "exact":
            continue
        kind = entry.get("kind", "psum")
        red = None if kind == "reshard" else entry.get("reduction")
        gate_world = world if world is not None else pinned.get("world")
        tolerance = entry.get("tolerance")
        if tolerance is None:
            tolerance = pinned.get("tolerance")
        final, refusal = _sync._gate_transport(
            transport,
            red,
            entry["dtype"],
            int(entry["elements"]),
            gate_world,
            tolerance,
            kind=kind,
        )
        if final != transport:
            reason = refusal.get("reason") if refusal else "inapplicable"
            drift.append(
                {
                    "kind": "inadmissible_transport",
                    "bucket": key,
                    "detail": (
                        f"pinned transport {transport!r} now routes to exact "
                        f"({reason}) for {entry['elements']} elements at "
                        f"world={gate_world}"
                    ),
                }
            )

    for key in sorted(live):
        if key not in plan.buckets:
            drift.append(
                {
                    "kind": "stale_bucket",
                    "bucket": key,
                    "detail": (
                        f"live bucket {key!r} is not covered by the pinned plan "
                        "(syncs exact under the pin)"
                    ),
                }
            )
    return drift
