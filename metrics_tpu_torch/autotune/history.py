"""Per-bucket measurement history for the self-tuning sync controller.

Counterpart of ``metrics_tpu/autotune/history.py``, line for line. Every
observed sync of a (reduction, dtype) bucket produces one
:class:`BucketSample`: the gate's verdict plus the analytic wire and logical
byte cost of the transport actually used (``sync.transport_wire_bytes``, the
formulas the codecs tick into ``count_collectives``). The controller's
decision policy reads windowed aggregates of these samples; nothing here
touches torch or wall clocks, so identical workloads produce identical
histories and the decision log replays bit for bit.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, Optional


@dataclass(frozen=True)
class BucketSample:
    """One observation of a bucket sync (where the sync's Python runs).

    ``requested`` is the transport the tuner (or a per-state declaration)
    proposed; ``transport`` is what the gate actually admitted. ``refused``
    marks a gate refusal of the proposal — the hard-safety signal that
    poisons a rung. ``measured_error`` and ``sync_seconds`` are optional
    runtime observations fed back after execution (they never participate in
    the deterministic decision inputs, only in realized-vs-predicted gauges
    and the error-spike demotion check).
    """

    ordinal: int
    requested: str
    transport: str
    refused: bool = False
    refusal_reason: Optional[str] = None
    nelems: int = 0
    wire_bytes: int = 0
    logical_bytes: int = 0
    error_scale: float = 1.0
    error_bound: float = 0.0
    sync_seconds: Optional[float] = None
    measured_error: Optional[float] = None


@dataclass
class BucketHistory:
    """Windowed sample store for one bucket (newest-last deque)."""

    window: int = 64
    samples: Deque[BucketSample] = field(default_factory=deque)

    def __post_init__(self) -> None:
        self.samples = deque(self.samples, maxlen=max(1, int(self.window)))

    def record(self, sample: BucketSample) -> None:
        self.samples.append(sample)

    def last(self) -> Optional[BucketSample]:
        return self.samples[-1] if self.samples else None

    def count(self, transport: Optional[str] = None) -> int:
        if transport is None:
            return len(self.samples)
        return sum(1 for s in self.samples if s.transport == transport)

    def refusals(self, transport: Optional[str] = None) -> int:
        return sum(
            1
            for s in self.samples
            if s.refused and (transport is None or s.requested == transport)
        )

    def wire_mean(
        self, transport: str, nelems: Optional[int] = None
    ) -> Optional[float]:
        """Mean measured wire bytes of samples that actually used
        ``transport`` (gate-admitted, not merely requested), or None when the
        window holds no such sample. ``nelems`` restricts the mean to samples
        of that bucket size — measurements taken before a bucket grew are a
        different workload and must not be cost-compared against predictions
        at the new size."""
        vals = [
            s.wire_bytes
            for s in self.samples
            if s.transport == transport
            and not s.refused
            and (nelems is None or s.nelems == nelems)
        ]
        return (sum(vals) / len(vals)) if vals else None

    def error_mean(self, transport: str) -> Optional[float]:
        vals = [
            s.measured_error
            for s in self.samples
            if s.transport == transport and s.measured_error is not None
        ]
        return (sum(vals) / len(vals)) if vals else None

    def summary(self) -> Dict[str, Any]:
        """Aggregate view used by ``TunedPlan`` exports and gauges."""
        by_transport: Dict[str, Dict[str, Any]] = {}
        for s in self.samples:
            agg = by_transport.setdefault(
                s.transport, {"count": 0, "wire_bytes": 0, "refusals": 0}
            )
            agg["count"] += 1
            agg["wire_bytes"] += s.wire_bytes
            if s.refused:
                agg["refusals"] += 1
        return {"observations": len(self.samples), "by_transport": by_transport}
