"""The self-tuning sync controller: explore-then-commit per bucket.

Counterpart of ``metrics_tpu/autotune/controller.py``: the same policy, the
same decision records and the same exported plan, byte for byte on the same
observations. One :class:`_BucketTuner` per (reduction, dtype, kind) bucket
walks the admissible transport ladder exact→bf16→int8/sparse_count.
Admissibility is decided by the error-budget gate the sync layer enforces
(``sync._gate_transport``), so the tuner can never choose a configuration
the gate would refuse. Exploration advances one rung per observation (wire
bytes are analytic, so one observation per rung suffices), then commits to
the cheapest measured rung; later re-evaluation is bounded by hysteresis and
a minimum dwell, so decisions never flap. A gate refusal or a measured error
above tolerance poisons the offending rung and demotes the bucket straight
back to ``exact``: the hard safety floor.

**When it observes.** The JAX package feeds :meth:`AutotuneController.observe_bucket`
at trace time, once per compiled program. Here the sync layer feeds it where
the sync's Python runs: at every eager call and at a compiled engine's probe,
never in a capture's second run or in the CPU's stand-in for a replay
(``parallel.sync._quiet``), and never at a replay, which runs no Python. An
eager loop therefore observes at every call where a jitted JAX loop observes
once; since the policy's inputs are observation counts and analytic wire
bytes, further observations at unchanged parameters make no decision.

Decisions are pure functions of the observation sequence (no wall clock, no
randomness), so identical workloads replay identical decision logs and an
exported :class:`~metrics_tpu_torch.autotune.plan.TunedPlan` is exactly
reproducible. Every decision bumps a module-wide *decision epoch*; the
engines key their captured synced steps and collection partitions on it
(``core.engine._autotune_token``), so a decision rebuilds them at the next
call and a committed tuner adds none. A captured step syncs with the
transports its probe resolved (``parallel.sync.recording_tuned``), whatever
the probe's own observations decided meanwhile.
"""
from __future__ import annotations

import os
import threading
from collections import deque
from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.autotune.history import BucketHistory, BucketSample
from metrics_tpu_torch.autotune.plan import TunedPlan, bucket_key, dtype_name
from metrics_tpu_torch.parallel import sync as _sync

# The exploration order. sparse_count sits last because it is lossless but
# only wins on sparse integer buckets; the gate's no_byte_win check prunes it
# analytically for dense ones.
LADDER = ("exact", "bf16", "int8", "sparse_count")

# Candidate incremental cadences (emit every K-th update); bounded by
# PolicyConfig.max_cadence and by the cadence-compounded error bound.
CADENCE_LADDER = (1, 2, 4, 8, 16)

_ENV_AUTOTUNE = "METRICS_TPU_AUTOTUNE"

_TRUTHY = ("1", "true", "on", "yes")
_FALSY = ("", "0", "false", "off", "no")


def _torch_dtype(dtype: Any) -> torch.dtype:
    """``dtype`` (a ``torch.dtype``, a numpy dtype or a name) as a ``torch.dtype``."""
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype_name(dtype))


@dataclass(frozen=True)
class PolicyConfig:
    """Deterministic policy knobs (all pure counts/ratios — no time).

    ``explore_per_rung``  observations per ladder rung before advancing.
    ``min_dwell``         observations a committed decision must stand before
                          hysteresis may switch it (anti-flap floor).
    ``hysteresis``        fractional wire-byte win a challenger must show over
                          the incumbent to displace it post-commit.
    ``window``            sample window per bucket history.
    ``max_cadence``       upper bound on the tuned incremental cadence K.
    ``error_budget``      optional global relative-error budget; intersected
                          (min) with per-transport/per-state tolerances — the
                          tuner can tighten the gate, never loosen it.
    """

    explore_per_rung: int = 1
    min_dwell: int = 8
    hysteresis: float = 0.10
    window: int = 64
    max_cadence: int = 16
    error_budget: Optional[float] = None


class _BucketTuner:
    """Explore-then-commit state machine for one bucket."""

    def __init__(self, key: str, red: Any, dtype: Any, kind: str, config: PolicyConfig):
        self.key = key
        self.red = red
        self.dtype = _torch_dtype(dtype)
        self.kind = kind
        self.config = config
        self.history = BucketHistory(window=config.window)
        self.world: Optional[int] = None
        self.nelems = 0
        self.declared_tol: Optional[float] = None
        # the worst cadence-compounding seen; ladders gate against it so a
        # transport admitted here stays admitted at every observed cadence
        self.max_error_scale = 1.0
        self.poisoned: set = set()
        self.phase = "explore"
        self.current = "exact"
        self.committed: Optional[str] = None
        self.observations = 0
        self.since_decision = 0
        self.rung_observations = 0
        self.cadence = 1

    # ------------------------------------------------------------------ #
    # admissibility — delegated to the runtime gate, never reimplemented
    # ------------------------------------------------------------------ #
    def tolerance_for(self, transport: str) -> float:
        tol = (
            _sync.default_tolerance(transport)
            if self.declared_tol is None
            else float(self.declared_tol)
        )
        budget = self.config.error_budget
        if budget is not None and transport not in ("exact", "sparse_count"):
            tol = min(tol, float(budget))
        return tol

    def ladder(self) -> Tuple[str, ...]:
        """Admissible rungs for this bucket under today's parameters — each
        rung passes the actual ``_gate_transport`` at the worst observed
        error scale, minus poisoned rungs. Always contains ``"exact"``."""
        rungs = []
        gate_red = None if self.kind == "reshard" else self.red
        for t in LADDER:
            if t != "exact" and t in self.poisoned:
                continue
            final, refusal = _sync._gate_transport(
                t,
                gate_red,
                self.dtype,
                self.nelems,
                self.world,
                self.tolerance_for(t) if t != "exact" else None,
                kind=self.kind,
                error_scale=self.max_error_scale,
            )
            if final == t and refusal is None:
                rungs.append(t)
        return tuple(rungs)

    def predicted_wire(self, transport: str) -> int:
        return _sync.transport_wire_bytes(transport, self.nelems, self.dtype)

    def predicted_bound(self, transport: str) -> float:
        if self.world is None or transport == "exact":
            return 0.0
        return (
            _sync.transport_error_bound(transport, self.world, self.kind)
            * self.max_error_scale
        )

    def _cost(self, transport: str) -> float:
        measured = self.history.wire_mean(transport, nelems=self.nelems)
        return float(measured) if measured is not None else float(self.predicted_wire(transport))

    def _cadence_for(self, transport: str) -> int:
        """Largest candidate cadence whose compounded error bound still fits
        the tolerance (lossless transports take the cap directly)."""
        best = 1
        for k in CADENCE_LADDER:
            if k > self.config.max_cadence:
                break
            if transport in ("exact", "sparse_count"):
                best = k
                continue
            if self.world is None:
                break
            bound = _sync.transport_error_bound(transport, self.world, self.kind) * k
            if bound <= self.tolerance_for(transport):
                best = k
            else:
                break
        return best

    # ------------------------------------------------------------------ #
    # decisions
    # ------------------------------------------------------------------ #
    def _decide(self, to: str, reason: str) -> Dict[str, Any]:
        frm = self.current
        self.current = to
        self.since_decision = 0
        self.rung_observations = 0
        self.cadence = self._cadence_for(to)
        return {
            "bucket": self.key,
            "from": frm,
            "to": to,
            "reason": reason,
            "phase": self.phase,
            "observation": self.observations,
            "cadence": self.cadence,
            "predicted_wire_bytes": self.predicted_wire(to),
            "predicted_error_bound": self.predicted_bound(to),
        }

    def _commit(self) -> Dict[str, Any]:
        lad = self.ladder()
        best = lad[0]
        for t in lad[1:]:
            if self._cost(t) < self._cost(best):
                best = t
        self.phase = "committed"
        self.committed = best
        return self._decide(best, "commit")

    def poison(self, transport: str, reason: str) -> Optional[Dict[str, Any]]:
        """Hard-safety demotion: ban a rung and fall back immediately.

        Applies at any phase — a gate refusal or measured-error spike must
        never wait out a dwell. Returns the demotion decision (to exact, or
        to a re-commit over the surviving ladder when measurements exist)."""
        if transport == "exact":
            return None
        self.poisoned.add(transport)
        if self.current != transport and self.committed != transport:
            return None
        if self.phase == "committed":
            # re-score over the surviving rungs (their costs are already
            # measured from exploration); exact always survives
            return self._commit_as(f"poisoned:{reason}")
        return self._decide("exact", f"poisoned:{reason}")

    def _commit_as(self, reason: str) -> Dict[str, Any]:
        event = self._commit()
        event["reason"] = reason
        return event

    def observe(
        self,
        *,
        requested: str,
        transport: str,
        refusal: Optional[Dict[str, Any]],
        nelems: int,
        world: Optional[int],
        tolerance: Optional[float],
        error_scale: float = 1.0,
    ) -> List[Dict[str, Any]]:
        """Record one gate outcome; returns decision events."""
        events: List[Dict[str, Any]] = []
        self.observations += 1
        self.since_decision += 1
        if nelems:
            self.nelems = max(self.nelems, int(nelems))
        if world is not None:
            self.world = int(world)
        if tolerance is not None:
            self.declared_tol = (
                float(tolerance)
                if self.declared_tol is None
                else min(self.declared_tol, float(tolerance))
            )
        if error_scale and float(error_scale) > self.max_error_scale:
            self.max_error_scale = float(error_scale)
        self.history.record(
            BucketSample(
                ordinal=self.observations,
                requested=requested,
                transport=transport,
                refused=refusal is not None,
                refusal_reason=(refusal or {}).get("reason"),
                nelems=int(self.nelems),
                wire_bytes=_sync.transport_wire_bytes(transport, self.nelems, self.dtype),
                logical_bytes=int(self.nelems) * int(self.dtype.itemsize),
                error_scale=float(error_scale),
                error_bound=self.predicted_bound(transport),
            )
        )

        if refusal is not None and requested != "exact":
            event = self.poison(requested, str(refusal.get("reason")))
            if event is not None:
                events.append(event)
            return events

        if self.phase == "explore":
            if self.world is None:
                return events  # can't rank the ladder without a mesh width
            lad = self.ladder()
            if self.current not in lad:
                events.append(self._decide("exact", "ineligible"))
                lad = self.ladder()
            self.rung_observations += 1
            if self.rung_observations >= self.config.explore_per_rung:
                idx = lad.index(self.current)
                if idx + 1 < len(lad):
                    events.append(self._decide(lad[idx + 1], "explore"))
                else:
                    events.append(self._commit())
            return events

        # committed: hysteresis-bounded re-evaluation (nelems or ladder may
        # have shifted); a challenger must beat the incumbent by the
        # hysteresis margin AND the incumbent must have dwelt long enough
        if self.since_decision >= self.config.min_dwell:
            lad = self.ladder()
            if self.current not in lad:
                events.append(self._commit_as("ladder_shift"))
                return events
            incumbent = self._cost(self.current)
            best, best_cost = self.current, incumbent
            for t in lad:
                c = self._cost(t)
                if c < best_cost:
                    best, best_cost = t, c
            if best != self.current and best_cost < incumbent * (
                1.0 - self.config.hysteresis
            ):
                self.committed = best
                events.append(self._decide(best, "hysteresis"))
        return events

    def export(self) -> Dict[str, Any]:
        return {
            "transport": self.current,
            "cadence": int(self.cadence),
            "reduction": None if self.kind == "reshard" else self.red,
            "dtype": dtype_name(self.dtype),
            "kind": self.kind,
            "world": self.world,
            "elements": int(self.nelems),
            "tolerance": self.declared_tol,
            "admissible": list(self.ladder()),
            "poisoned": sorted(self.poisoned),
            "phase": self.phase,
            "observations": int(self.observations),
            "predicted_wire_bytes": self.predicted_wire(self.current),
            "predicted_error_bound": self.predicted_bound(self.current),
            "realized_error": self.history.error_mean(self.current),
        }


class AutotuneController:
    """Process-wide tuner: one `_BucketTuner` per live bucket, a shared
    decision log, and the pinned-plan bypass."""

    def __init__(
        self,
        config: Optional[PolicyConfig] = None,
        pinned: Optional[TunedPlan] = None,
    ):
        self.config = config if config is not None else PolicyConfig()
        self.pinned = pinned
        self._lock = threading.RLock()
        self.buckets: Dict[str, _BucketTuner] = {}
        self.decisions: List[Dict[str, Any]] = []
        self._sync_seconds: deque = deque(maxlen=256)

    # ------------------------------------------------------------------ #
    # the sync layer's two questions: which transport? which cadence?
    # ------------------------------------------------------------------ #
    def transport_for(self, red: Any, dtype: Any, kind: str = "psum") -> str:
        key = bucket_key(red, dtype, kind)
        with self._lock:
            if self.pinned is not None:
                return self.pinned.transport_for(key)
            tuner = self.buckets.get(key)
            return tuner.current if tuner is not None else "exact"

    def cadence(self) -> Optional[int]:
        """The tuned incremental cadence: the pinned plan's, or the minimum
        over committed buckets (None while nothing has committed)."""
        with self._lock:
            if self.pinned is not None:
                return int(self.pinned.cadence)
            committed = [
                t.cadence for t in self.buckets.values() if t.phase == "committed"
            ]
            return min(committed) if committed else None

    # ------------------------------------------------------------------ #
    # observation feeds
    # ------------------------------------------------------------------ #
    def observe_bucket(
        self,
        red: Any,
        dtype: Any,
        *,
        kind: str = "psum",
        requested: str,
        transport: str,
        refusal: Optional[Dict[str, Any]] = None,
        nelems: int,
        world: Optional[int],
        tolerance: Optional[float] = None,
        error_scale: float = 1.0,
    ) -> None:
        """Feed one gate outcome for a bucket (called from ``_sync_bucketed``
        and ``_sync_resharded`` where the sync's Python runs)."""
        key = bucket_key(red, dtype, kind)
        with self._lock:
            if self.pinned is not None:
                self._set_gauges_pinned(key, transport, nelems, dtype)
                return
            tuner = self.buckets.get(key)
            if tuner is None:
                red_tag = "reshard" if kind == "reshard" else red
                tuner = self.buckets[key] = _BucketTuner(
                    key, red_tag, dtype, kind, self.config
                )
            events = tuner.observe(
                requested=requested,
                transport=transport,
                refusal=refusal,
                nelems=nelems,
                world=world,
                tolerance=tolerance,
                error_scale=error_scale,
            )
            for event in events:
                self.decisions.append(event)
                _bump_epoch()
                _emit_decision(event)
            self._set_gauges(tuner)

    def observe_error(
        self, red: Any, dtype: Any, measured: float, kind: str = "psum"
    ) -> None:
        """Feed a measured realized error for a bucket (e.g. from a bench
        harness or a shadow-exact comparison). A measurement above the
        bucket's tolerance poisons the current transport immediately."""
        key = bucket_key(red, dtype, kind)
        with self._lock:
            _registry_gauge("autotune_realized_error", bucket=key).set(float(measured))
            if self.pinned is not None:
                return
            tuner = self.buckets.get(key)
            if tuner is None:
                return
            current = tuner.current
            if current in ("exact", "sparse_count"):
                return
            if float(measured) > tuner.tolerance_for(current):
                event = tuner.poison(current, "error_spike")
                if event is not None:
                    self.decisions.append(event)
                    _bump_epoch()
                    _emit_decision(event)
                    self._set_gauges(tuner)

    def observe_sync_seconds(self, seconds: float) -> None:
        """Observational record of one sync's wall time (gauged, never a
        decision input — wall clocks would break bitwise replay)."""
        with self._lock:
            self._sync_seconds.append(float(seconds))
            _registry_gauge("autotune_last_sync_seconds").set(float(seconds))

    # ------------------------------------------------------------------ #
    # export
    # ------------------------------------------------------------------ #
    def export_plan(self) -> TunedPlan:
        with self._lock:
            if self.pinned is not None:
                return TunedPlan.from_dict(self.pinned.to_dict())
            return TunedPlan(
                config={
                    k: v for k, v in asdict(self.config).items() if v is not None
                },
                cadence=self.cadence() or 1,
                buckets={k: t.export() for k, t in sorted(self.buckets.items())},
                decisions=[dict(d) for d in self.decisions],
            )

    # ------------------------------------------------------------------ #
    # gauges
    # ------------------------------------------------------------------ #
    def _set_gauges(self, tuner: _BucketTuner) -> None:
        key = tuner.key
        _registry_gauge("autotune_dwell", bucket=key).set(float(tuner.since_decision))
        _registry_gauge("autotune_predicted_wire_bytes", bucket=key).set(
            float(tuner.predicted_wire(tuner.current))
        )
        last = tuner.history.last()
        if last is not None:
            _registry_gauge("autotune_realized_wire_bytes", bucket=key).set(
                float(last.wire_bytes)
            )
        _registry_gauge("autotune_predicted_error_bound", bucket=key).set(
            float(tuner.predicted_bound(tuner.current))
        )

    def _set_gauges_pinned(self, key: str, transport: str, nelems: int, dtype: Any) -> None:
        _registry_gauge("autotune_realized_wire_bytes", bucket=key).set(
            float(_sync.transport_wire_bytes(transport, int(nelems), dtype))
        )


# --------------------------------------------------------------------------- #
# module-level switch, epoch, and observability plumbing
# --------------------------------------------------------------------------- #
_MODULE_LOCK = threading.RLock()
_enabled: Optional[bool] = None  # None = follow the environment
_config: Optional[PolicyConfig] = None
_pinned: Optional[TunedPlan] = None
_controller: Optional[AutotuneController] = None
_epoch = 0


def autotune_enabled() -> bool:
    """Whether the self-tuning controller is active (``set_autotune`` /
    ``METRICS_TPU_AUTOTUNE``; off by default)."""
    if _enabled is not None:
        return _enabled
    env = os.environ.get(_ENV_AUTOTUNE, "").strip()
    return env.lower() not in _FALSY


def set_autotune(
    arg: Optional[Union[bool, TunedPlan, Dict[str, Any], str]] = None,
    *,
    config: Optional[Union[PolicyConfig, Dict[str, Any]]] = None,
) -> None:
    """Enable/disable the self-tuning sync controller, or pin a plan.

    - ``set_autotune(True)``   — live tuning (explore-then-commit).
    - ``set_autotune(False)``  — off, regardless of the environment.
    - ``set_autotune(None)``   — follow ``METRICS_TPU_AUTOTUNE`` (a truthy
      value enables live tuning; a path to a plan JSON pins that plan).
    - ``set_autotune(plan)``   — pin a :class:`TunedPlan` (or its dict form,
      or a path to its JSON): exploration is bypassed and the plan's
      transports flow as *requested* transports through the unchanged
      error-budget gate.

    Precedence at the sync layer is unchanged: per-state
    ``add_state(sync_transport=...)`` declarations always outrank the tuner,
    and the tuner outranks ``set_sync_transport()`` / the env default.
    Any call resets the controller (histories, decisions) and bumps the
    decision epoch so cached partitions rebuild against the new regime.
    """
    global _enabled, _config, _pinned, _controller
    with _MODULE_LOCK:
        if config is not None and not isinstance(config, PolicyConfig):
            config = PolicyConfig(**dict(config))
        _config = config
        if arg is None:
            _enabled, _pinned = None, None
        elif isinstance(arg, bool):
            _enabled, _pinned = arg, None
        else:
            _enabled, _pinned = True, _coerce_plan(arg)
        _controller = None
        _bump_epoch()


def _coerce_plan(arg: Union[TunedPlan, Dict[str, Any], str]) -> TunedPlan:
    if isinstance(arg, TunedPlan):
        return arg
    if isinstance(arg, dict):
        return TunedPlan.from_dict(arg)
    return TunedPlan.load(os.fspath(arg))


def get_controller() -> Optional[AutotuneController]:
    """The live controller (lazily created), or None when tuning is off."""
    global _controller
    if not autotune_enabled():
        return None
    with _MODULE_LOCK:
        if _controller is None:
            pinned = _pinned
            if pinned is None and _enabled is None:
                # env-driven enable: a value that names a readable plan file
                # pins it; any other truthy value means live tuning
                env = os.environ.get(_ENV_AUTOTUNE, "").strip()
                if env and env.lower() not in _TRUTHY and os.path.isfile(env):
                    try:
                        pinned = TunedPlan.load(env)
                    except (OSError, ValueError):
                        pinned = None
            _controller = AutotuneController(config=_config, pinned=pinned)
        return _controller


def decision_epoch() -> int:
    """Monotonic counter bumped on every tuner decision (and on
    ``set_autotune``). Cache keys that include it rebuild exactly when a
    decision lands and never otherwise."""
    return _epoch


def partition_token() -> int:
    """The engines' key ingredient: the decision epoch while tuning is live,
    a constant otherwise (so enabling/disabling tuning repartitions exactly
    once and an untuned process never repartitions for it). Pinned plans
    never bump the epoch, so pins add zero rebuilds."""
    return _epoch if autotune_enabled() else -1


def export_plan() -> Optional[TunedPlan]:
    """Export the live controller's current decisions as a pinnable
    :class:`TunedPlan` (None when tuning is off)."""
    ctl = get_controller()
    return ctl.export_plan() if ctl is not None else None


def _bump_epoch() -> None:
    global _epoch
    _epoch += 1


def _emit_decision(event: Dict[str, Any]) -> None:
    try:
        from metrics_tpu_torch.observability import tracer as _tracer

        if _tracer.active:
            _tracer.emit_instant("sync/tune_decision", "sync", **event)
    except Exception:
        pass
    counter = _registry_counter(
        "autotune_decisions_total",
        bucket=str(event["bucket"]),
        **{"from": str(event["from"]), "to": str(event["to"])},
    )
    if counter is not None:
        counter.inc()


class _NullInstrument:
    def inc(self, *_a, **_k):  # pragma: no cover - trivial
        pass

    def set(self, *_a, **_k):  # pragma: no cover - trivial
        pass


_NULL = _NullInstrument()


def _registry_counter(name: str, **labels: str):
    try:
        from metrics_tpu_torch.observability.instruments import REGISTRY

        return REGISTRY.counter(name, _HELP.get(name, ""), **labels)
    except Exception:
        return None


def _registry_gauge(name: str, **labels: str):
    try:
        from metrics_tpu_torch.observability.instruments import REGISTRY

        return REGISTRY.gauge(name, _HELP.get(name, ""), **labels)
    except Exception:
        return _NULL


_HELP = {
    "autotune_decisions_total": (
        "Self-tuning sync decisions by bucket and transport transition."
    ),
    "autotune_dwell": "Observations since the bucket's last tuner decision.",
    "autotune_predicted_wire_bytes": (
        "Analytic per-sync wire bytes of the bucket's current transport."
    ),
    "autotune_realized_wire_bytes": (
        "Wire bytes of the bucket's most recently traced sync."
    ),
    "autotune_predicted_error_bound": (
        "Worst-case relative error bound of the bucket's current transport."
    ),
    "autotune_realized_error": (
        "Measured relative error fed back for the bucket (vs shadow exact)."
    ),
    "autotune_last_sync_seconds": "Wall seconds of the most recent observed sync.",
}
