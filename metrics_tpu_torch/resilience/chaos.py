"""Deterministic fault injection: seeded, schedulable faults at the stack's seams.

Counterpart of ``metrics_tpu/resilience/chaos.py``. The failure-prone seams
(engine probe/capture and replay in ``core/engine.py``, the sync bucket
build and the incremental emission in ``parallel/sync.py``, and the scrape
server) each carry a **fault point**: a named site that consults this module
before doing its real work. A test installs a :class:`FaultPlan` (a seeded
schedule of :class:`FaultSpec` entries) and runs the loop under it; every
decision is driven by per-spec call counters and a stdlib
``random.Random`` seeded from the plan, so the same plan fires at the same
calls here and in the JAX package, bit for bit. Under the dispatcher's
probation, the final ``compute()`` of a run under a plan is bitwise equal
to the fault-free run.

Zero overhead when off: hot sites gate on the module-level :data:`active`
boolean and only then call :func:`maybe_fail`. No plan object is consulted,
no string is built, no clock is read on the disabled path.

Fault kinds:

* ``"error"``: raise :class:`ChaosError` at the site (``transient`` decides
  how the retry classifier treats it);
* ``"latency"``: ``time.sleep(latency_s)`` at the site, then proceed;
* ``"partial_write"``: consumed by write sites via
  :func:`partial_write_fraction`: the payload is truncated to ``fraction``.

Scheduling: ``nth`` (fail exactly the Nth call at the site), ``every``
(every Nth), ``probability`` (seeded coin per call), or none of them (every
call); ``times`` bounds total fires. Sites match exactly, or by prefix with a
trailing ``*`` (``"storage/*"``).

Known sites (the JAX package's list; the checkpoint, storage, tenancy,
serve and cluster sites come with those modules)::

    engine/compile       first compiled call of a signature (probe + capture),
                         raised before the probe runs
    engine/dispatch      steady-state call, raised before any static buffer
                         is written, so the eager rerun is bit for bit
    sync/bucket_build    one sync_state build (at the probe, never in the
                         capture's second run of the step or a replay)
    sync/incremental     one in-streak incremental emission (likewise)
    server/scrape        one scrape-server GET
"""
from __future__ import annotations

import contextlib
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

from metrics_tpu_torch.observability import tracer as _otrace
from metrics_tpu_torch.observability.instruments import REGISTRY as _REGISTRY

_KINDS = ("error", "latency", "partial_write")

# Every site the runtime consults, for docs/tests; registering a plan against
# an unknown site is allowed (custom seams can add their own names).
KNOWN_SITES = (
    "engine/compile",
    "engine/dispatch",
    "sync/bucket_build",
    "sync/incremental",
    "ckpt/write",
    "ckpt/commit",
    "ckpt/read",
    "ckpt/manifest",
    "storage/write",
    "storage/read",
    "storage/makedirs",
    "storage/list",
    "storage/delete",
    "storage/rename",
    "storage/size",
    "storage/exists",
    "storage/sha256",
    "server/scrape",
    "tenancy/dispatch",
    "tenancy/admit",
    "tenancy/evict",
    "serve/ingest",
    "serve/coalesce",
    "serve/dispatch",
    "serve/read",
    "cluster/fence",
    "cluster/export",
    "cluster/transfer",
    "cluster/import",
    "cluster/cutover",
    "cluster/recover",
)


class ChaosError(RuntimeError):
    """An injected fault. ``transient`` feeds the retry classifier: transient
    chaos models a flaky filesystem/network (retryable), non-transient chaos
    models a structural failure (retries must short-circuit)."""

    def __init__(self, site: str, message: str = "", transient: bool = True) -> None:
        super().__init__(message or f"chaos: injected fault at {site}")
        self.site = site
        self.transient = transient


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault. Exactly one of ``nth``/``every``/``probability``
    selects calls (none set = every call); ``times`` caps total fires."""

    site: str
    kind: str = "error"
    nth: Optional[int] = None
    every: Optional[int] = None
    probability: Optional[float] = None
    times: Optional[int] = None
    latency_s: float = 0.0
    fraction: float = 0.5
    transient: bool = True
    message: str = ""

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected one of {_KINDS}")
        selectors = [s for s in (self.nth, self.every, self.probability) if s is not None]
        if len(selectors) > 1:
            raise ValueError("FaultSpec takes at most one of nth/every/probability")
        if self.nth is not None and self.nth < 1:
            raise ValueError("nth is 1-based")
        if self.every is not None and self.every < 1:
            raise ValueError("every must be >= 1")
        if self.probability is not None and not (0.0 <= self.probability <= 1.0):
            raise ValueError("probability must be in [0, 1]")
        if self.kind == "partial_write" and not (0.0 <= self.fraction < 1.0):
            raise ValueError("partial_write fraction must be in [0, 1)")

    def matches(self, site: str) -> bool:
        if self.site.endswith("*"):
            return site.startswith(self.site[:-1])
        return self.site == site


@dataclass
class FaultEvent:
    """One fired fault, recorded on the plan for test assertions."""

    site: str
    kind: str
    call: int       # 1-based call index at the spec when it fired
    spec_index: int


class _SpecState:
    __slots__ = ("calls", "fired", "rng")

    def __init__(self, seed: int, index: int) -> None:
        self.calls = 0
        self.fired = 0
        # index folded in multiplicatively so two specs of one plan (and the
        # same spec under two seeds) draw independent, reproducible streams
        self.rng = random.Random(seed * 1_000_003 + index * 7_919 + 17)


class FaultPlan:
    """A seeded, replayable schedule of faults. Thread-safe: the scrape
    server's handlers run on their own threads, so decisions serialize under
    one lock."""

    def __init__(self, specs: Iterable[FaultSpec], seed: int = 0) -> None:
        self.specs: Tuple[FaultSpec, ...] = tuple(specs)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._states = [_SpecState(self.seed, i) for i in range(len(self.specs))]
        self.log: List[FaultEvent] = []

    def _decide(self, index: int, spec: FaultSpec) -> bool:
        state = self._states[index]
        state.calls += 1
        if spec.times is not None and state.fired >= spec.times:
            return False
        if spec.nth is not None:
            hit = state.calls == spec.nth
        elif spec.every is not None:
            hit = state.calls % spec.every == 0
        elif spec.probability is not None:
            hit = state.rng.random() < spec.probability
        else:
            hit = True
        if hit:
            state.fired += 1
        return hit

    def _record(self, index: int, spec: FaultSpec, site: str) -> None:
        self.log.append(FaultEvent(site, spec.kind, self._states[index].calls, index))
        _REGISTRY.counter(
            "chaos_faults_total", "Injected faults fired, by site and kind.",
            site=site, kind=spec.kind,
        ).inc()
        if _otrace.active:
            _otrace.emit_instant(
                "chaos/fault", "chaos", site=site, kind=spec.kind,
                call=self._states[index].calls, transient=spec.transient,
            )

    def visit(self, site: str, **info: Any) -> None:
        """Count one call at ``site``; sleep and/or raise per the schedule."""
        error: Optional[ChaosError] = None
        sleep_s = 0.0
        with self._lock:
            for i, spec in enumerate(self.specs):
                if spec.kind == "partial_write" or not spec.matches(site):
                    continue
                if not self._decide(i, spec):
                    continue
                self._record(i, spec, site)
                if spec.kind == "latency":
                    sleep_s += spec.latency_s
                elif error is None:
                    error = ChaosError(site, spec.message, transient=spec.transient)
        if sleep_s > 0.0:
            time.sleep(sleep_s)
        if error is not None:
            raise error

    def partial_fraction(self, site: str) -> Optional[float]:
        """Fraction to truncate a write at ``site`` to, or ``None``."""
        with self._lock:
            frac: Optional[float] = None
            for i, spec in enumerate(self.specs):
                if spec.kind != "partial_write" or not spec.matches(site):
                    continue
                if not self._decide(i, spec):
                    continue
                self._record(i, spec, site)
                if frac is None:
                    frac = spec.fraction
            return frac

    def fired(self, site: Optional[str] = None) -> int:
        """Total faults fired (optionally at one site) — assertion helper."""
        return sum(1 for e in self.log if site is None or e.site == site)


# --------------------------------------------------------------------------- #
# the global switch — the one flag every fault point checks
# --------------------------------------------------------------------------- #
# Same discipline as the tracer's `active`: redundant with `_plan is not None`
# by construction, kept as a plain boolean so the disabled check is a single
# predictable load.
active: bool = False
_plan: Optional[FaultPlan] = None
_install_lock = threading.Lock()


def current_plan() -> Optional[FaultPlan]:
    return _plan


def install(plan_: FaultPlan) -> FaultPlan:
    """Arm a fault plan process-wide (replaces any active plan)."""
    global active, _plan
    with _install_lock:
        _plan = plan_
        active = True
    return plan_


def uninstall() -> Optional[FaultPlan]:
    """Disarm fault injection; returns the plan that was active."""
    global active, _plan
    with _install_lock:
        prev = _plan
        active = False
        _plan = None
    return prev


@contextlib.contextmanager
def plan(specs: Iterable[FaultSpec], seed: int = 0):
    """Arm a fresh :class:`FaultPlan` for the block; always disarms on exit.

    Yields the plan so the body can assert against ``plan.log`` afterwards."""
    p = install(FaultPlan(specs, seed=seed))
    try:
        yield p
    finally:
        uninstall()


# --------------------------------------------------------------------------- #
# fault-point API (sites MUST gate on `active` first — these assume a plan
# is armed so the disabled path never pays a function call)
# --------------------------------------------------------------------------- #
def maybe_fail(site: str, **info: Any) -> None:
    """Consult the armed plan at ``site``: may sleep, may raise ChaosError."""
    p = _plan
    if p is not None:
        p.visit(site, **info)


def partial_write_fraction(site: str) -> Optional[float]:
    """Truncation fraction for a write at ``site`` this call, or ``None``."""
    p = _plan
    if p is not None:
        return p.partial_fraction(site)
    return None
