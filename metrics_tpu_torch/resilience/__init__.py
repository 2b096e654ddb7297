"""Deterministic chaos, bounded retries and the non-finite guard.

Counterpart of ``metrics_tpu/resilience``. The stack keeps producing
*correct* numbers while the world misbehaves:

* :mod:`~metrics_tpu_torch.resilience.chaos`: a seeded fault-injection
  harness. Fault points at the seams (engine probe and replay, sync bucket
  build, incremental emission, scrape server) replay a reproducible fault
  schedule, the JAX package's bit for bit, so tests can assert that the
  final ``compute()`` is bitwise equal to the fault-free run.
* :mod:`~metrics_tpu_torch.resilience.retry`: :class:`RetryPolicy` /
  :func:`call_with_retry`: bounded retries with exponential backoff, seeded
  jitter, per-op timeouts, and transient-vs-fatal classification.
* :mod:`~metrics_tpu_torch.resilience.guard`: the opt-in non-finite state
  guard at the update/sync/compute boundaries with raise/warn/quarantine
  policies.

Graceful degradation lives at its seam: the collection dispatcher's
probation and re-promotion in :mod:`metrics_tpu_torch.core.engine`.
"""
from metrics_tpu_torch.resilience import chaos, guard, retry  # noqa: F401
from metrics_tpu_torch.resilience.chaos import (  # noqa: F401
    ChaosError,
    FaultPlan,
    FaultSpec,
    KNOWN_SITES,
)
from metrics_tpu_torch.resilience.guard import NonFiniteStateError, guarded, set_guard  # noqa: F401
from metrics_tpu_torch.resilience.retry import RetryPolicy, call_with_retry, default_classify  # noqa: F401

__all__ = [
    "chaos",
    "retry",
    "guard",
    "ChaosError",
    "FaultPlan",
    "FaultSpec",
    "KNOWN_SITES",
    "RetryPolicy",
    "call_with_retry",
    "default_classify",
    "NonFiniteStateError",
    "set_guard",
    "guarded",
]
