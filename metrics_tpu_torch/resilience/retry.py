"""Bounded retries with seeded jitter for storage operations.

Counterpart of ``metrics_tpu/resilience/retry.py``. In the JAX package every
storage-backend op of the checkpoint writer runs under
:func:`call_with_retry` with the active :class:`RetryPolicy`; the port's
checkpoint storage is not ported yet, so here the policy stands alone. It is
small and fully deterministic under a seed: the same policy and seed give
the same backoff sequence in both packages.

Semantics:

* **bounded attempts**: ``max_attempts`` total tries, then the last error
  propagates (a *giveup*);
* **exponential backoff + jitter**: attempt ``k`` sleeps
  ``min(base * multiplier**(k-1), cap)`` scaled by a seeded jitter draw into
  ``[delay * (1 - jitter), delay]``;
* **per-op timeout**: ``op_timeout_s`` is a wall-clock budget across all
  attempts of one op; once exceeded, no further retries are scheduled;
* **transient-vs-fatal classification**: only *transient* errors retry.
  :func:`default_classify` treats
  :class:`~metrics_tpu_torch.resilience.chaos.ChaosError` per its
  ``transient`` flag, structural filesystem errors (missing, permission,
  not-a-dir) as fatal, and remaining ``OSError`` / ``TimeoutError`` /
  ``ConnectionError`` as transient.

Observability: every scheduled retry increments
``metrics_tpu_checkpoint_retries_total{op=...}`` and emits a ``ckpt/retry``
tracer instant; a giveup increments
``metrics_tpu_checkpoint_retry_giveups_total{op=...}``.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, TypeVar

from metrics_tpu_torch.observability import tracer as _otrace
from metrics_tpu_torch.observability.instruments import REGISTRY as _REGISTRY

T = TypeVar("T")

_RETRIES_HELP = "Storage-backend ops retried after a transient error, by op."
_GIVEUPS_HELP = "Storage-backend ops that exhausted retries (or hit a fatal error), by op."


def default_classify(err: BaseException) -> bool:
    """True when ``err`` is transient (worth retrying)."""
    from metrics_tpu_torch.resilience.chaos import ChaosError

    if isinstance(err, ChaosError):
        return err.transient
    if isinstance(err, (FileNotFoundError, NotADirectoryError, IsADirectoryError,
                        PermissionError, FileExistsError)):
        return False  # structural: the path is wrong, not the weather
    if isinstance(err, (OSError, TimeoutError, ConnectionError, InterruptedError)):
        return True
    return False


@dataclass(frozen=True)
class RetryPolicy:
    """Retry schedule for one storage op. Frozen: share instances freely."""

    max_attempts: int = 4
    backoff_base_s: float = 0.01
    backoff_multiplier: float = 2.0
    backoff_max_s: float = 1.0
    jitter: float = 0.5                  # fraction of the delay randomized downward
    op_timeout_s: Optional[float] = None  # wall-clock budget across attempts
    seed: Optional[int] = None            # deterministic jitter stream when set
    classify: Optional[Callable[[BaseException], bool]] = None

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not (0.0 <= self.jitter <= 1.0):
            raise ValueError("jitter must be in [0, 1]")
        if self.backoff_multiplier < 1.0:
            raise ValueError("backoff_multiplier must be >= 1")

    def backoff_for(self, attempt: int, rng: random.Random) -> float:
        """Jittered delay before retry number ``attempt`` (1-based). Always in
        ``[bound * (1 - jitter), bound]`` for the deterministic bound."""
        bound = min(
            self.backoff_base_s * self.backoff_multiplier ** (attempt - 1),
            self.backoff_max_s,
        )
        if self.jitter:
            bound *= 1.0 - self.jitter * rng.random()
        return bound

    def rng(self) -> random.Random:
        return random.Random(self.seed) if self.seed is not None else random.Random()


def call_with_retry(
    fn: Callable[[], T],
    policy: Optional[RetryPolicy] = None,
    op: str = "op",
    rng: Optional[random.Random] = None,
) -> T:
    """Run ``fn`` under ``policy``; re-raises the last error on giveup.

    ``rng`` lets a caller thread one jitter stream through many ops; the
    default is a fresh stream from ``policy.seed``.
    """
    pol = policy if policy is not None else RetryPolicy()
    classify = pol.classify if pol.classify is not None else default_classify
    jitter_rng = rng if rng is not None else pol.rng()
    deadline = (
        time.monotonic() + pol.op_timeout_s if pol.op_timeout_s is not None else None
    )
    attempt = 1
    while True:
        try:
            return fn()
        except Exception as err:  # classified below: fatal errors re-raise
            out_of_time = deadline is not None and time.monotonic() >= deadline
            if not classify(err) or attempt >= pol.max_attempts or out_of_time:
                _REGISTRY.counter("checkpoint_retry_giveups_total", _GIVEUPS_HELP, op=op).inc()
                if _otrace.active:
                    _otrace.emit_instant(
                        "ckpt/retry", "checkpoint", op=op, attempt=attempt,
                        gave_up=True, error=f"{type(err).__name__}: {str(err)[:120]}",
                    )
                raise
            delay = pol.backoff_for(attempt, jitter_rng)
            if deadline is not None:
                delay = min(delay, max(0.0, deadline - time.monotonic()))
            _REGISTRY.counter("checkpoint_retries_total", _RETRIES_HELP, op=op).inc()
            if _otrace.active:
                _otrace.emit_instant(
                    "ckpt/retry", "checkpoint", op=op, attempt=attempt,
                    delay_ms=round(delay * 1e3, 3),
                    error=f"{type(err).__name__}: {str(err)[:120]}",
                )
            if delay > 0.0:
                time.sleep(delay)
            attempt += 1
