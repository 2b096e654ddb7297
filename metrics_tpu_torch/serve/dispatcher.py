"""The dispatcher: one consumer thread from the ingest queue into a TenantSet.

Counterpart of ``metrics_tpu/serve/dispatcher.py``.

Single-threaded by design: every ``TenantSet`` mutation (auto-admit, stacked
update) happens on this thread, serialized with reads through the pipeline's
apply lock — HTTP handler threads never touch device state directly. The loop
is the host-side half of the overlap discipline: while
:meth:`~metrics_tpu_torch.tenancy.TenantSet.apply_batch` replays the stacked
step (one captured graph a bucket width, the batched B1 launch among its
kernels), the queue keeps admitting and coalescing the *next* batch, so the
update streak never stalls on the network. Each replica of a cluster runs
its own dispatcher thread on the same card; the engines keep what a probe or
a capture changes to the calling thread (``core/engine.py``, "Threads").

Delivery contract: **an admitted observation is never silently dropped.** The ``serve/dispatch`` chaos site
fires *before* any state moves, transient faults are retried with the
per-batch attempt counter ticking ``ingest_dispatch_retries_total``, and a
non-transient (or retry-exhausted) failure parks the batch on the
**dead-letter list** — surfaced through ``/healthz``, ``/stats.json``, the
``ingest_dead_letters_total`` counter, and every affected tenant's read —
instead of vanishing.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np

from metrics_tpu_torch.observability import tracer as _otrace
from metrics_tpu_torch.observability.instruments import REGISTRY as _REGISTRY
from metrics_tpu_torch.resilience import chaos as _chaos
from metrics_tpu_torch.serve.coalesce import BoundedIngestQueue, Observation


@dataclass
class DeadLetter:
    """One batch the dispatcher could not apply (never dropped silently)."""

    seqs: List[int]
    tenant_ids: List[Any]
    error: str


@dataclass
class DispatchStats:
    """Consumer-side counters (all monotonic)."""

    dispatches: int = 0          # coalesced device dispatches applied
    observations: int = 0        # observations applied (sum of widths)
    retries: int = 0             # transient-fault retries
    dead_letters: int = 0        # observations parked on the dead-letter list
    max_width: int = 0           # widest coalesced dispatch seen
    last_width: int = 0


def stack_rows(batch: List[Observation]):
    """``k`` one-signature observations -> (ids, stacked args, stacked kwargs).

    Array leaves gain a leading tenant axis (``k`` rows); static leaves are
    signature-equal across the batch, so the first observation's value stands
    for all of them.
    """
    ids = [obs.tenant_id for obs in batch]
    head = batch[0]
    args = tuple(
        np.stack([obs.args[i] for obs in batch])
        if isinstance(head.args[i], np.ndarray) else head.args[i]
        for i in range(len(head.args))
    )
    kwargs = {
        k: np.stack([obs.kwargs[k] for obs in batch])
        if isinstance(v, np.ndarray) else v
        for k, v in head.kwargs.items()
    }
    return ids, args, kwargs


class Dispatcher:
    """The consumer thread driving ``queue -> TenantSet.apply_batch``."""

    def __init__(
        self,
        tenant_set: Any,
        queue: BoundedIngestQueue,
        apply_lock: threading.Lock,
        on_applied: Any,                 # callable(ids, seqs) -> None (the ledger)
        on_dead_letter: Any = None,      # callable(ids, seqs) -> None
        max_width: int = 64,
        max_retries: int = 8,
        retry_backoff_s: float = 0.0,
        name: str = "ingest-dispatcher",
    ) -> None:
        self.tenant_set = tenant_set
        self.queue = queue
        self.apply_lock = apply_lock
        self.on_applied = on_applied
        self.on_dead_letter = on_dead_letter
        self.max_width = int(max_width)
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.name = name
        self.stats = DispatchStats()
        self.dead_letters: List[DeadLetter] = []
        self.error: Optional[str] = None   # last apply failure (degraded flag)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------------ #
    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "Dispatcher":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name=self.name, daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        """Signal the loop to exit once the queue is drained, and join."""
        self._stop.set()
        self.queue.close()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout)

    # ------------------------------------------------------------------ #
    def _run(self) -> None:
        while True:
            try:
                batch = self.queue.pop_coalesced(self.max_width, timeout=0.2)
            except _chaos.ChaosError:
                continue  # nothing was removed from the queue; try again
            if batch is None:
                # drain rule: exit only when stopping AND the queue is empty
                if self._stop.is_set() and len(self.queue) == 0:
                    return
                continue
            self.apply(batch)

    def apply(self, batch: List[Observation]) -> bool:
        """Apply one coalesced batch; returns False when dead-lettered."""
        ids, args, kwargs = stack_rows(batch)
        t0_us = _otrace._now_us() if _otrace.active else 0
        attempts = 0
        while True:
            try:
                if _chaos.active:
                    # BEFORE any state moves: a fault here leaves every
                    # tenant's rows untouched, so the retry is exact
                    _chaos.maybe_fail("serve/dispatch", tenants=len(ids))
                with self.apply_lock:
                    self.tenant_set.apply_batch(ids, *args, auto_admit=True, **kwargs)
                break
            except _chaos.ChaosError as err:
                attempts += 1
                if err.transient and attempts <= self.max_retries:
                    self.stats.retries += 1
                    _REGISTRY.counter(
                        "ingest_dispatch_retries_total",
                        "Transient dispatch faults retried by the consumer.",
                    ).inc()
                    if self.retry_backoff_s:
                        time.sleep(self.retry_backoff_s)
                    continue
                self._dead_letter(batch, err)
                return False
            except Exception as err:  # noqa: BLE001 — surfaced, never dropped
                self._dead_letter(batch, err)
                return False
        self.stats.dispatches += 1
        self.stats.observations += len(batch)
        self.stats.last_width = len(batch)
        self.stats.max_width = max(self.stats.max_width, len(batch))
        self.on_applied(ids, [obs.seq for obs in batch])
        if _otrace.active:
            _otrace.emit_complete(
                "serve/dispatch", "serve", t0_us, _otrace._now_us() - t0_us,
                tenants=len(ids), attempts=attempts + 1,
            )
        return True

    def _dead_letter(self, batch: List[Observation], err: Exception) -> None:
        letter = DeadLetter(
            seqs=[obs.seq for obs in batch],
            tenant_ids=[obs.tenant_id for obs in batch],
            error=f"{type(err).__name__}: {err}",
        )
        self.dead_letters.append(letter)
        self.stats.dead_letters += len(batch)
        self.error = letter.error
        _REGISTRY.counter(
            "ingest_dead_letters_total",
            "Admitted observations the dispatcher could not apply.",
        ).inc(len(batch))
        if _otrace.active:
            _otrace.emit_instant(
                "serve/dead_letter", "serve",
                tenants=[str(t) for t in letter.tenant_ids[:32]], error=letter.error,
            )
        if self.on_dead_letter is not None:
            self.on_dead_letter(letter.tenant_ids, letter.seqs)
