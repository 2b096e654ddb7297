"""metrics_tpu_torch.checkpoint — preemption-safe distributed snapshot/restore.

Counterpart of ``metrics_tpu/checkpoint``, with its on-disk format: numpy
``npz`` payloads, a JSON manifest and ``FORMAT_VERSION = 1``, so either
package restores what the other wrote.

Public surface::

    handle = save_checkpoint(metric_or_collection, root)   # blocking by default
    handle = save_checkpoint(obj, root, blocking=False)    # async file I/O
    handle.wait()                                          # join + raise errors

    info = restore_checkpoint(obj, root)                   # latest step
    info = restore_checkpoint(obj, root, step=12, host_count=1)  # reshard N->1

    report = verify_checkpoint(root)                       # checksum everything
    merge_shards(root, out_root)                           # offline N->1 fold

Saves are per-rank shards (each rank persists only its local state), writes
are atomic two-phase (see :mod:`metrics_tpu_torch.checkpoint.io`), and restore
verifies the fingerprint/manifest/checksums *before* touching live state and
supports world-size change by folding shards with their recorded reductions
(:mod:`metrics_tpu_torch.checkpoint.restore`).

``python -m metrics_tpu_torch.checkpoint {inspect,verify,merge,clean}``
operates on snapshot directories without importing any metric class.

**Overlapped saves on the card.** A captured update writes the state
tensors in place on every replay, so a save cannot hold them and read them
later. ``save_checkpoint(..., blocking=False, overlap_copy=True)`` enqueues
the device-to-host copies into pinned host tensors, ``non_blocking``, on the
current stream before it returns, and records a CUDA event there; the save
thread waits on that event before it writes. Stream order alone keeps the
next replay, enqueued after the copies, from racing them.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.checkpoint.format import (
    FORMAT_VERSION,
    build_shard,
    fingerprint_diff,
    object_fingerprint,
)
from metrics_tpu_torch.checkpoint.io import (
    CheckpointCorruptError,
    CheckpointError,
    CheckpointMismatchError,
    CheckpointNotFoundError,
    available_steps,
    clean_pending,
    latest_step,
    next_step,
    pending_dir,
    try_commit,
    write_shard,
)
from metrics_tpu_torch.checkpoint.restore import (
    ReshardPlan,
    RestoreInfo,
    VerifyReport,
    assign_shards,
    build_reshard_plan,
    merge_shards,
    process_position as _process_position,
    restore_checkpoint,
    verify_all,
    verify_checkpoint,
)
from metrics_tpu_torch.checkpoint.storage import (
    InMemoryStorage,
    LocalStorage,
    ObjectStorage,
    Storage,
    get_retry_policy,
    get_storage,
    set_retry_policy,
    set_storage,
    use_retry_policy,
    use_storage,
)
from metrics_tpu_torch.observability import instruments as _instruments
from metrics_tpu_torch.observability import tracer as _otrace
from metrics_tpu_torch.resilience.retry import RetryPolicy

__all__ = [
    "FORMAT_VERSION",
    "SaveHandle",
    # pluggable storage backends + retry policy
    "Storage",
    "LocalStorage",
    "ObjectStorage",
    "InMemoryStorage",
    "get_storage",
    "set_storage",
    "use_storage",
    "RetryPolicy",
    "get_retry_policy",
    "set_retry_policy",
    "use_retry_policy",
    "ReshardPlan",
    "RestoreInfo",
    "VerifyReport",
    "build_reshard_plan",
    "save_checkpoint",
    "restore_checkpoint",
    "verify_checkpoint",
    "verify_all",
    "assign_shards",
    "merge_shards",
    "available_steps",
    "latest_step",
    "clean_pending",
    "object_fingerprint",
    "fingerprint_diff",
    "CheckpointError",
    "CheckpointNotFoundError",
    "CheckpointCorruptError",
    "CheckpointMismatchError",
]




@dataclass
class SaveHandle:
    """Result of :func:`save_checkpoint`.

    ``wait()`` joins an async save and re-raises its error; ``committed``
    says whether this rank saw the snapshot committed (on a multi-rank save
    the last rank to finish commits, so the others see ``False``).

    ``timings`` holds wall seconds per phase: ``snapshot_s`` (live state to
    payload tensors), ``host_copy_s`` (device to host), ``write_s`` (npz,
    sidecar and fsync into the pending directory), ``commit_s`` (manifest,
    ``COMMIT`` and the rename) and ``total_s``; on an async save the last
    three appear once the thread is done, so read them after ``wait()``.
    With ``overlap_copy=True`` the caller pays ``copy_enqueue_s`` (enqueuing
    the copies) and ``host_copy_s`` is the thread's wait for them.
    """

    root: str
    step: int
    shard_index: int
    world_size: int
    committed: bool = False
    timings: Dict[str, float] = field(default_factory=dict)
    _thread: Optional[threading.Thread] = None
    _error: Optional[BaseException] = None

    def wait(self) -> "SaveHandle":
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        return self

    @property
    def done(self) -> bool:
        return self._thread is None or not self._thread.is_alive()


def _host_copy(payload: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The payload on the host, copied now (the caller may write the state
    in place right after)."""
    return {k: v.detach().cpu().numpy() for k, v in payload.items()}


def _enqueue_copies(payload: Dict[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], Optional[torch.cuda.Event]]:
    """Copies of the payload on the host: CUDA tensors into pinned buffers,
    ``non_blocking`` on the current stream, with an event recorded after
    them; CPU tensors cloned at once. The host buffers may be read once the
    event has completed."""
    out: Dict[str, torch.Tensor] = {}
    event = None
    for k, v in payload.items():
        v = v.detach()
        if v.device.type == "cuda":
            host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host.copy_(v, non_blocking=True)
            out[k] = host
            if event is None:
                event = torch.cuda.Event()
        else:
            out[k] = v.clone()
    if event is not None:
        event.record()
    return out, event


def _emit_phase(name: str, t0: float, t1: float, **args: Any) -> None:
    """Tracer span for a checkpoint phase from perf_counter endpoints (the
    tracer's clock)."""
    _otrace.emit_complete(name, "checkpoint", int(t0 * 1e6), int((t1 - t0) * 1e6), **args)


def _observe_phases(prefix: str, timings: Dict[str, float]) -> None:
    """Fold the phase durations into the registry's checkpoint histograms."""
    for key, seconds in timings.items():
        _instruments.REGISTRY.histogram(
            "checkpoint_phase_seconds",
            help="wall seconds per checkpoint phase",
            op=prefix, phase=key[:-2] if key.endswith("_s") else key,
        ).observe(seconds)


def save_checkpoint(
    obj: Any,
    root: str,
    step: Optional[int] = None,
    *,
    shard_index: Optional[int] = None,
    world_size: Optional[int] = None,
    blocking: bool = True,
    overlap_copy: bool = False,
) -> SaveHandle:
    """Snapshot this rank's shard of a Metric, MetricCollection or TenantSet.

    ``shard_index``/``world_size`` default to the ``torch.distributed`` rank
    and world size when a group is up, else 0 and 1. A placed metric's
    shard gathers its sharded leaves over the placement, so every rank of it
    must save. With ``blocking=False`` the state is copied to the host
    before this returns, and the file write and commit attempt run on a
    thread: call ``handle.wait()`` before relying on the snapshot. The
    snapshot becomes visible to readers once every rank's shard landed and
    one of them committed.

    ``overlap_copy=True`` (async saves only) overlaps the device-to-host copy
    with the caller's next steps: the copies are enqueued into pinned host
    buffers on the current stream, an event is recorded after them, and the
    thread waits on the event before it writes (see the module docstring).
    """
    if overlap_copy and blocking:
        raise ValueError(
            "save_checkpoint: overlap_copy=True requires blocking=False — a "
            "blocking save waits for the write anyway, there is nothing to "
            "overlap the device->host copy with"
        )
    rank, world = _process_position()
    world_size = world if world_size is None else world_size
    shard_index = rank if shard_index is None else shard_index
    if step is None:
        step = next_step(root)

    t0 = time.perf_counter()
    payload, shard_meta = build_shard(obj)
    t1 = time.perf_counter()
    handle = SaveHandle(root=root, step=int(step), shard_index=shard_index, world_size=world_size)
    handle.timings["snapshot_s"] = t1 - t0
    payload_bytes = sum(v.numel() * v.element_size() for v in payload.values())
    event: Optional[torch.cuda.Event] = None
    if overlap_copy:
        staged, event = _enqueue_copies(payload)
        t2 = time.perf_counter()
        handle.timings["copy_enqueue_s"] = t2 - t1
        if _otrace.active:
            _emit_phase("checkpoint/save/snapshot", t0, t1, step=handle.step, leaves=len(payload))
    else:
        staged = _host_copy(payload)
        t2 = time.perf_counter()
        handle.timings["host_copy_s"] = t2 - t1
        if _otrace.active:
            _emit_phase("checkpoint/save/snapshot", t0, t1, step=handle.step, leaves=len(payload))
            _emit_phase("checkpoint/save/host_copy", t1, t2, step=handle.step, bytes=payload_bytes)
    del payload  # the live state: nothing below reads it

    def _write() -> None:
        # on an async save this runs on the thread: the tracer records that
        # thread's id, so the write and commit spans get a track of their own
        nonlocal staged
        try:
            if overlap_copy:
                h0 = time.perf_counter()
                if event is not None:
                    event.synchronize()
                staged = {k: v.numpy() for k, v in staged.items()}
                h1 = time.perf_counter()
                handle.timings["host_copy_s"] = h1 - h0
                if _otrace.active:
                    _emit_phase("ckpt/overlap_copy", h0, h1, step=handle.step, bytes=payload_bytes,
                                enqueue_s=handle.timings["copy_enqueue_s"])
            w0 = time.perf_counter()
            write_shard(pending_dir(root, handle.step), shard_index, world_size, staged, shard_meta)
            w1 = time.perf_counter()
            handle.committed = try_commit(root, handle.step, world_size)
            w2 = time.perf_counter()
            handle.timings["write_s"] = w1 - w0
            handle.timings["commit_s"] = w2 - w1
            handle.timings["total_s"] = w2 - t0
            if _otrace.active:
                _emit_phase("checkpoint/save/write", w0, w1, step=handle.step, shard=handle.shard_index,
                            bytes=payload_bytes)
                _emit_phase("checkpoint/save/commit", w1, w2, step=handle.step, committed=handle.committed)
            _observe_phases("save", handle.timings)
        except BaseException as err:  # surfaced by wait()
            handle._error = err

    if blocking:
        _write()
        if handle._error is not None:
            err, handle._error = handle._error, None
            raise err
    else:
        handle._thread = threading.Thread(target=_write, name=f"metrics-tpu-ckpt-save-{handle.step}", daemon=True)
        handle._thread.start()
    return handle
