"""Atomic two-phase write protocol for snapshot directories.

Counterpart of ``metrics_tpu/checkpoint/io.py``: the same layout, names and
protocol, so either package reads what the other wrote.

Layout under a checkpoint root::

    root/
      step_0000000012/                  <- committed snapshot
        shard_00000-of-00008.npz        <- one payload file per saving rank
        shard_00000-of-00008.json       <- per-shard metadata + payload sha256
        MANIFEST.json                   <- aggregated metadata (all shards)
        COMMIT                          <- marker, written LAST
      step_0000000013.pending/          <- in-flight write (never read)

Protocol (the preemption contract):

1. Every host writes its payload + sidecar into the shared ``.pending``
   directory. Each file lands via the backend's atomic write (local: temp +
   ``os.replace`` + fsync), so a file either exists complete or not at all.
2. When all ``world_size`` sidecars are present, the last finishing host
   aggregates them into ``MANIFEST.json``, then writes the ``COMMIT`` marker
   — strictly after every shard is fully durable — and finally publishes the
   pending directory under its committed name (local: one atomic
   ``os.rename``; object stores: copy-then-delete with COMMIT copied last).
3. Readers only ever consider non-pending directories that contain ``COMMIT``.

A process killed at ANY point therefore leaves either a committed snapshot
from before the save, plus possibly a ``.pending`` junk directory (ignored by
readers, reaped by :func:`clean_pending`), or the fully committed new
snapshot. There is no in-between state a reader can observe.

Every byte moves through the pluggable :class:`~metrics_tpu_torch.checkpoint.storage.Storage`
backend (:func:`~metrics_tpu_torch.checkpoint.storage.set_storage`) under the
process-wide retry policy, and each phase carries a chaos fault point
(``ckpt/write``, ``ckpt/commit``, ``ckpt/read``, ``ckpt/manifest`` — see
:mod:`metrics_tpu_torch.resilience.chaos`).
"""
from __future__ import annotations

import io as _pyio
import json
import os
import re
import threading
import zipfile
from typing import Any, Dict, List, Optional

import numpy as np

from metrics_tpu_torch.checkpoint.format import FORMAT_VERSION
from metrics_tpu_torch.checkpoint.storage import get_storage, storage_op
from metrics_tpu_torch.resilience import chaos as _chaos
from metrics_tpu_torch.utils.exceptions import MetricsUserError

MANIFEST_NAME = "MANIFEST.json"
COMMIT_NAME = "COMMIT"
PENDING_SUFFIX = ".pending"

_STEP_RE = re.compile(r"^step_(\d{10})$")


class CheckpointError(MetricsUserError):
    """Base class for checkpoint failures."""


class CheckpointNotFoundError(CheckpointError):
    """No committed snapshot exists where one was requested."""


class CheckpointCorruptError(CheckpointError):
    """A committed snapshot failed verification (truncated/altered payload)."""


class CheckpointMismatchError(CheckpointError):
    """The snapshot's fingerprint does not match the live object (see diff)."""


# --------------------------------------------------------------------------- #
# naming / discovery
# --------------------------------------------------------------------------- #
def step_dir_name(step: int) -> str:
    return f"step_{int(step):010d}"


def step_dir(root: str, step: int) -> str:
    return os.path.join(root, step_dir_name(step))


def pending_dir(root: str, step: int) -> str:
    return step_dir(root, step) + PENDING_SUFFIX


def shard_basename(shard_index: int, world_size: int) -> str:
    return f"shard_{shard_index:05d}-of-{world_size:05d}"


def available_steps(root: str) -> List[int]:
    """Committed (COMMIT-marked) snapshot steps under ``root``, ascending."""
    st = get_storage()
    if not storage_op("exists", lambda: st.isdir(root)):
        return []
    steps = []
    for name in storage_op("list", lambda: st.listdir(root)):
        m = _STEP_RE.match(name)
        if m and storage_op(
            "exists", lambda n=name: st.exists(os.path.join(root, n, COMMIT_NAME))
        ):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(root: str) -> Optional[int]:
    steps = available_steps(root)
    return steps[-1] if steps else None


def clean_pending(root: str, dry_run: bool = False) -> List[str]:
    """Remove leftover ``.pending`` directories (aborted saves). Returns the
    removed paths — with ``dry_run`` they are only listed, nothing is
    touched. Never touches committed snapshots."""
    st = get_storage()
    removed: List[str] = []
    if not storage_op("exists", lambda: st.isdir(root)):
        return removed
    for name in storage_op("list", lambda: st.listdir(root)):
        if name.endswith(PENDING_SUFFIX) and _STEP_RE.match(name[: -len(PENDING_SUFFIX)]):
            path = os.path.join(root, name)
            if not dry_run:
                storage_op("delete", lambda p=path: st.delete_tree(p))
            removed.append(path)
    return removed


# --------------------------------------------------------------------------- #
# durable file primitives (routed through the pluggable backend)
# --------------------------------------------------------------------------- #
def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write ``data`` so that ``path`` is either absent or complete.

    Carries the ``ckpt/write`` partial-write fault point: a scheduled
    ``partial_write`` spec truncates the payload *before* the atomic write,
    modelling a torn write that still got published — the checksum layer is
    what must catch it downstream.
    """
    if _chaos.active:
        frac = _chaos.partial_write_fraction("ckpt/write")
        if frac is not None:
            data = data[: int(len(data) * frac)]
    st = get_storage()
    storage_op("write", lambda: st.write_atomic(path, data))


def atomic_write_json(path: str, obj: Any) -> None:
    atomic_write_bytes(path, json.dumps(obj, indent=1, sort_keys=True).encode())


def read_bytes(path: str) -> bytes:
    st = get_storage()
    return storage_op("read", lambda: st.read_bytes(path))


def read_json(path: str) -> Any:
    return json.loads(read_bytes(path).decode())


def sha256_file(path: str) -> str:
    st = get_storage()
    return storage_op("sha256", lambda: st.sha256(path))


def file_size(path: str) -> int:
    st = get_storage()
    return storage_op("size", lambda: st.size(path))


def path_exists(path: str) -> bool:
    st = get_storage()
    return storage_op("exists", lambda: st.exists(path))


def save_npz(path: str, payload: Dict[str, np.ndarray]) -> None:
    """Atomic npz write (serialize to bytes, then one atomic backend write)."""
    buf = _pyio.BytesIO()
    np.savez(buf, **payload)
    atomic_write_bytes(path, buf.getvalue())


def load_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(_pyio.BytesIO(read_bytes(path)), allow_pickle=False) as npz:
        return {k: npz[k] for k in npz.files}


# --------------------------------------------------------------------------- #
# the two phases
# --------------------------------------------------------------------------- #
def write_shard(
    pending: str,
    shard_index: int,
    world_size: int,
    payload: Dict[str, np.ndarray],
    shard_meta: Dict[str, Any],
) -> str:
    """Phase 1 for one host: payload npz + sidecar json into the pending dir."""
    if not (0 <= shard_index < world_size):
        raise CheckpointError(f"shard_index {shard_index} out of range for world_size {world_size}")
    if _chaos.active:
        _chaos.maybe_fail("ckpt/write", shard=shard_index, world=world_size)
    st = get_storage()
    storage_op("makedirs", lambda: st.makedirs(pending))
    base = shard_basename(shard_index, world_size)
    npz_path = os.path.join(pending, base + ".npz")
    save_npz(npz_path, payload)
    sidecar = dict(shard_meta)
    sidecar.update(
        {
            "format_version": FORMAT_VERSION,
            "shard_index": shard_index,
            "world_size": world_size,
            "npz": base + ".npz",
            "bytes": file_size(npz_path),
            "sha256": sha256_file(npz_path),
        }
    )
    atomic_write_json(os.path.join(pending, base + ".json"), sidecar)
    return npz_path


def try_commit(root: str, step: int, world_size: int) -> bool:
    """Phase 2: aggregate + commit once every shard sidecar is present.

    Returns True when the snapshot is committed (by this call or an earlier
    one); False when shards are still missing. The COMMIT marker is written
    strictly after all shards and the manifest are durable, and the pending
    directory becomes visible to readers only through the final publish
    rename.
    """
    if _chaos.active:
        _chaos.maybe_fail("ckpt/commit", step=int(step))
    st = get_storage()
    final = step_dir(root, step)
    if path_exists(os.path.join(final, COMMIT_NAME)):
        return True
    pending = pending_dir(root, step)
    if not storage_op("exists", lambda: st.isdir(pending)):
        return False
    sidecars = []
    for i in range(world_size):
        p = os.path.join(pending, shard_basename(i, world_size) + ".json")
        if not path_exists(p):
            return False
        sidecars.append(read_json(p))
    fingerprints = [json.dumps(s.get("fingerprint"), sort_keys=True) for s in sidecars]
    if len(set(fingerprints)) != 1:
        raise CheckpointError(
            f"shard fingerprints diverge across the {world_size} hosts of step {step}; "
            "refusing to commit a mixed snapshot"
        )
    manifest = {
        "format_version": FORMAT_VERSION,
        "step": int(step),
        "world_size": int(world_size),
        "kind": sidecars[0]["kind"],
        "fingerprint": sidecars[0]["fingerprint"],
        "shards": [
            {
                "shard_index": s["shard_index"],
                "npz": s["npz"],
                "bytes": s["bytes"],
                "sha256": s["sha256"],
                "members": s["members"],
            }
            for s in sidecars
        ],
    }
    # ranks that save at once (a placed metric's save is a collective) may
    # all find every sidecar; the first rename publishes, and a rank whose
    # pending directory vanished under it finds the snapshot committed
    try:
        manifest_path = os.path.join(pending, MANIFEST_NAME)
        atomic_write_json(manifest_path, manifest)
        # the commit marker appears only after every shard + the manifest are
        # fully written and durable
        atomic_write_bytes(
            os.path.join(pending, COMMIT_NAME),
            json.dumps(
                {
                    "format_version": FORMAT_VERSION,
                    "step": int(step),
                    "world_size": int(world_size),
                    "manifest_sha256": sha256_file(manifest_path),
                },
                sort_keys=True,
            ).encode(),
        )
        storage_op("rename", lambda: st.rename(pending, final))
        return True
    except FileNotFoundError:
        if path_exists(os.path.join(final, COMMIT_NAME)):
            return True
        raise


# --------------------------------------------------------------------------- #
# reading committed snapshots
# --------------------------------------------------------------------------- #
def resolve_step(root: str, step: Optional[int]) -> int:
    if step is None:
        latest = latest_step(root)
        if latest is None:
            raise CheckpointNotFoundError(f"no committed checkpoint under {root!r}")
        return latest
    if not path_exists(os.path.join(step_dir(root, step), COMMIT_NAME)):
        raise CheckpointNotFoundError(
            f"no committed checkpoint for step {step} under {root!r} "
            f"(available: {available_steps(root) or 'none'})"
        )
    return int(step)


def read_manifest(root: str, step: int) -> Dict[str, Any]:
    if _chaos.active:
        _chaos.maybe_fail("ckpt/manifest", step=int(step))
    d = step_dir(root, step)
    commit_path = os.path.join(d, COMMIT_NAME)
    manifest_path = os.path.join(d, MANIFEST_NAME)
    if not path_exists(commit_path):
        raise CheckpointNotFoundError(f"step {step} under {root!r} has no COMMIT marker")
    try:
        commit = json.loads(read_bytes(commit_path).decode())
    except (ValueError, OSError) as err:
        raise CheckpointCorruptError(f"unreadable COMMIT marker for step {step}: {err}") from err
    if commit.get("format_version") != FORMAT_VERSION:
        raise CheckpointMismatchError(
            f"checkpoint format version {commit.get('format_version')!r} != "
            f"supported {FORMAT_VERSION} (step {step} under {root!r})"
        )
    if not path_exists(manifest_path):
        raise CheckpointCorruptError(f"step {step} is committed but {MANIFEST_NAME} is missing")
    if commit.get("manifest_sha256") != sha256_file(manifest_path):
        raise CheckpointCorruptError(
            f"{MANIFEST_NAME} of step {step} does not match the COMMIT checksum"
        )
    return read_json(manifest_path)


def load_shard_payload(root: str, step: int, shard_entry: Dict[str, Any], verify: bool = True) -> Dict[str, np.ndarray]:
    """Load one shard's npz, checking size + sha256 against the manifest."""
    if _chaos.active:
        _chaos.maybe_fail("ckpt/read", step=int(step), npz=shard_entry.get("npz"))
    path = os.path.join(step_dir(root, step), shard_entry["npz"])
    if not path_exists(path):
        raise CheckpointCorruptError(f"shard payload {shard_entry['npz']} of step {step} is missing")
    if verify:
        size = file_size(path)
        if size != shard_entry["bytes"]:
            raise CheckpointCorruptError(
                f"shard {shard_entry['npz']} of step {step} is truncated: "
                f"{size} bytes on disk, manifest records {shard_entry['bytes']}"
            )
        digest = sha256_file(path)
        if digest != shard_entry["sha256"]:
            raise CheckpointCorruptError(
                f"shard {shard_entry['npz']} of step {step} fails its checksum "
                f"({digest[:12]}… != manifest {shard_entry['sha256'][:12]}…)"
            )
    try:
        return load_npz(path)
    except (ValueError, OSError, KeyError, zipfile.BadZipFile) as err:
        # BadZipFile: a torn npz write (zip directory lives at the END of the
        # file) — the shape every partial_write chaos fault produces
        raise CheckpointCorruptError(
            f"shard {shard_entry['npz']} of step {step} is unreadable: {err}"
        ) from err


_lock = threading.Lock()


def next_step(root: str) -> int:
    """The next unused step index (latest committed + 1, or 0)."""
    with _lock:
        latest = latest_step(root)
        return 0 if latest is None else latest + 1
