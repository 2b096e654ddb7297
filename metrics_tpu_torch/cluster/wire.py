"""The migration wire format: canonical tenant snapshots + streamed frames.

Counterpart of ``metrics_tpu/cluster/wire.py``: the same bytes. Equal tenant
states encode to equal blobs in either package, so a blob written by one
decodes in the other. Every tensor leaf (arrays, list items, ``CatBuffer``
data and count, sketch components) reaches numpy through one helper,
:func:`host_array` (``detach().cpu().numpy()``), wherever it lives; a
decoded snapshot holds CPU tensors, which ``import_tenant`` moves to its
set's device.

``export_tenant`` hands back a host-side snapshot (stacked rows, eager
CatBuffer/list state, update count, template aux). Before that crosses a
process or host boundary it needs a **pinned byte encoding** — the chaos
harness compares replicas bitwise, checkpoints of migrated tenants must not
drift, and a truncated transfer has to be detectable, not silently decodable.

Canonical npz
    :func:`encode_tenant_snapshot` writes one uncompressed npz: a
    ``__wire__`` JSON header (sorted keys; leaf manifest, per-leaf kind
    metadata, update count, aux) plus one ``.npy`` member per array, in
    sorted leaf order with a zeroed zip timestamp — so equal snapshots
    encode to equal bytes on any host, any process, any PYTHONHASHSEED.
    Sketch leaves carry their class + ``config_dict`` and re-enter through
    ``SKETCH_CLASSES``; CatBuffer leaves keep capacity, fill count and the
    sticky ``overflowed`` flag; dtypes round-trip exactly.

Streaming transfer
    A large tenant (wide CatBuffers, many sketch components) should not be
    gathered into one resident blob on either side. :func:`plan_transfer`
    models the move the way the checkpoint reshard planner does — a step list of
    ``load`` / ``send`` / ``free`` entries with modeled bytes, and the
    ``plan_peak_bytes`` vs ``gather_peak_bytes`` comparison — and
    :func:`iter_frames` walks it leaf by leaf: each leaf is encoded alone,
    split into checksummed frames, and freed before the next leaf loads.
    The receiving :class:`TenantTransfer` verifies every frame digest, every
    per-leaf digest and the manifest before it will hand back a snapshot;
    truncation, reordering or corruption raise :class:`TransferError`.
"""
from __future__ import annotations

import hashlib
import io
import json
import zipfile
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "Frame",
    "TenantTransfer",
    "TransferError",
    "TransferPlan",
    "decode_tenant_snapshot",
    "encode_tenant_snapshot",
    "iter_frames",
    "plan_transfer",
]

WIRE_VERSION = 1
HEADER_KEY = "__wire__"
DEFAULT_CHUNK_BYTES = 1 << 20


class TransferError(RuntimeError):
    """A streamed tenant transfer failed verification (truncation, digest
    mismatch, missing or reordered frames) — the partial state is unusable
    and the migration must abort, never import."""


# --------------------------------------------------------------------------- #
# snapshot <-> flat leaves
# --------------------------------------------------------------------------- #
def _is_sketch(value: Any) -> bool:
    from metrics_tpu_torch.sketches.base import is_sketch

    return is_sketch(value)


def _is_catbuffer(value: Any) -> bool:
    from metrics_tpu_torch.core.buffers import CatBuffer

    return isinstance(value, CatBuffer)


def host_array(value: Any) -> np.ndarray:
    """One leaf as a host numpy array: a tensor is detached and copied off
    its device; anything else goes through ``np.asarray``."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _tensor(arr: np.ndarray) -> torch.Tensor:
    # a writable copy: npz members may be read-only views of the blob
    return torch.from_numpy(np.array(arr))


def _flatten(snapshot: Dict[str, Any]) -> List[Tuple[Tuple[str, str, str], Any]]:
    """Sorted ``((group, leader, state), leaf)`` pairs from a snapshot."""
    leaves: List[Tuple[Tuple[str, str, str], Any]] = []
    for group, key in (("s", "states"), ("e", "eager_states")):
        for leader in sorted(snapshot.get(key) or {}):
            for state in sorted(snapshot[key][leader]):
                leaves.append(((group, leader, state), snapshot[key][leader][state]))
    return leaves


def _leaf_entries(leaf: Any, prefix: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """``(arrays, meta)`` for one leaf; array keys are ``prefix``-scoped."""
    if _is_sketch(leaf):
        comps = {k: host_array(v) for k, v in leaf.components().items()}
        arrays = {f"{prefix}/c/{k}": comps[k] for k in sorted(comps)}
        return arrays, {
            "kind": "sketch",
            "class": type(leaf).__name__,
            "config": leaf.config_dict(),
            "components": sorted(comps),
        }
    if _is_catbuffer(leaf):
        meta: Dict[str, Any] = {
            "kind": "catbuffer",
            "capacity": int(leaf.capacity),
            "count": int(host_array(leaf.count)),
            "overflowed": bool(host_array(leaf.overflowed)),
            "materialized": leaf.data is not None,
        }
        arrays = {} if leaf.data is None else {f"{prefix}/data": host_array(leaf.data)}
        return arrays, meta
    if isinstance(leaf, list):
        arrays = {f"{prefix}/i/{i:06d}": host_array(v) for i, v in enumerate(leaf)}
        return arrays, {"kind": "list", "length": len(leaf)}
    if isinstance(leaf, (np.ndarray, torch.Tensor)) or hasattr(leaf, "dtype"):
        return {prefix: host_array(leaf)}, {"kind": "array"}
    # static scalar state (JSON value survives exactly; floats round-trip)
    return {}, {"kind": "scalar", "value": leaf}


def _leaf_from_entries(
    meta: Dict[str, Any], arrays: Dict[str, np.ndarray], prefix: str
) -> Any:
    kind = meta["kind"]
    if kind == "array":
        return _tensor(arrays[prefix])
    if kind == "scalar":
        return meta["value"]
    if kind == "list":
        return [_tensor(arrays[f"{prefix}/i/{i:06d}"]) for i in range(int(meta["length"]))]
    if kind == "catbuffer":
        from metrics_tpu_torch.core.buffers import CatBuffer

        if meta["materialized"]:
            return CatBuffer(
                _tensor(arrays[f"{prefix}/data"]), int(meta["count"]),
                overflowed=bool(meta["overflowed"]),
            )
        return CatBuffer(
            None, int(meta["count"]), capacity=int(meta["capacity"]), device="cpu",
            overflowed=bool(meta["overflowed"]),
        )
    if kind == "sketch":
        from metrics_tpu_torch.sketches.base import SKETCH_CLASSES

        cls = SKETCH_CLASSES.get(meta["class"])
        if cls is None:
            raise TransferError(f"unknown sketch class {meta['class']!r} on the wire")
        sketch = cls.from_config(meta["config"], device="cpu")
        return sketch.replace(
            **{k: _tensor(arrays[f"{prefix}/c/{k}"]) for k in meta["components"]}
        )
    raise TransferError(f"unknown wire leaf kind {kind!r}")


# --------------------------------------------------------------------------- #
# canonical npz container
# --------------------------------------------------------------------------- #
def _canonical_npz(header: Dict[str, Any], arrays: Dict[str, np.ndarray]) -> bytes:
    """A byte-deterministic npz: sorted members, zeroed zip metadata."""
    buf = io.BytesIO()
    header_bytes = json.dumps(header, sort_keys=True, separators=(",", ":")).encode()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as zf:
        members = [(HEADER_KEY, np.frombuffer(header_bytes, dtype=np.uint8))]
        members += sorted(arrays.items())
        for name, arr in members:
            info = zipfile.ZipInfo(name + ".npy", date_time=(1980, 1, 1, 0, 0, 0))
            info.compress_type = zipfile.ZIP_STORED
            info.external_attr = 0o600 << 16
            with zf.open(info, "w", force_zip64=True) as fid:
                # asarray(order="C"), not ascontiguousarray: the latter
                # promotes 0-d arrays to shape (1,), corrupting scalar states
                np.lib.format.write_array(
                    fid, np.asarray(arr, order="C"), allow_pickle=False
                )
    return buf.getvalue()


def _read_npz(blob: bytes) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    try:
        with np.load(io.BytesIO(blob), allow_pickle=False) as npz:
            if HEADER_KEY not in npz.files:
                raise TransferError("wire blob has no __wire__ header")
            header = json.loads(bytes(npz[HEADER_KEY]).decode("utf-8"))
            arrays = {k: npz[k] for k in npz.files if k != HEADER_KEY}
    except (zipfile.BadZipFile, ValueError, KeyError, OSError) as err:
        raise TransferError(f"undecodable wire blob: {err}") from None
    if int(header.get("version", -1)) != WIRE_VERSION:
        raise TransferError(f"unsupported wire version {header.get('version')!r}")
    return header, arrays


def encode_tenant_snapshot(snapshot: Dict[str, Any]) -> bytes:
    """The whole snapshot as one canonical blob (checkpoint-grade pinning)."""
    arrays: Dict[str, np.ndarray] = {}
    manifest: List[Dict[str, Any]] = []
    for (group, leader, state), leaf in _flatten(snapshot):
        prefix = f"{len(manifest):04d}"
        leaf_arrays, meta = _leaf_entries(leaf, prefix)
        arrays.update(leaf_arrays)
        manifest.append(
            {"group": group, "leader": leader, "state": state, **meta}
        )
    header = {
        "version": WIRE_VERSION,
        "update_count": int(snapshot.get("update_count", 0)),
        "aux": snapshot.get("aux") or {},
        "leaves": manifest,
    }
    return _canonical_npz(header, arrays)


def decode_tenant_snapshot(blob: bytes) -> Dict[str, Any]:
    header, arrays = _read_npz(blob)
    return _assemble(header, {
        i: {
            k: arrays[k]
            for k in arrays
            if k == f"{i:04d}" or k.startswith(f"{i:04d}/")
        }
        for i in range(len(header["leaves"]))
    })


def _assemble(header: Dict[str, Any], per_leaf: Dict[int, Dict[str, np.ndarray]]) -> Dict[str, Any]:
    snapshot: Dict[str, Any] = {
        "states": {}, "eager_states": {},
        "update_count": int(header["update_count"]),
        "aux": header.get("aux") or {},
    }
    for i, meta in enumerate(header["leaves"]):
        group = "states" if meta["group"] == "s" else "eager_states"
        leaf = _leaf_from_entries(meta, per_leaf.get(i, {}), f"{i:04d}")
        snapshot[group].setdefault(meta["leader"], {})[meta["state"]] = leaf
    return snapshot


# --------------------------------------------------------------------------- #
# streamed transfer (the reshard plan's step shape: load / send / free)
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class TransferPlan:
    """The modeled move: per-leaf steps and the peak-memory comparison."""

    tenant: str
    steps: Tuple[Dict[str, Any], ...]
    total_bytes: int
    plan_peak_bytes: int      # largest single leaf blob resident at once
    gather_peak_bytes: int    # the whole-snapshot blob a naive move holds

    def to_dict(self) -> Dict[str, Any]:
        return {
            "tenant": self.tenant,
            "steps": list(self.steps),
            "total_bytes": self.total_bytes,
            "plan_peak_bytes": self.plan_peak_bytes,
            "gather_peak_bytes": self.gather_peak_bytes,
        }


@dataclass(frozen=True)
class Frame:
    """One checksummed chunk of one leaf blob (``leaf < 0`` is the header)."""

    seq: int
    leaf: int
    index: int
    last: bool
    payload: bytes

    @property
    def digest(self) -> str:
        return hashlib.sha256(self.payload).hexdigest()


def _leaf_blob(meta: Dict[str, Any], leaf: Any, prefix: str) -> bytes:
    arrays, _ = _leaf_entries(leaf, prefix)
    return _canonical_npz({"version": WIRE_VERSION, "leaf": meta}, arrays)


def plan_transfer(
    snapshot: Dict[str, Any], chunk_bytes: int = DEFAULT_CHUNK_BYTES
) -> TransferPlan:
    """Model the streamed move of one snapshot without performing it."""
    flat = _flatten(snapshot)
    steps: List[Dict[str, Any]] = []
    total = 0
    peak = 0
    for i, ((group, leader, state), leaf) in enumerate(flat):
        arrays, meta = _leaf_entries(leaf, f"{i:04d}")
        nbytes = sum(a.nbytes for a in arrays.values())
        frames = max(1, -(-max(nbytes, 1) // chunk_bytes))
        steps.append({
            "op": "load", "leaf": f"{group}/{leader}/{state}", "bytes": nbytes,
        })
        steps.append({
            "op": "send", "leaf": f"{group}/{leader}/{state}", "bytes": nbytes,
            "frames": frames,
        })
        steps.append({"op": "free", "leaf": f"{group}/{leader}/{state}", "bytes": nbytes})
        total += nbytes
        peak = max(peak, nbytes)
    return TransferPlan(
        tenant="", steps=tuple(steps), total_bytes=total,
        plan_peak_bytes=peak, gather_peak_bytes=total,
    )


def iter_frames(
    snapshot: Dict[str, Any], chunk_bytes: int = DEFAULT_CHUNK_BYTES
) -> Iterator[Frame]:
    """Stream one snapshot as verifiable frames, one leaf resident at a time.

    Frame 0 carries the manifest: every leaf's metadata, blob length and
    blob digest, plus the snapshot-level update count and aux — everything
    the receiver needs to detect a truncated or corrupted stream *before*
    importing anything.
    """
    if chunk_bytes < 1:
        raise ValueError(f"chunk_bytes must be >= 1, got {chunk_bytes}")
    flat = _flatten(snapshot)
    manifest: List[Dict[str, Any]] = []
    blobs: List[bytes] = []
    for i, ((group, leader, state), leaf) in enumerate(flat):
        meta_entry = {"group": group, "leader": leader, "state": state}
        blob = _leaf_blob(meta_entry, leaf, f"{i:04d}")
        _, meta = _leaf_entries(leaf, f"{i:04d}")
        manifest.append({
            **meta_entry, **meta,
            "nbytes": len(blob),
            "sha256": hashlib.sha256(blob).hexdigest(),
        })
        blobs.append(blob)
    header = {
        "version": WIRE_VERSION,
        "update_count": int(snapshot.get("update_count", 0)),
        "aux": snapshot.get("aux") or {},
        "chunk_bytes": int(chunk_bytes),
        "leaves": manifest,
    }
    header_payload = json.dumps(header, sort_keys=True, separators=(",", ":")).encode()
    seq = 0
    yield Frame(seq=seq, leaf=-1, index=0, last=True, payload=header_payload)
    for i, blob in enumerate(blobs):
        chunks = [blob[o:o + chunk_bytes] for o in range(0, max(len(blob), 1), chunk_bytes)]
        for j, chunk in enumerate(chunks):
            seq += 1
            yield Frame(
                seq=seq, leaf=i, index=j, last=(j == len(chunks) - 1),
                payload=chunk,
            )


class TenantTransfer:
    """The receiving end: verify every frame, decode leaf by leaf.

    ``feed`` one frame at a time (with its sender-side digest); ``finish``
    verifies completeness against the manifest and returns the snapshot.
    Any gap, reorder, digest mismatch or missing leaf raises
    :class:`TransferError` — a partial transfer can never be imported.
    """

    def __init__(self) -> None:
        self._header: Optional[Dict[str, Any]] = None
        self._next_seq = 0
        self._current: List[bytes] = []
        self._current_leaf = -1
        self._leaves: Dict[int, Any] = {}
        self._arrays: Dict[int, Dict[str, np.ndarray]] = {}
        self.peak_bytes = 0
        self.frames_fed = 0

    def feed(self, frame: Frame, digest: Optional[str] = None) -> None:
        if digest is not None and frame.digest != digest:
            raise TransferError(
                f"frame {frame.seq} digest mismatch (corrupted in flight)"
            )
        if frame.seq != self._next_seq:
            raise TransferError(
                f"frame {frame.seq} out of order (expected {self._next_seq})"
            )
        self._next_seq += 1
        self.frames_fed += 1
        if frame.leaf < 0:
            self._header = json.loads(frame.payload.decode("utf-8"))
            if int(self._header.get("version", -1)) != WIRE_VERSION:
                raise TransferError(
                    f"unsupported wire version {self._header.get('version')!r}"
                )
            return
        if self._header is None:
            raise TransferError("leaf frame arrived before the manifest header")
        if frame.leaf != self._current_leaf:
            if self._current:
                raise TransferError(
                    f"leaf {self._current_leaf} interrupted by leaf {frame.leaf}"
                )
            self._current_leaf = frame.leaf
        self._current.append(frame.payload)
        self.peak_bytes = max(
            self.peak_bytes, sum(len(c) for c in self._current)
        )
        if frame.last:
            blob = b"".join(self._current)
            self._current = []
            self._current_leaf = -1
            meta = self._header["leaves"][frame.leaf]
            if len(blob) != int(meta["nbytes"]):
                raise TransferError(
                    f"leaf {meta['leader']}.{meta['state']}: got {len(blob)} "
                    f"bytes, manifest says {meta['nbytes']} (truncated)"
                )
            if hashlib.sha256(blob).hexdigest() != meta["sha256"]:
                raise TransferError(
                    f"leaf {meta['leader']}.{meta['state']}: blob digest mismatch"
                )
            _, arrays = _read_npz(blob)
            self._arrays[frame.leaf] = arrays

    def finish(self) -> Dict[str, Any]:
        if self._header is None:
            raise TransferError("no manifest header received")
        if self._current:
            raise TransferError(
                f"stream ended mid-leaf {self._current_leaf} (truncated)"
            )
        expected = len(self._header["leaves"])
        missing = [i for i in range(expected) if i not in self._arrays]
        if missing:
            names = [
                f"{self._header['leaves'][i]['leader']}.{self._header['leaves'][i]['state']}"
                for i in missing
            ]
            raise TransferError(f"transfer truncated: leaves never arrived: {names}")
        return _assemble(self._header, self._arrays)
