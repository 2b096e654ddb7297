"""Multi-host trace shards: write, merge, and device-profile correlation.

Counterpart of ``metrics_tpu/observability/shards.py``. A run of several
processes produces one tracer buffer *per process*, each timestamped with
that host's private monotonic clock. This module turns those buffers into
one Perfetto screen:

* :func:`write_trace_shard` serializes this host's buffer as a **shard**: a
  Chrome trace-event JSON document whose ``otherData.shard`` block carries
  the host id, pid, and an **epoch anchor**, a paired reading of the wall
  clock and the tracer's monotonic clock taken at the same instant.
  Monotonic clocks have arbitrary zero points; the hosts' wall clocks are
  shared (NTP), so the anchor makes cross-host alignment possible.
* :func:`merge_trace_shards` loads N shards, puts each on its own Perfetto
  ``pid`` (named ``host:<host_id>``), shifts every timestamp onto the
  common wall-clock axis via the anchors, and emits one valid trace.
* :func:`correlate_device_trace` joins a host-side (merged) trace with a
  device-side trace: what ``torch.profiler.profile(...).export_chrome_trace``
  writes. While the tracer is on and the profiler records, the engines run
  each dispatch under a
  ``torch.profiler.record_function`` named by :func:`dispatch_annotation`
  (``metrics_tpu/<Owner>.<kind>``); the export shows that name as a
  ``user_annotation`` span on the CPU track and, on the card, as a
  ``gpu_user_annotation`` span over the kernels it launched. Spans carrying
  those names are matched to the host ``dispatch/*`` spans, shifted onto the
  host clock, and laid out under their own ``device:`` process track.

Everything here is host-side stdlib: shards from any machine merge on any
machine.
"""
from __future__ import annotations

import json
import os
import re
import socket
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

from metrics_tpu_torch.observability import export as _export
from metrics_tpu_torch.observability import tracer as _tracer

SHARD_FORMAT_VERSION = 1
SHARD_SUFFIX = ".shard.json"

HOST_ID_ENV = "METRICS_TPU_HOST_ID"

# the annotation naming bridge: the one source of the names the engines run
# their dispatches under (utils/profiling.py re-exports these); the prefix is
# the JAX package's, so one correlation tool reads both packages' traces
ANNOTATION_PREFIX = "metrics_tpu/"
_ANNOTATION_RE = re.compile(re.escape(ANNOTATION_PREFIX) + r"(?P<owner>[^.]+)\.(?P<kind>\w+)$")


def dispatch_annotation(owner: str, kind: str) -> str:
    """The ``torch.profiler.record_function`` name an engine dispatch runs
    under while the tracer is on and a profiler records:
    ``metrics_tpu/<Owner>.<kind>``."""
    return f"{ANNOTATION_PREFIX}{owner}.{kind}"


def parse_dispatch_annotation(name: str) -> Optional[Tuple[str, str]]:
    """Inverse of :func:`dispatch_annotation`: ``(owner, kind)`` when ``name``
    is a dispatch annotation, else ``None``."""
    m = _ANNOTATION_RE.match(name)
    if m is None:
        return None
    return m.group("owner"), m.group("kind")


def default_host_id() -> str:
    """This process's shard identity: ``$METRICS_TPU_HOST_ID`` when set (the
    fleet launcher knows the real host index), else ``<hostname>-<pid>``."""
    env = os.environ.get(HOST_ID_ENV)
    if env:
        return env
    return f"{socket.gethostname()}-{os.getpid()}"


def epoch_anchor() -> Dict[str, int]:
    """Paired (wall, monotonic) clock reading in microseconds.

    The monotonic read is bracketed by two wall reads and the midpoint taken,
    so the pairing error is bounded by half the bracket (sub-microsecond in
    practice) rather than by scheduler luck.
    """
    wall0 = time.time_ns()
    mono = time.perf_counter_ns()
    wall1 = time.time_ns()
    return {
        "unix_us": (wall0 + wall1) // 2000,
        "monotonic_us": mono // 1000,
    }


def build_trace_shard(
    source: Optional[_export.TracerOrEvents] = None,
    host_id: Optional[str] = None,
    metadata: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """This host's tracer buffer as a shard document (see module docstring).

    ``source`` defaults to the live tracer (an empty shard is produced while
    tracing is off — still valid, still mergeable).
    """
    if source is None:
        source = _tracer.get_tracer() or ()
    host = host_id if host_id is not None else default_host_id()
    doc = _export.to_chrome_trace(source, process_name=f"host:{host}", metadata=metadata)
    doc["otherData"]["shard"] = {
        "format": SHARD_FORMAT_VERSION,
        "host_id": host,
        "pid": os.getpid(),
        "epoch_anchor": epoch_anchor(),
    }
    return doc


def _sanitize(token: str) -> str:
    return re.sub(r"[^A-Za-z0-9._-]+", "_", token)


def write_trace_shard(
    directory: Union[str, "os.PathLike"],
    source: Optional[_export.TracerOrEvents] = None,
    host_id: Optional[str] = None,
    metadata: Optional[Dict[str, Any]] = None,
) -> str:
    """Write this host's shard into ``directory`` (the push-to-spool path for
    hosts that cannot accept inbound scrapes); returns the shard path.

    The write is atomic (tmp + rename), so a scraper sweeping the spool
    directory never reads a half-written shard, and re-spooling from the same
    process overwrites its previous shard instead of accumulating.
    """
    directory = os.fspath(directory)
    os.makedirs(directory, exist_ok=True)
    doc = build_trace_shard(source, host_id=host_id, metadata=metadata)
    host = doc["otherData"]["shard"]["host_id"]
    path = os.path.join(directory, f"trace-{_sanitize(host)}{SHARD_SUFFIX}")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, separators=(",", ":"))
    os.replace(tmp, path)
    return path


def list_trace_shards(directory: Union[str, "os.PathLike"]) -> List[str]:
    """Shard files under ``directory``, sorted by name (stable merge order)."""
    directory = os.fspath(directory)
    return sorted(
        os.path.join(directory, name)
        for name in os.listdir(directory)
        if name.endswith(SHARD_SUFFIX)
    )


ShardLike = Union[str, "os.PathLike", Dict[str, Any]]


def _load_shard(shard: ShardLike) -> Dict[str, Any]:
    if isinstance(shard, dict):
        return shard
    return _export.load_trace(shard)


def _shard_meta(doc: Dict[str, Any], index: int) -> Dict[str, Any]:
    meta = doc.get("otherData", {}).get("shard")
    if not isinstance(meta, dict):
        # plain (anchor-less) trace: mergeable, but its clock cannot be
        # aligned — flagged so the caller knows the track floats
        return {"host_id": f"shard{index}", "pid": None, "epoch_anchor": None}
    return meta


def _data_and_meta(doc: Dict[str, Any]) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]]]:
    data, meta = [], []
    for rec in doc.get("traceEvents", []):
        if not isinstance(rec, dict):
            continue
        (meta if rec.get("ph") == "M" else data).append(rec)
    return data, meta


def merge_trace_shards(
    shards: Sequence[ShardLike],
    process_name_prefix: str = "host:",
) -> Dict[str, Any]:
    """Merge per-host shard documents into one Perfetto trace.

    * **pids** — each shard gets its own synthetic pid (1..N in host-id
      order), with a ``process_name`` metadata record naming the track
      ``host:<host_id>``; per-shard thread metadata is carried over under the
      remapped pid, so async checkpoint-writer tracks survive the merge.
    * **clocks** — each shard's monotonic timestamps are shifted by its epoch
      anchor onto the shared wall-clock axis, then the whole trace is rebased
      to the earliest event (``otherData.t0_unix_us`` keeps the absolute
      origin). Spans from different hosts therefore interleave in true
      chronological order. Anchor-less inputs are merged unshifted and listed
      in ``otherData.unaligned``.
    """
    if not shards:
        raise ValueError("merge_trace_shards needs at least one shard")
    loaded = [_load_shard(s) for s in shards]
    metas = [_shard_meta(doc, i) for i, doc in enumerate(loaded)]
    # stable order: host id, then input position for duplicates
    order = sorted(range(len(loaded)), key=lambda i: (str(metas[i]["host_id"]), i))

    merged: List[Dict[str, Any]] = []
    hosts: List[str] = []
    unaligned: List[str] = []
    dropped_total = 0
    aligned: List[Tuple[int, List[Dict[str, Any]], List[Dict[str, Any]], int]] = []
    t0: Optional[int] = None
    for pid, i in enumerate(order, start=1):
        doc, meta = loaded[i], metas[i]
        host = str(meta["host_id"])
        hosts.append(host)
        dropped_total += int(doc.get("otherData", {}).get("dropped_events", 0) or 0)
        anchor = meta.get("epoch_anchor")
        if anchor:
            offset = int(anchor["unix_us"]) - int(anchor["monotonic_us"])
        else:
            offset = 0
            unaligned.append(host)
        data, meta_events = _data_and_meta(doc)
        for rec in data:
            ts = rec.get("ts", 0) + offset
            t0 = ts if t0 is None else min(t0, ts)
        aligned.append((pid, data, meta_events, offset))
    if t0 is None:
        t0 = 0

    for (pid, data, meta_events, offset), i in zip(aligned, order):
        host = str(metas[i]["host_id"])
        merged.append({
            "name": "process_name", "ph": "M", "ts": 0, "pid": pid, "tid": 0,
            "args": {"name": f"{process_name_prefix}{host}"},
        })
        for rec in meta_events:
            if rec.get("name") == "process_name":
                continue  # replaced by the host-named record above
            out = dict(rec)
            out["pid"] = pid
            merged.append(out)
        for rec in data:
            out = dict(rec)
            out["pid"] = pid
            out["ts"] = rec.get("ts", 0) + offset - t0
            merged.append(out)

    return {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        "otherData": {
            "producer": "metrics_tpu_torch.observability.shards",
            "merged_hosts": hosts,
            "t0_unix_us": t0,
            "dropped_events": dropped_total,
            "unaligned": unaligned,
        },
    }


def merge_spool_dir(directory: Union[str, "os.PathLike"]) -> Dict[str, Any]:
    """``merge_trace_shards`` over every shard file in a spool directory."""
    paths = list_trace_shards(directory)
    if not paths:
        raise FileNotFoundError(f"no *{SHARD_SUFFIX} files in {os.fspath(directory)!r}")
    return merge_trace_shards(paths)


# --------------------------------------------------------------------------- #
# device-profile correlation
# --------------------------------------------------------------------------- #
def _dispatch_spans(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The host's ``dispatch/*`` spans that ran under the annotation: the
    complete (``"X"``) events, the probe-and-capture and the replays. The
    ``dispatch/eager`` and ``dispatch/fallback`` instants carry no annotation
    (the eager update runs outside the dispatch), so they are left out; the
    JAX package pairs them too, which shifts its k-th-to-k-th pairing by the
    warmup calls."""
    out = []
    for rec in doc.get("traceEvents", []):
        if not isinstance(rec, dict) or rec.get("ph") != "X":
            continue
        if not str(rec.get("name", "")).startswith("dispatch/"):
            continue
        args = rec.get("args", {})
        if isinstance(args, dict) and "owner" in args and "kind" in args:
            out.append(rec)
    return out


# torch.profiler's export: a record_function span on the host's track, and on
# the card the same name over the kernels it launched
_GPU_ANNOTATION_CAT = "gpu_user_annotation"


def _annotation_spans(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The spans named by the bridge: the card's (``gpu_user_annotation``)
    where the export has any, else the host's (a CPU-only profile)."""
    out = []
    for rec in doc.get("traceEvents", []):
        if not isinstance(rec, dict) or rec.get("ph") == "M":
            continue
        if parse_dispatch_annotation(str(rec.get("name", ""))) is not None:
            out.append(rec)
    on_card = [rec for rec in out if rec.get("cat") == _GPU_ANNOTATION_CAT]
    return on_card or out


def correlate_device_trace(
    host_doc: Dict[str, Any],
    device_doc: Dict[str, Any],
    device_name: str = "device:cuda",
    offset_us: Optional[float] = None,
) -> Dict[str, Any]:
    """Join a host trace with a device-side profile on one timeline.

    ``device_doc`` is what ``torch.profiler.profile(...).export_chrome_trace``
    writes for the same run. Its spans named by the
    :func:`dispatch_annotation` bridge (the card's ``gpu_user_annotation``
    spans where there are any, else the host's ``record_function`` spans)
    are matched, in order, against the host trace's ``dispatch/*`` spans
    with the same ``(owner, kind)`` args: the k-th dispatch of an engine to
    the k-th annotation of that engine. Kernels that a
    ``CUDAGraph.replay()`` launches may carry no annotation on the card;
    their dispatches then stay unmatched, and the counts say so.

    Clock alignment: the profile runs on its own clock, so unless
    ``offset_us`` is given the shift is estimated from the first matched
    host/device pair (host ``ts`` − device ``ts``), good to the host's
    dispatch latency. Device events then land under their own ``device:``
    process track (pid = max host pid + 1), and each matched host span gains
    ``args.annotation`` naming its device counterpart. The profile's flow
    arrows (phases other than those :func:`validate_chrome_trace` accepts)
    link its own pids and are dropped.

    Returns a combined, valid object-format document;
    ``otherData.correlation`` reports matched/unmatched counts and the offset
    applied.
    """
    host_events = [dict(r) for r in host_doc.get("traceEvents", []) if isinstance(r, dict)]
    max_pid = max((int(r.get("pid", 0)) for r in host_events), default=0)
    device_pid = max_pid + 1

    ann_spans = _annotation_spans(device_doc)
    # match annotation occurrences to dispatch spans per (owner, kind), in
    # timestamp order on both sides — k-th dispatch of a metric <-> k-th
    # device annotation of that metric
    by_key_device: Dict[Tuple[str, str], List[Dict[str, Any]]] = {}
    for rec in sorted(ann_spans, key=lambda r: r.get("ts", 0)):
        key = parse_dispatch_annotation(str(rec["name"]))
        assert key is not None
        by_key_device.setdefault(key, []).append(rec)

    matched = 0
    est_offset: Optional[float] = offset_us
    consumed: Dict[Tuple[str, str], int] = {}
    host_dispatches = sorted(_dispatch_spans({"traceEvents": host_events}),
                             key=lambda r: r.get("ts", 0))
    pairs: List[Tuple[Dict[str, Any], Dict[str, Any]]] = []
    for rec in host_dispatches:
        args = rec["args"]
        key = (str(args["owner"]), str(args["kind"]))
        queue = by_key_device.get(key, ())
        k = consumed.get(key, 0)
        if k < len(queue):
            consumed[key] = k + 1
            pairs.append((rec, queue[k]))
    for host_rec, dev_rec in pairs:
        if est_offset is None:
            est_offset = float(host_rec.get("ts", 0)) - float(dev_rec.get("ts", 0))
        host_rec.setdefault("args", {})["annotation"] = dev_rec["name"]
        matched += 1
    if est_offset is None:
        est_offset = 0.0

    combined = list(host_events)
    combined.append({
        "name": "process_name", "ph": "M", "ts": 0, "pid": device_pid, "tid": 0,
        "args": {"name": device_name},
    })
    device_events = [
        r for r in device_doc.get("traceEvents", [])
        if isinstance(r, dict) and r.get("ph") != "M" and r.get("ph") in _export._VALID_PHASES
    ]
    for rec in device_events:
        out = dict(rec)
        out["pid"] = device_pid
        out.setdefault("tid", 0)
        out["ts"] = float(rec.get("ts", 0)) + est_offset
        combined.append(out)

    other = dict(host_doc.get("otherData", {}))
    other["correlation"] = {
        "matched": matched,
        "host_dispatches": len(host_dispatches),
        "device_annotations": len(ann_spans),
        "device_events": len(device_events),
        "offset_us": est_offset,
    }
    return {
        "traceEvents": combined,
        "displayTimeUnit": host_doc.get("displayTimeUnit", "ms"),
        "otherData": other,
    }
