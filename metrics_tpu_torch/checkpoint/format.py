"""The snapshot format: versioned metric state on disk.

Counterpart of ``metrics_tpu/checkpoint/format.py``, and the same format:
either package restores what the other wrote. A snapshot is a directory
holding one payload shard per saving rank, a single ``MANIFEST.json`` and a
``COMMIT`` marker (:mod:`metrics_tpu_torch.checkpoint.io` writes them). This
module owns the content: how a live :class:`~metrics_tpu_torch.Metric` or
:class:`~metrics_tpu_torch.MetricCollection` becomes numpy payload plus JSON
metadata, and the fingerprint that gates a restore.

- **Dense leaves** are saved as they are (dtype and shape per leaf, numpy's
  names: ``int32``, ``float32``, ``bool``).
- **``CatBuffer`` states** are saved as their valid prefix (``data[:count]``)
  with the fill count and capacity; a restore rebuilds the buffer at the
  live metric's capacity (or larger). An overflowed buffer refuses to
  snapshot (``CatBuffer.to_array`` raises).
- **List states** are saved element-wise (``name.0``, ``name.1``, ...) with
  the length recorded.
- **Sketches** are saved one array per component, with the class and config.
- **Reduction tags ride along per leaf**, which is what lets a restore fold
  N shards onto M ranks.
- **The fingerprint** (class, per-state kind/reduction/shape/dtype, update
  signature, buffer capacity) is compared with the live object before any
  state is touched. For the same configuration it is the JAX package's,
  field for field.
- **Placed leaves are saved placement-free.** Under an active
  :meth:`~metrics_tpu_torch.Metric.shard_state` placement each rank holds
  only its block of a sharded leaf, so building a shard gathers the leaf's
  global value over the placement (a collective that every rank of it must
  make) and writes it as this rank's partial of the unplaced state: the
  global value on the placement's rank 0, the identity elsewhere, as
  :meth:`~metrics_tpu_torch.Metric.unshard_state` leaves it. Folding the
  shards, or syncing the partials, gives the global value whatever the
  writing mesh was; a restore into a placed metric places the partials again
  (each rank keeps its block). The declared ``shard_axis`` rides along in
  the leaf metadata and the fingerprint.

Building a shard leaves its tensors where they live: :func:`build_shard`
returns the payload as tensors, and the save copies them to the host (at
once, or through pinned buffers with ``overlap_copy``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.core.buffers import CatBuffer
from metrics_tpu_torch.core.collections import MetricCollection
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.sketches.base import is_sketch as _is_sketch
from metrics_tpu_torch.utils.exceptions import MetricsUserError

FORMAT_VERSION = 1

# the member key a bare Metric is stored under (collections use their own keys)
SELF_KEY = "__self__"

# reduction tags whose shards can be folded at restore time; a callable tag or
# a ``none`` tag on a dense leaf keeps per-shard values and cannot merge.
# "sketch" folds via the sketch's own commutative merge (order-invariant).
MERGEABLE_TAGS = ("sum", "mean", "max", "min", "cat", "none", "sketch")


@functools.lru_cache(maxsize=None)
def numpy_dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype (``float32``, not ``torch.float32``):
    the manifest and the fingerprint use numpy's names, as the JAX package's
    do."""
    return str(torch.empty((), dtype=dtype).numpy().dtype)


def shard_axis_meta(shard_axis: Any) -> Any:
    """JSON-stable form of a declared shard axis: int, or list for the
    multi-axis (tuple) declarations placed over 2-D meshes."""
    if isinstance(shard_axis, (tuple, list)):
        return [int(a) for a in shard_axis]
    return int(shard_axis)


def reduction_tag(red: Any) -> str:
    """Stable string form of a ``dist_reduce_fx`` for the manifest."""
    if red is None:
        return "none"
    if isinstance(red, str):
        return red
    return f"callable:{getattr(red, '__qualname__', None) or getattr(red, '__name__', repr(red))}"


def tag_mergeable(tag: str, kind: str) -> bool:
    """Whether shards of a leaf with this (tag, kind) can be folded.

    Callable reductions have unknowable merge semantics offline; a ``none``
    tag on a dense array means "keep per-rank values", which folding would
    turn into a stack, so a cross-world restore refuses it. ``none`` on
    list and CatBuffer leaves concatenates.
    """
    if tag.startswith("callable:"):
        return False
    if tag == "none" and kind == "array":
        return False
    return tag in MERGEABLE_TAGS or kind in ("list", "catbuffer")


# --------------------------------------------------------------------------- #
# live object -> payload + metadata
# --------------------------------------------------------------------------- #
def describe(obj: Any) -> Tuple[str, Dict[str, Metric]]:
    """``("metric"|"collection", ordered {member_key: Metric})`` for ``obj``.

    A collection in a fused update streak has its detached members made
    whole first (:meth:`MetricCollection._realias_members`). Child metrics
    held as attributes (a CompositionalMetric's operands, a wrapper's
    copies) become members of their own under ``<parent key>#child<i>``.
    """
    if isinstance(obj, MetricCollection):
        obj._realias_members()
        return "collection", _expand_children({k: m for k, m in obj.items(keep_base=True)})
    if isinstance(obj, Metric):
        return "metric", _expand_children({SELF_KEY: obj})
    raise MetricsUserError(f"checkpointing supports Metric and MetricCollection, got {type(obj).__name__}")


def _expand_children(members: Dict[str, Metric]) -> Dict[str, Metric]:
    out: Dict[str, Metric] = {}

    def add(key: str, metric: Metric) -> None:
        out[key] = metric
        for i, child in enumerate(metric._child_metrics()):
            add(f"{key}#child{i}", child)

    for key, metric in members.items():
        add(key, metric)
    return out


def metric_leaves(metric: Metric, prefix: str) -> Tuple[Dict[str, Tensor], Dict[str, Dict[str, Any]]]:
    """``(payload, leaves_meta)`` for one metric's registered states.

    ``payload`` maps npz keys to tensors where they live (the save copies
    them to the host); ``leaves_meta`` maps state names to their manifest
    entries. A placed metric's sharded leaves are gathered over the
    placement first (a collective of every rank; see the module docstring).
    """
    payload: Dict[str, Tensor] = {}
    meta: Dict[str, Dict[str, Any]] = {}
    state = metric.get_state()
    if metric.state_sharding is not None:
        state.update(metric._unsharded_partials())
    for name in metric._defaults:
        val = state[name]
        tag = reduction_tag(metric._reductions[name])
        key = prefix + name
        shard_axis = metric._shard_axes.get(name)
        if isinstance(val, CatBuffer):
            entry: Dict[str, Any] = {
                "kind": "catbuffer",
                "reduction": tag,
                "capacity": int(val.capacity),
                "count": len(val) if val.materialized else 0,
                "materialized": bool(val.materialized),
            }
            if shard_axis is not None:
                entry["shard_axis"] = shard_axis_meta(shard_axis)
            if val.materialized:
                arr = val.to_array()  # raises loudly on overflow
                payload[key] = arr
                entry["dtype"] = numpy_dtype_name(arr.dtype)
                entry["item_shape"] = [int(s) for s in arr.shape[1:]]
            meta[name] = entry
        elif isinstance(val, (list, tuple)):
            meta[name] = {
                "kind": "list",
                "reduction": tag,
                "length": len(val),
                "container": "tuple" if isinstance(val, tuple) else "list",
            }
            for i, a in enumerate(val):
                payload[f"{key}.{i}"] = torch.as_tensor(a)
        elif _is_sketch(val):
            # one payload array per component; the static config rides in the
            # meta so a restore rebuilds through SKETCH_CLASSES, never pickle
            meta[name] = {
                "kind": "sketch",
                "reduction": tag,
                "sketch_class": type(val).__name__,
                "config": val.config_dict(),
                "fields": [f for f, _ in val.component_reductions()],
            }
            for fname, _ in val.component_reductions():
                payload[f"{key}.{fname}"] = getattr(val, fname)
        else:
            payload[key] = val
            meta[name] = {
                "kind": "array",
                "reduction": tag,
                "dtype": numpy_dtype_name(val.dtype),
                "shape": [int(s) for s in val.shape],
            }
            if shard_axis is not None:
                meta[name]["shard_axis"] = shard_axis_meta(shard_axis)
    return payload, meta


def metric_aux(metric: Metric) -> Dict[str, Any]:
    """Update-determined Python config riding along per member.

    ``Metric._ckpt_aux_attrs`` names attributes like ``Accuracy.mode`` or
    ``ROC.num_classes`` that updates infer from the first batch: without
    them a restored metric could not ``compute()`` before seeing data.
    Data-dependent, so part of the shard, never of the fingerprint.
    """
    aux: Dict[str, Any] = {}
    for name in type(metric)._ckpt_aux_attrs:
        val = getattr(metric, name, None)
        if val is not None and not isinstance(val, (str, int, float, bool)):
            val = str(val)
        aux[name] = val
    return aux


def metric_fingerprint(metric: Metric) -> Dict[str, Any]:
    """Static identity of a metric for restore gating: class, per-state
    kind/reduction (with dense shape and dtype from the registered
    defaults; a placed metric's are its unplaced defaults), the
    compute-group update signature, and the buffer capacity."""
    states: Dict[str, Any] = {}
    for name, default in metric._defaults.items():
        tag = reduction_tag(metric._reductions[name])
        if isinstance(default, CatBuffer):
            states[name] = {"kind": "catbuffer", "reduction": tag}
        elif isinstance(default, (list, tuple)):
            states[name] = {"kind": "list", "reduction": tag}
        elif _is_sketch(default):
            states[name] = {
                "kind": "sketch",
                "reduction": tag,
                "sketch_class": type(default).__name__,
                "config": default.config_dict(),
            }
        else:
            shape, dtype = tuple(default.shape), default.dtype
            if name in metric._shard_templates:  # a block: the template holds the whole leaf's
                shape, dtype = metric._shard_templates[name][:2]
            states[name] = {
                "kind": "array",
                "reduction": tag,
                "shape": [int(s) for s in shape],
                "dtype": numpy_dtype_name(dtype),
            }
        # the declared shard axis is part of the state's static identity;
        # fingerprint_diff treats a missing key as compatible with any
        # declaration
        if metric._shard_axes.get(name) is not None:
            states[name]["shard_axis"] = shard_axis_meta(metric._shard_axes[name])
    sig = metric._update_signature()
    return {
        "class": type(metric).__name__,
        "states": states,
        "update_signature": None if sig is None else repr(sig),
        "buffer_capacity": metric.buffer_capacity,
    }


def object_fingerprint(obj: Any) -> Dict[str, Any]:
    """Fingerprint of a Metric, MetricCollection, or TenantSet."""
    if getattr(obj, "_is_tenant_set", False):
        return obj.fingerprint()
    kind, members = describe(obj)
    return {
        "format_version": FORMAT_VERSION,
        "kind": kind,
        "members": {key: metric_fingerprint(m) for key, m in members.items()},
    }


def fingerprint_diff(saved: Dict[str, Any], live: Dict[str, Any], path: str = "") -> List[str]:
    """Line-per-mismatch diff between two fingerprints (empty = compatible)."""
    lines: List[str] = []
    if isinstance(saved, dict) and isinstance(live, dict):
        for key in sorted(set(saved) | set(live)):
            sub = f"{path}.{key}" if path else str(key)
            if key == "shard_axis" and (key not in saved or key not in live):
                # a shard_axis declaration is placement-inert (the payload is
                # placement-free either way): only two conflicting
                # declarations diff
                continue
            if key not in saved:
                lines.append(f"{sub}: only in live object ({live[key]!r})")
            elif key not in live:
                lines.append(f"{sub}: only in checkpoint ({saved[key]!r})")
            else:
                lines.extend(fingerprint_diff(saved[key], live[key], sub))
        return lines
    if saved != live:
        lines.append(f"{path}: checkpoint={saved!r} live={live!r}")
    return lines


def build_shard(obj: Any) -> Tuple[Dict[str, Tensor], Dict[str, Any]]:
    """One rank's shard: ``(payload, shard_meta)``.

    ``shard_meta`` carries the per-member leaves metadata, update counts and
    the object fingerprint (the committer refuses shards whose fingerprints
    diverge). A :class:`~metrics_tpu_torch.tenancy.TenantSet` builds its own
    shard: the whole stacked state as ``tenant/{leader}.{state}`` arrays plus
    the slot table (kind ``"tenant_set"``).
    """
    if getattr(obj, "_is_tenant_set", False):
        return obj._ckpt_payload()
    kind, members = describe(obj)
    payload: Dict[str, Tensor] = {}
    members_meta: Dict[str, Any] = {}
    for key, metric in members.items():
        prefix = "" if key == SELF_KEY else f"{key}."
        p, leaves = metric_leaves(metric, prefix)
        payload.update(p)
        members_meta[key] = {
            "update_count": int(metric._update_count),
            "leaves": leaves,
            "aux": metric_aux(metric),
        }
    shard_meta = {
        "kind": kind,
        "members": members_meta,
        "fingerprint": object_fingerprint(obj),
    }
    return payload, shard_meta
