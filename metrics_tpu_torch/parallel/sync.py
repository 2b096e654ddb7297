"""Metric state sync over ``torch.distributed`` process groups.

Counterpart of ``metrics_tpu/parallel/sync.py``. Where the JAX package names a
mesh axis, the port takes a ``ProcessGroup``; where it emits
``psum``/``pmean``/``pmax``/``pmin``/``all_gather`` inside a ``shard_map``,
the port runs one collective:

- ``sum``, ``max`` and ``min`` states are one ``all_reduce``; ``mean`` is a
  SUM ``all_reduce`` divided by the group's size (gloo has no AVG);
- ``cat`` states are a ragged gather: the ranks exchange their shapes (one
  ``all_gather`` of a small int64 tensor, counted as ``size_exchange``), pad
  to the largest row count, ``all_gather`` and trim, in rank-major order;
- ``None`` stacks the ranks' values and a callable applies to the stack.

By default the leaves of a state are coalesced by ``(reduction, dtype,
transport)`` into one flat buffer per bucket and one collective each
(``_sync_bucketed``), as in the JAX package; ``CatBuffer`` states gather their
fill counts and overflow flags in one ``all_gather`` and their payloads in one
per dtype (``_sync_bucketed_catbuffers``). A sketch state (``"sketch"``) splits
into its components, each an elementwise ``sum``, ``max`` or ``min`` leaf that
joins the buckets like any other, and is reassembled after them: sketches add
no collective of their own. Bools cross the wire as int32, since gloo reduces
no bool.

**Transports** (the wire axis). Each sum bucket crosses the wire through a
declared transport: ``exact`` (the default), ``bf16`` (cast, ``all_reduce``,
upcast), ``int8`` (a MAX ``all_reduce`` of one scale per 256-element block,
then the int8 payload ``all_gather``-ed and summed locally in int32: the
JAX package widens to int32 inside its ``psum`` and counts int8 bytes; the
port hands int8 to ``torch.distributed`` and counts what it hands over) and
``sparse_count`` (the top ``K`` entries as values and indices, gathered and
scatter-added; a MAX ``all_reduce`` of the nonzero count, read on the host,
takes the dense ``all_reduce`` when any rank holds more than ``K``). Every
quantized bucket passes the error-budget gate (``_gate_transport``), which
refuses it back to exact with a reason-carrying record.

**Incremental sync** (the time axis). ``init_incremental`` /
``advance_incremental`` / ``finalize_incremental_state`` carry a streak's
state with a synced accumulator: every ``sync_every``-th step emits the
covered buckets' collectives, so finalize pays only cadence tails and the
non-elementwise residue, bitwise equal to a deferred ``sync_state`` of the
final state for exact transports.

``group=None`` is the identity: outside a multi-process run there is
nothing to sync. Unlike ``shard_map``, where every device runs one trace, the
ranks here run their own Python: every rank must call the same syncs in the
same order, with states of the same names, dtypes and number of dimensions.
An empty ``cat`` list or an unmaterialized ``CatBuffer`` passes through
unchanged, as in the JAX package, so a rank that never appended to such a
state must not sync it while others do.

**Sharded state** (``Metric.shard_state``). A sharded leaf is one disjoint
block per rank of the global state. Each update merges the rank's dense delta
into the owners' blocks: one ``reduce_scatter`` per ``(dtype, reduction,
shard dimension)`` bucket, coalesced with the shard axis in front
(:func:`reduce_scatter_merge`; a grid leaf takes one per mesh axis). At
``compute()`` a sharded leaf either re-materializes through the reshard
bucket (:func:`_sync_resharded`, one tiled ``all_gather`` per bucket, ticked
``"reshard"``, with the ``bf16``/``int8`` reshard codecs behind the gate's
``kind="reshard"`` bounds) or, under ``keep_sharded=True``, stays a block for
the metric's ``compute_sharded_state``, which combines only its result
(:func:`psum_result`, :func:`gather_result`). Where the JAX package takes a
tuple of axis names, the port takes a :class:`~metrics_tpu_torch.parallel.Mesh`:
replicated leaves then sum over every rank of the mesh, and a leaf sharded
along a tuple of array axes gathers over the mesh's axes in order.

**Observability and chaos.** ``sync_state`` records one
``sync/bucket_build`` span (with its collective tallies) and is the
``sync/bucket_build`` chaos site; an emission is the ``sync/incremental``
site and records ``sync/incremental_emit``; a gate refusal records
``sync/transport_refused``. The registry's ``metrics_tpu_sync_wire_bytes_total``,
``metrics_tpu_sync_logical_bytes_total`` and
``metrics_tpu_sync_transport_refusals_total`` tick per collective and
refusal, ``metrics_tpu_engine_incremental_emissions_total`` per emission,
and a finalize sets ``metrics_tpu_engine_incremental_deferred_residue_buckets``.
The JAX package runs these sites at trace time, once per compiled program;
here they run where the step's Python runs eagerly or at the engine's probe,
and go quiet (:func:`_quiet`) in a capture's second run of the step and in
the CPU's stand-in for a replay, so the card and the CPU record the same
events, fire the same faults and tally the same bytes.

Not ported here: tenant-stacked sync (A19), and the autotune controller that
``_resolve_transport`` and ``sync_cadence_default`` consult in the JAX
package (A20b): they fall through to the global defaults.
"""
from __future__ import annotations

import contextlib
import math
import os
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch import Tensor

from metrics_tpu_torch.core.buffers import CatBuffer, ShardedCatBuffer
from metrics_tpu_torch.observability import tracer as _otrace
from metrics_tpu_torch.observability.instruments import REGISTRY as _REGISTRY
from metrics_tpu_torch.parallel.mesh import Mesh
from metrics_tpu_torch.resilience import chaos as _chaos
from metrics_tpu_torch.sketches.base import is_sketch
from metrics_tpu_torch.utils.compute import class_reduce, reduce  # noqa: F401  (the JAX package's home of both)

Group = Optional[Union[dist.ProcessGroup, Mesh]]
ShardAxis = Union[int, Tuple[int, ...]]
Reduction = Optional[Union[str, Callable]]

_REDUCTIONS = ("sum", "mean", "max", "min", "cat", None)
_ELEMENTWISE = ("sum", "mean", "max", "min")
_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
# a sketch component's key in the flat entries: state name, separator, field
_SKETCH_SEP = "\x1e"

_ENV_BUCKETED = "METRICS_TPU_BUCKETED_SYNC"
_bucketed_enabled: Optional[bool] = None  # None = follow the environment


def bucketed_sync_enabled() -> bool:
    """Whether coalesced (bucketed) state sync is globally enabled."""
    if _bucketed_enabled is not None:
        return _bucketed_enabled
    return os.environ.get(_ENV_BUCKETED, "1").lower() not in ("0", "false", "off")


def set_bucketed_sync(enabled: Optional[bool]) -> None:
    """Globally enable or disable bucketed state sync.

    ``None`` restores the environment default (``METRICS_TPU_BUCKETED_SYNC``,
    on unless set to ``0``). The ``bucketed=`` argument of :func:`sync_state`
    takes precedence over this switch.
    """
    global _bucketed_enabled
    _bucketed_enabled = enabled


# --------------------------------------------------------------------------- #
# sync mode and cadence: deferred (at compute) or incremental (in the streak)
# --------------------------------------------------------------------------- #
# Precedence: per-state ``add_state(sync_mode=)`` > ``set_sync_mode()`` >
# ``METRICS_TPU_SYNC_MODE`` > ``"deferred"``; the cadence: the carry's
# ``sync_every=`` > ``set_sync_cadence()`` > ``METRICS_TPU_SYNC_EVERY`` > 1.
SYNC_MODES = ("deferred", "incremental")

_ENV_SYNC_MODE = "METRICS_TPU_SYNC_MODE"
_ENV_SYNC_EVERY = "METRICS_TPU_SYNC_EVERY"
_sync_mode_default: Optional[str] = None  # None = follow the environment
_sync_cadence_default: Optional[int] = None  # None = follow the environment


def _sketch_entries(key: str, sketch: Any) -> List[Tuple[str, Tensor, str]]:
    """Per-component ``(flat_key, tensor, reduction)`` rows of a sketch."""
    return [(f"{key}{_SKETCH_SEP}{fname}", getattr(sketch, fname), fred) for fname, fred in sketch.component_reductions()]


def _expand_sketch_maps(
    key: str,
    sketch: Any,
    transports: Optional[Dict[str, str]],
    tolerances: Optional[Dict[str, float]],
    eff_transports: Dict[str, str],
    eff_tolerances: Dict[str, float],
) -> None:
    """Copy a sketch state's declared transport and tolerance onto its
    components' flat keys, so the decomposed entries inherit them."""
    t = (transports or {}).get(key)
    tol = (tolerances or {}).get(key)
    for fname, _ in sketch.component_reductions():
        fkey = f"{key}{_SKETCH_SEP}{fname}"
        if t is not None:
            eff_transports[fkey] = t
        if tol is not None:
            eff_tolerances[fkey] = tol


def _is_integer(dtype: torch.dtype) -> bool:
    """numpy's ``issubdtype(dtype, integer)``: bool is not an integer."""
    return not dtype.is_floating_point and not dtype.is_complex and dtype != torch.bool


def _sketch_field_codec(fred: str, dtype: torch.dtype) -> str:
    """Incremental codec of one sketch component: integer sums fold (exact),
    the rest (max/min registers, float trackers) replace."""
    return "fold" if fred == "sum" and _is_integer(dtype) else "replace"


def sync_mode_default() -> str:
    """The process-wide default sync mode of states with no declaration
    (``set_sync_mode`` / ``METRICS_TPU_SYNC_MODE``, ``"deferred"`` unless
    overridden)."""
    if _sync_mode_default is not None:
        return _sync_mode_default
    env = os.environ.get(_ENV_SYNC_MODE, "deferred").strip().lower()
    return env if env in SYNC_MODES else "deferred"


def set_sync_mode(mode: Optional[str]) -> None:
    """Set the process-wide default sync mode.

    ``None`` restores the environment default (``METRICS_TPU_SYNC_MODE``,
    ``"deferred"``). Per-state ``add_state(..., sync_mode=...)`` declarations
    take precedence over this switch in both directions.
    """
    global _sync_mode_default
    if mode is not None and mode not in SYNC_MODES:
        raise ValueError(f"unknown sync mode {mode!r}; expected one of {SYNC_MODES}")
    _sync_mode_default = mode


def sync_cadence_default() -> int:
    """The default emission cadence K (every K-th update of an incremental
    streak emits): ``set_sync_cadence`` > ``METRICS_TPU_SYNC_EVERY`` > 1. The
    ``sync_every=`` argument of :func:`init_incremental` outranks all of them."""
    if _sync_cadence_default is not None:
        return _sync_cadence_default
    env = os.environ.get(_ENV_SYNC_EVERY)
    if env is not None:
        try:
            return max(1, int(env))
        except ValueError:
            return 1
    return 1


def set_sync_cadence(sync_every: Optional[int]) -> None:
    """Set the process-wide default emission cadence of incremental sync.

    ``None`` restores the environment default (``METRICS_TPU_SYNC_EVERY``, 1).
    """
    global _sync_cadence_default
    if sync_every is not None and int(sync_every) < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    _sync_cadence_default = None if sync_every is None else int(sync_every)


# --------------------------------------------------------------------------- #
# transports and their error model
# --------------------------------------------------------------------------- #
# Transports are configuration, never state: they change how bytes cross the
# wire, not what the state means.
TRANSPORTS = ("exact", "bf16", "int8", "sparse_count")

_ENV_TRANSPORT = "METRICS_TPU_SYNC_TRANSPORT"
_transport_default: Optional[str] = None  # None = follow the environment

# int8 quantization granularity: one max-abs scale per this many elements
INT8_BLOCK = 256
# sparse_count slots per rank as a fraction of the bucket's elements
SPARSE_COUNT_DENSITY = 0.25

# bf16 round-to-nearest relative error (8-bit significand with the hidden bit)
_EPS_BF16 = 2.0 ** -9
# int8 symmetric quantization levels across [-max_abs, +max_abs]
_INT8_LEVELS = 254.0

# Default relative tolerances (against the bucket's largest exact value): the
# gate refuses a quantized bucket whose predicted worst-case bound exceeds its
# tolerance. Lossless transports tolerate nothing and bound nothing.
DEFAULT_TOLERANCES = {"exact": 0.0, "sparse_count": 0.0, "bf16": 0.05, "int8": 0.05}

# dtypes a quantized transport may carry (sum reductions only), by name
_QUANTIZABLE_DTYPES = frozenset(("float32", "float64", "int32", "int64"))
_SPARSE_DTYPES = frozenset(("int32", "int64"))


def _dtype_name(dtype: Any) -> str:
    """``"float32"`` for ``torch.float32``, a numpy dtype or the string."""
    return str(dtype).replace("torch.", "")


def _itemsize(dtype: Any) -> int:
    return torch.empty((), dtype=getattr(torch, _dtype_name(dtype))).element_size()


def sync_transport_default() -> str:
    """The process-wide default transport of buckets with no per-state
    declaration (``set_sync_transport`` / ``METRICS_TPU_SYNC_TRANSPORT``,
    ``"exact"`` unless overridden)."""
    if _transport_default is not None:
        return _transport_default
    env = os.environ.get(_ENV_TRANSPORT, "exact").strip().lower()
    return env if env in TRANSPORTS else "exact"


def set_sync_transport(transport: Optional[str]) -> None:
    """Set the process-wide default sync transport.

    ``None`` restores the environment default (``METRICS_TPU_SYNC_TRANSPORT``,
    ``"exact"``). Per-state ``add_state(..., sync_transport=...)``
    declarations take precedence; the error-budget gate outranks both.
    """
    global _transport_default
    if transport is not None and transport not in TRANSPORTS:
        raise ValueError(f"unknown sync transport {transport!r}; expected one of {TRANSPORTS}")
    _transport_default = transport


def transport_error_bound(transport: str, world: int, kind: str = "psum") -> float:
    """Worst-case relative quantization error of one synced bucket.

    Relative to the bucket's largest exact magnitude (per int8 scale block
    for ``int8``), from the group's size alone. ``kind="psum"`` models the
    error of ``world`` reduced terms; ``kind="reshard"`` one cast or
    quantization of disjoint blocks (sharded state), independent of the
    group's size.
    """
    if transport in ("exact", "sparse_count"):
        return 0.0
    if transport == "bf16":
        # one cast per term plus the rounding of each add; +2 for the upcast
        return (2.0 * _EPS_BF16) if kind == "reshard" else (world + 2) * 2.0 * _EPS_BF16
    if transport == "int8":
        # each rank rounds to the shared scale grid: error <= scale / 2 = max / 254
        return (2.0 / _INT8_LEVELS) if kind == "reshard" else (world + 2) / _INT8_LEVELS
    raise ValueError(f"unknown sync transport {transport!r}")


def default_tolerance(transport: str) -> float:
    """The default tolerance of a transport (:data:`DEFAULT_TOLERANCES`);
    ``add_state(..., sync_tolerance=)`` overrides it, the tightest declared
    tolerance in a bucket winning."""
    return DEFAULT_TOLERANCES[transport]


def _transport_applicable(transport: str, red: Any, dtype: Any, kind: str = "psum") -> bool:
    """Whether a transport can carry a ``(reduction, dtype)`` bucket at all.
    An inapplicable one routes through ``exact`` with no refusal: a global
    ``bf16`` switch must not refuse every max or gather bucket."""
    if transport == "exact":
        return True
    name = _dtype_name(dtype)
    if kind == "reshard":
        return transport in ("bf16", "int8") and name in _QUANTIZABLE_DTYPES
    if red != "sum":
        return False
    if transport == "sparse_count":
        return name in _SPARSE_DTYPES
    return name in _QUANTIZABLE_DTYPES


def _sparse_slots(nelems: int) -> int:
    """The (index, value) slots each rank sends for a sparse_count bucket."""
    return max(1, min(nelems, int(math.ceil(SPARSE_COUNT_DENSITY * nelems))))


def transport_wire_bytes(transport: str, nelems: int, dtype: Any) -> int:
    """The bytes one rank puts into the collectives of one bucket on
    ``transport``, protocol included (the int8 scales, the sparse nonzero
    count), the sparse overflow branch left out."""
    n = int(nelems)
    itemsize = _itemsize(dtype)
    if transport == "exact":
        return n * itemsize
    if transport == "bf16":
        return 2 * n
    if transport == "int8":
        nblocks = -(-n // INT8_BLOCK) if n else 0
        return nblocks * (INT8_BLOCK + 4)
    if transport == "sparse_count":
        return 4 + 2 * _sparse_slots(n) * itemsize
    raise ValueError(f"unknown sync transport {transport!r}")


def _gate_transport(
    transport: str,
    red: Any,
    dtype: Any,
    nelems: int,
    world: Optional[int],
    tolerance: Optional[float],
    kind: str = "psum",
    error_scale: float = 1.0,
) -> Tuple[str, Optional[Dict[str, Any]]]:
    """The error-budget gate: ``(final_transport, refusal or None)``.

    A quantized transport is refused (exact, with a record) when its bound
    exceeds the bucket's tolerance or the group's size is unknown, and
    sparse_count when it cannot beat the dense bytes. An inapplicable
    transport routes to exact with no refusal. ``error_scale`` compounds the
    bound: the n-th incremental emission of a fold bucket carries n
    independently quantized deltas.
    """
    if transport == "exact":
        return "exact", None
    if not _transport_applicable(transport, red, dtype, kind):
        return "exact", None
    tol = default_tolerance(transport) if tolerance is None else float(tolerance)
    scale = max(1.0, float(error_scale))
    if world is None:
        refusal = {"transport": transport, "reason": "unknown_world", "bound": None, "tolerance": tol,
                   "elements": int(nelems)}
        if scale != 1.0:
            refusal["emissions"] = int(scale)
        return "exact", refusal
    bound = transport_error_bound(transport, world, kind) * scale
    if bound > tol:
        refusal = {"transport": transport, "reason": "error_budget", "bound": float(bound), "tolerance": tol,
                   "world": int(world), "elements": int(nelems)}
        if scale != 1.0:
            refusal["emissions"] = int(scale)
        return "exact", refusal
    if transport == "sparse_count":
        itemsize = _itemsize(dtype)
        k = _sparse_slots(nelems)
        if 2 * k * itemsize + 4 >= nelems * itemsize:
            return "exact", {"transport": transport, "reason": "no_byte_win", "bound": 0.0, "tolerance": tol,
                             "world": int(world), "elements": int(nelems), "slots": int(k)}
    return transport, None


def _resolve_transport(name: str, transports: Optional[Dict[str, str]]) -> str:
    """Per-state declaration > global default."""
    t = (transports or {}).get(name)
    if t is not None and t not in TRANSPORTS:
        raise ValueError(f"unknown sync transport {t!r} for state {name!r}; expected one of {TRANSPORTS}")
    return t if t is not None else sync_transport_default()


def _bucket_tolerance(names: Sequence[str], tolerances: Optional[Dict[str, float]]) -> Optional[float]:
    """The tightest declared tolerance in a bucket, or None (the default)."""
    declared = [float(tolerances[n]) for n in names if tolerances and n in tolerances]
    return min(declared) if declared else None


def _numel(val: Any) -> int:
    return int(math.prod(val.shape)) if len(val.shape) else 1


def transport_plan(
    state: Dict[str, Any],
    reductions: Dict[str, Reduction],
    world: int,
    transports: Optional[Dict[str, str]] = None,
    tolerances: Optional[Dict[str, float]] = None,
    error_scale: float = 1.0,
) -> List[Dict[str, Any]]:
    """The per-bucket transport decisions :func:`sync_state` would make in a
    group of ``world`` ranks, from shapes and dtypes alone (the leaves may be
    tensors or anything with ``shape`` and ``dtype``); nothing is synced.

    Each entry: ``{"names", "reduction", "dtype", "kind", "elements",
    "requested", "transport", "bound", "tolerance", "refusal", "wire_bytes",
    "logical_bytes"}``; ``transport`` is the gate's decision, ``wire_bytes``
    :func:`transport_wire_bytes` of it, ``logical_bytes`` the exact path's.
    ``error_scale`` plans the ``error_scale``-th incremental emission.
    """
    groups: Dict[Tuple[Any, str, str, str], List[Tuple[str, Any]]] = {}
    flat_items: List[Tuple[str, Any, Any]] = []
    eff_transports: Dict[str, str] = dict(transports or {})
    eff_tolerances: Dict[str, float] = dict(tolerances or {})
    for name, val in state.items():
        red = reductions.get(name)
        if is_sketch(val) and red == "sketch":
            _expand_sketch_maps(name, val, transports, tolerances, eff_transports, eff_tolerances)
            flat_items.extend(_sketch_entries(name, val))
            continue
        if getattr(val, "dtype", None) is None or getattr(val, "shape", None) is None or callable(red):
            continue
        flat_items.append((name, val, red))
    for name, val, red in flat_items:
        t = _resolve_transport(name, eff_transports)
        groups.setdefault((red, _dtype_name(val.dtype), t, "psum"), []).append((name, val))
    plan: List[Dict[str, Any]] = []
    for (red, dtype, requested, kind), items in groups.items():
        names = [n for n, _ in items]
        nelems = sum(_numel(v) for _, v in items)
        tol = _bucket_tolerance(names, eff_tolerances)
        final, refusal = _gate_transport(requested, red, dtype, nelems, world, tol, kind=kind, error_scale=error_scale)
        eff_tol = (default_tolerance(requested) if tol is None else float(tol)) if requested != "exact" else 0.0
        plan.append({
            "names": names,
            "reduction": red,
            "dtype": dtype,
            "kind": kind,
            "elements": nelems,
            "requested": requested,
            "transport": final,
            "bound": transport_error_bound(final, world, kind) * max(1.0, float(error_scale)),
            "tolerance": eff_tol,
            "refusal": refusal,
            "wire_bytes": transport_wire_bytes(final, nelems, dtype),
            "logical_bytes": nelems * _itemsize(dtype),
        })
    return plan


# --------------------------------------------------------------------------- #
# collective counting
# --------------------------------------------------------------------------- #
_counter = threading.local()


def _new_box() -> Dict[str, Any]:
    return {"count": 0, "by_kind": {}, "bytes": 0, "bytes_by_kind": {}, "bytes_by_transport": {}, "refusals": []}


@contextlib.contextmanager
def count_collectives() -> Iterator[Dict[str, Any]]:
    """Count the collectives this module issues while the block runs.

    Yields a dict: ``count``, ``by_kind`` (``all_reduce``, ``all_gather``,
    ``size_exchange``), ``bytes`` and ``bytes_by_kind``, the payload bytes
    each rank hands to ``torch.distributed`` (at the dtype it hands over: an
    int8 payload counts one byte an element, a bool state four, as int32);
    ``bytes_by_transport``, ``{transport: {"wire", "logical"}}``, where
    ``logical`` is what the exact path would have moved for the same bucket
    (protocol overhead, the int8 scales and the sparse nonzero count, has
    ``logical=0``; the sparse overflow branch counts under
    ``sparse_count_overflow``); and ``refusals``, the gate's records.

    The JAX package counts at trace time; the port counts the collectives it
    runs. A captured step's collectives count at its probe and again at
    every replay, none at its capture. ``psum``, ``pmean``, ``pmax`` and
    ``pmin`` are each an ``all_reduce`` here, and the int8 payload, a
    ``psum`` there, is an ``all_gather``. Boxes nest: every open box sees
    every collective.
    """
    stack = getattr(_counter, "stack", None)
    if stack is None:
        stack = _counter.stack = []
    box = _new_box()
    stack.append(box)
    try:
        yield box
    finally:
        popped = stack.pop()
        assert popped is box


@contextlib.contextmanager
def _muted() -> Iterator[None]:
    """No collective or refusal counts, and quiet (:func:`_quiet`), while
    the block runs (a capture, which records the collectives it does not
    run)."""
    prev = getattr(_counter, "muted", False)
    _counter.muted = True
    try:
        with _quiet():
            yield
    finally:
        _counter.muted = prev


@contextlib.contextmanager
def _quiet() -> Iterator[None]:
    """No tracer event, chaos site or registry tally of this module while
    the block runs: a capture's second run of a step the engine has probed,
    and the CPU's run of a captured step in place of a replay. The JAX
    package runs them once per compiled program, at trace time."""
    prev = getattr(_counter, "quiet", False)
    _counter.quiet = True
    try:
        yield
    finally:
        _counter.quiet = prev


def _hooks_quiet() -> bool:
    return getattr(_counter, "quiet", False)


def _open_boxes() -> Sequence[Dict[str, Any]]:
    if getattr(_counter, "muted", False):
        return ()
    return getattr(_counter, "stack", None) or ()


def _tick(kind: str, nbytes: int, logical: Optional[int] = None, transport: str = "exact") -> None:
    """Count one collective of ``nbytes`` on the wire; ``logical`` is what
    the exact path would move for it (default: the wire bytes)."""
    logical = nbytes if logical is None else logical
    if not _hooks_quiet():
        _REGISTRY.counter(
            "sync_wire_bytes_total",
            "Per-device sync collective payload bytes as sent on the wire, by transport.",
            transport=transport,
        ).inc(nbytes)
        _REGISTRY.counter(
            "sync_logical_bytes_total",
            "Per-device sync collective payload bytes at the buckets' logical dtypes, by transport.",
            transport=transport,
        ).inc(logical)
    for box in _open_boxes():
        box["count"] += 1
        box["by_kind"][kind] = box["by_kind"].get(kind, 0) + 1
        box["bytes"] += nbytes
        box["bytes_by_kind"][kind] = box["bytes_by_kind"].get(kind, 0) + nbytes
        per = box["bytes_by_transport"].setdefault(transport, {"wire": 0, "logical": 0})
        per["wire"] += nbytes
        per["logical"] += logical


def _tick_refusal(refusal: Dict[str, Any]) -> None:
    """Record one error-budget refusal: into every open counting box, the
    tracer (``sync/transport_refused``) and the registry's refusal counter."""
    for box in _open_boxes():
        box["refusals"].append(dict(refusal))
    if _hooks_quiet():
        return
    if _otrace.active:
        _otrace.emit_instant("sync/transport_refused", "sync", **refusal)
    _REGISTRY.counter(
        "sync_transport_refusals_total",
        "Buckets whose requested quantized transport the error-budget gate refused back to exact.",
        transport=str(refusal.get("transport")),
        reason=str(refusal.get("reason")),
    ).inc()


def replay_ticks(box: Dict[str, Any]) -> None:
    """Count again, in every open box, the collectives of ``box`` (a
    captured step's probe) but not its refusals: a replay runs the
    collectives and judges nothing."""
    for open_box in _open_boxes():
        open_box["count"] += box["count"]
        open_box["bytes"] += box["bytes"]
        for key in ("by_kind", "bytes_by_kind"):
            for kind, n in box[key].items():
                open_box[key][kind] = open_box[key].get(kind, 0) + n
        for transport, split in box["bytes_by_transport"].items():
            per = open_box["bytes_by_transport"].setdefault(transport, {"wire": 0, "logical": 0})
            per["wire"] += split["wire"]
            per["logical"] += split["logical"]


# --------------------------------------------------------------------------- #
# sync context: which group a metric's compute() syncs over
# --------------------------------------------------------------------------- #
_ctx = threading.local()


@contextlib.contextmanager
def sync_axes(group: Group) -> Iterator[None]:
    """Declare the process group that ``Metric.compute()``/``sync()`` sync
    over inside this block (the JAX package's mesh-axis context)."""
    prev = getattr(_ctx, "group", None)
    _ctx.group = group
    try:
        yield
    finally:
        _ctx.group = prev


def current_sync_axes() -> Group:
    return getattr(_ctx, "group", None)


def _default_group() -> Group:
    """The default group when this is a multi-rank run, else None."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def distributed_available() -> bool:
    """True under :func:`sync_axes` or when the default group has more than one rank."""
    return current_sync_axes() is not None or _default_group() is not None


# --------------------------------------------------------------------------- #
# collectives
# --------------------------------------------------------------------------- #
def _to_wire(x: Tensor) -> Tensor:
    """A contiguous copy that a collective may overwrite; bools as int32."""
    return x.to(torch.int32) if x.dtype == torch.bool else x.contiguous().clone()


def _nbytes(x: Tensor) -> int:
    return x.numel() * x.element_size()


def _all_reduce(x: Tensor, reduction: str, group: dist.ProcessGroup) -> Tensor:
    wire = _to_wire(x)
    _tick("all_reduce", _nbytes(wire))
    dist.all_reduce(wire, op=_REDUCE_OPS[reduction], group=group)
    if reduction == "mean":
        return wire / dist.get_world_size(group)
    if x.dtype == torch.bool and reduction != "sum":
        return wire.to(torch.bool)
    return wire


def _all_gather(x: Tensor, group: dist.ProcessGroup, kind: str = "all_gather", logical: Optional[int] = None,
                transport: str = "exact") -> List[Tensor]:
    """Every rank's ``x`` (equal shapes), in rank order."""
    wire = _to_wire(x)
    _tick(kind, _nbytes(wire), logical, transport)
    out = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, wire, group=group)
    return [o.to(torch.bool) for o in out] if x.dtype == torch.bool else out


def _pad_rows(x: Tensor, rows: int) -> Tensor:
    if x.shape[0] == rows:
        return x
    out = torch.zeros((rows, *x.shape[1:]), dtype=x.dtype, device=x.device)
    out[: x.shape[0]] = x
    return out


def _gather_ragged(leaves: Sequence[Tensor], group: dist.ProcessGroup, names: Sequence[str]) -> List[Tensor]:
    """Concatenate each leaf's rows across ranks, rank-major: one shape
    exchange, then one ``all_gather`` of the leaves padded to the largest
    rank's rows. The leaves share a dtype; their trailing shapes must agree
    across ranks."""
    shapes = torch.tensor([d for x in leaves for d in x.shape], dtype=torch.int64, device=leaves[0].device)
    all_shapes = [s.tolist() for s in _all_gather(shapes, group, kind="size_exchange")]
    per_rank: List[List[Tuple[int, ...]]] = []  # [rank][leaf] -> shape
    for flat in all_shapes:
        shaped, pos = [], 0
        for x in leaves:
            shaped.append(tuple(flat[pos : pos + x.ndim]))
            pos += x.ndim
        per_rank.append(shaped)
    for i, name in enumerate(names):
        widths = [shape[i][1:] for shape in per_rank]
        if len(set(widths)) > 1:
            raise ValueError(
                f"cannot sync the cat state {name!r}: the ranks hold rows of different trailing shapes "
                f"{widths} (rank order); pad every batch to one width before the update, for example "
                "with a tokenizer that pads to a fixed max_length"
            )
    max_rows = [max(shape[i][0] for shape in per_rank) for i in range(len(leaves))]
    if not any(max_rows):
        return list(leaves)
    flat = torch.cat([_pad_rows(x, m).reshape(-1) for x, m in zip(leaves, max_rows)])
    gathered = _all_gather(flat, group)
    out = []
    offset = 0
    for i, (x, m) in enumerate(zip(leaves, max_rows)):
        size = m * int(torch.Size(x.shape[1:]).numel())
        parts = [g[offset : offset + size].view(m, *x.shape[1:])[: shape[i][0]] for g, shape in zip(gathered, per_rank)]
        out.append(torch.cat(parts))
        offset += size
    return out


def sync_array(x: Tensor, reduction: Reduction, group: Group, name: str = "state") -> Tensor:
    """Sync one state tensor over ``group`` by its reduction tag.

    ``group=None`` is the identity. ``cat`` concatenates the ranks' rows in
    rank order (a ragged gather); ``None`` stacks the ranks' values into a
    leading axis and a callable reduces that stack.
    """
    if group is None:
        return x
    if reduction in _ELEMENTWISE:
        return _all_reduce(x, reduction, group)
    if reduction == "cat":
        return _gather_ragged([torch.atleast_1d(x)], group, [name])[0]
    if reduction is None:
        return torch.stack(_all_gather(x, group))
    if callable(reduction):
        return reduction(torch.stack(_all_gather(x, group)))
    raise ValueError(f"Unknown dist_reduce_fx {reduction!r}; expected one of {_REDUCTIONS} or a callable.")


# --------------------------------------------------------------------------- #
# sharded state: the placement's groups, the update merge, the result combine
# --------------------------------------------------------------------------- #
def _axis_groups(group: Group) -> Tuple[Optional[dist.ProcessGroup], Tuple[dist.ProcessGroup, ...]]:
    """``(the group replicated leaves reduce over, the groups of the sync's
    axes in order)``: a process group is both; a mesh is every rank of it and
    its axes' groups."""
    if isinstance(group, Mesh):
        return group.group(group.axis_names), tuple(group.group(name) for name in group.axis_names)
    return group, (group,)


def psum_result(x: Tensor, group: Group) -> Tensor:
    """Cross-shard sum of a *result* (the sharded-compute combine): one
    ``all_reduce`` ticked ``"psum"``, so :func:`count_collectives` shows that
    the protocol moved result bytes and no ``"reshard"`` bytes."""
    if group is None:
        return x
    wire = _to_wire(x)
    _tick("psum", _nbytes(wire))
    dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=_axis_groups(group)[0])
    return wire


def gather_result(x: Tensor, group: Group, axis: int = 0) -> Tensor:
    """Cross-shard concatenation of per-shard *result* blocks along ``axis``
    (rank order): one ``all_gather`` ticked ``"all_gather"``."""
    if group is None:
        return x
    return torch.cat(_all_gather(x, _axis_groups(group)[1][0]), dim=axis)


def _reduce_scatter_rows(x: Tensor, reduction: str, group: dist.ProcessGroup) -> Tensor:
    """This rank's ``1/width`` of ``x`` along dim 0, reduced over ``group``:
    one ``reduce_scatter``. ``reduce_scatter_single`` where torch has it (its
    older name warns from torch 2.13 on)."""
    x = x.contiguous()
    world = dist.get_world_size(group)
    out = torch.empty((x.shape[0] // world, *x.shape[1:]), dtype=x.dtype, device=x.device)
    _tick("reduce_scatter", _nbytes(x))
    scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    scatter(out, x, op=_REDUCE_OPS[reduction], group=group)
    return out


def _merge_block(block: Tensor, reduced: Tensor, reduction: str) -> Tensor:
    reduced = reduced.to(block.dtype)
    if reduction == "sum":
        return block + reduced
    return torch.maximum(block, reduced) if reduction == "max" else torch.minimum(block, reduced)


def reduce_scatter_merge(
    entries: Sequence[Tuple[str, Tensor, Tensor, ShardAxis, str]], group: Group
) -> Dict[str, Tensor]:
    """The sharded update's merge: each ``(name, block, delta, shard_axis,
    reduction)`` leaf's dense ``delta`` (this rank's update run on an
    identity copy of the whole leaf) reduced over every rank into this rank's
    ``block``.

    Leaves sharded along one axis bucket by ``(dtype, reduction, shard
    dimension)``: shard axis to the front, ``(dim, -1)`` per leaf,
    concatenated along dim 1, one ``reduce_scatter`` over the first axis's
    group. A grid leaf takes one per mesh axis, left to right over its
    axes. Over a mesh, the axes a leaf is not split along then reduce its
    block with one ``all_reduce`` (blocks are replicated along them). For
    ``sum`` the result is the global state bit for bit in any order for
    integer counts; ``max``/``min`` take that op.
    """
    names: Tuple[Any, ...] = group.axis_names if isinstance(group, Mesh) else (None,)

    def along(i: int) -> dist.ProcessGroup:
        return group.group(names[i]) if isinstance(group, Mesh) else group

    def rest(k: int) -> Optional[dist.ProcessGroup]:
        if not isinstance(group, Mesh) or k >= len(names):
            return None
        return group.group(names[k:])

    out: Dict[str, Tensor] = {}
    buckets: Dict[Tuple[torch.dtype, str, int], List[Tuple[str, Tensor, Tensor, int]]] = {}
    for name, block, delta, axis, red in entries:
        if red not in ("sum", "max", "min"):
            raise NotImplementedError(f"state {name!r}: a sharded leaf merges by sum, max or min, not {red!r}")
        if not isinstance(axis, tuple):
            a = axis % delta.ndim
            buckets.setdefault((delta.dtype, red, delta.shape[a]), []).append((name, block, delta, a))
            continue
        if len(axis) > len(names):
            raise ValueError(f"state {name!r} is sharded along {len(axis)} axes but the sync spans {len(names)}")
        reduced = delta
        for i, a in enumerate(axis):
            a %= delta.ndim
            reduced = _reduce_scatter_rows(reduced.movedim(a, 0), red, along(i)).movedim(0, a)
        if rest(len(axis)) is not None:
            reduced = _all_reduce(reduced, red, rest(len(axis)))
        out[name] = _merge_block(block, reduced, red)
    for (_, red, dim), items in buckets.items():
        moved = [delta.movedim(a, 0) for _, _, delta, a in items]
        flat = [m.reshape(dim, -1) for m in moved]
        # a lone leaf split along its first axis goes as it is, uncopied
        reduced = _reduce_scatter_rows(flat[0] if len(flat) == 1 else torch.cat(flat, dim=1), red, along(0))
        if rest(1) is not None:
            reduced = _all_reduce(reduced, red, rest(1))
        offset = 0
        for (name, block, _, a), m in zip(items, moved):
            width = m[0].numel() if dim else 0
            seg = reduced[:, offset : offset + width].reshape(reduced.shape[0], *m.shape[1:])
            offset += width
            out[name] = _merge_block(block, seg.movedim(0, a), red)
    return out


# --------------------------------------------------------------------------- #
# the codecs: how a flat sum bucket crosses the wire
# --------------------------------------------------------------------------- #
def _sum_bf16(flat: Tensor, group: dist.ProcessGroup, dtype: torch.dtype) -> Tensor:
    """Cast, ``all_reduce`` in bfloat16, upcast; integer buckets round back."""
    wire = flat.to(torch.bfloat16)
    _tick("all_reduce", _nbytes(wire), logical=_nbytes(flat), transport="bf16")
    dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=group)
    if _is_integer(dtype):
        return torch.round(wire.to(torch.float32)).to(dtype)
    return wire.to(dtype)


def _sum_int8(flat: Tensor, group: dist.ProcessGroup, dtype: torch.dtype) -> Tensor:
    """Per-block max-abs scales, then the int8 payload.

    A MAX ``all_reduce`` of one float32 max-abs per :data:`INT8_BLOCK`
    elements (protocol, ``logical=0``) gives every rank the same grid; each
    quantizes with round-half-to-even and clips to [-127, 127]. The payload
    crosses as int8: one ``all_gather``, summed here in int32, which cannot
    wrap for ``world * 127`` and is exact, so the result is bit for bit the
    JAX package's int32-accumulated ``psum``.
    """
    n = flat.numel()
    nblocks = -(-n // INT8_BLOCK)
    padded = torch.nn.functional.pad(flat.to(torch.float32), (0, nblocks * INT8_BLOCK - n))
    blocks = padded.view(nblocks, INT8_BLOCK)
    gmax = blocks.abs().amax(dim=1)
    _tick("all_reduce", _nbytes(gmax), logical=0, transport="int8")
    dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    # a tensor divisor: CUDA divides by a Python scalar as a multiplication
    # by its reciprocal, which may round differently from the division
    scale = torch.where(gmax > 0.0, gmax / torch.full_like(gmax, 127.0), torch.ones_like(gmax))
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127.0, 127.0).to(torch.int8)
    gathered = _all_gather(q, group, logical=_nbytes(flat), transport="int8")
    acc = torch.stack(gathered).to(torch.int32).sum(dim=0, dtype=torch.int32)
    deq = (acc.to(torch.float32) * scale[:, None]).reshape(-1)[:n]
    if _is_integer(dtype):
        return torch.round(deq).to(dtype)
    return deq.to(dtype)


def _sum_sparse_count(flat: Tensor, group: dist.ProcessGroup, dtype: torch.dtype) -> Tensor:
    """Values and indices of the ``K = ceil(density * n)`` largest-magnitude
    entries of each rank, gathered and scatter-added: lossless. A MAX
    ``all_reduce`` of the nonzero count, read on the host, takes the dense
    ``all_reduce`` (``sparse_count_overflow``) when any rank holds more than
    ``K`` nonzeros. The JAX package keeps both branches in one program
    (``lax.cond``); here the read is a host read, which a captured step
    refuses."""
    n = flat.numel()
    k = _sparse_slots(n)
    nnz = (flat != 0).sum(dtype=torch.int32).reshape(1)
    _tick("all_reduce", _nbytes(nnz), logical=0, transport="sparse_count")
    dist.all_reduce(nnz, op=dist.ReduceOp.MAX, group=group)
    if int(nnz) > k:
        wire = flat.contiguous().clone()
        _tick("all_reduce", _nbytes(wire), transport="sparse_count_overflow")
        dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=group)
        return wire
    idx = torch.topk(flat.abs(), k, sorted=False).indices
    payload = torch.cat([flat[idx], idx.to(dtype)])
    gathered = torch.stack(_all_gather(payload, group, logical=_nbytes(flat), transport="sparse_count"))  # (world, 2k)
    vals = gathered[:, :k].reshape(-1)
    gidx = gathered[:, k:].reshape(-1).to(torch.int64)
    return torch.zeros(n, dtype=dtype, device=flat.device).index_add_(0, gidx, vals)


_CODECS = {"bf16": _sum_bf16, "int8": _sum_int8, "sparse_count": _sum_sparse_count}


def _sync_bucketed(
    entries: List[Tuple[str, Tensor, Reduction]],
    group: dist.ProcessGroup,
    transports: Optional[Dict[str, str]] = None,
    tolerances: Optional[Dict[str, float]] = None,
    error_scale: float = 1.0,
) -> Dict[str, Tensor]:
    """One collective per ``(reduction, dtype, transport)`` bucket (plus one
    shape exchange for a ``cat`` bucket): the bucket's leaves are flattened
    with ``torch.cat`` and unflattened by offsets, bitwise equal to the
    per-leaf path. A singleton exact bucket goes straight through
    :func:`sync_array`. Every leaf resolves its transport (declaration >
    global default), so a state with no declaration buckets exactly as
    before; a quantized bucket passes the gate first, and a refused one syncs
    exact (splitting an elementwise bucket changes no leaf's value)."""
    out: Dict[str, Tensor] = {}
    buckets: Dict[Tuple[Reduction, torch.dtype, str], List[Tuple[str, Tensor]]] = {}
    for name, x, red in entries:
        buckets.setdefault((red, x.dtype, _resolve_transport(name, transports)), []).append((name, x))
    world = dist.get_world_size(group) if any(t != "exact" for _, _, t in buckets) else None
    for (red, dtype, requested), items in buckets.items():
        transport = requested
        if requested != "exact":
            names = [n for n, _ in items]
            nelems = sum(x.numel() for _, x in items)
            transport, refusal = _gate_transport(
                requested, red, dtype, nelems, world, _bucket_tolerance(names, tolerances), error_scale=error_scale
            )
            if refusal is not None:
                _tick_refusal(dict(refusal, reduction=str(red), dtype=_dtype_name(dtype), states=names))
        if transport != "exact":
            flat = items[0][1].reshape(-1) if len(items) == 1 else torch.cat([x.reshape(-1) for _, x in items])
            synced = _CODECS[transport](flat, group, dtype)
            offset = 0
            for name, x in items:
                out[name] = synced[offset : offset + x.numel()].view(x.shape)
                offset += x.numel()
        elif len(items) == 1:
            name, x = items[0]
            out[name] = sync_array(x, red, group, name)
        elif red in _ELEMENTWISE:
            synced = _all_reduce(torch.cat([x.reshape(-1) for _, x in items]), red, group)
            offset = 0
            for name, x in items:
                out[name] = synced[offset : offset + x.numel()].view(x.shape)
                offset += x.numel()
        elif red == "cat":
            names = [name for name, _ in items]
            out.update(zip(names, _gather_ragged([torch.atleast_1d(x) for _, x in items], group, names)))
        else:  # None: one stacking all_gather
            gathered = torch.stack(_all_gather(torch.cat([x.reshape(-1) for _, x in items]), group))
            offset = 0
            for name, x in items:
                out[name] = gathered[:, offset : offset + x.numel()].reshape(len(gathered), *x.shape)
                offset += x.numel()
    return out


def _sync_bucketed_catbuffers(entries: List[Tuple[str, CatBuffer]], group: dist.ProcessGroup) -> Dict[str, CatBuffer]:
    """``CatBuffer`` states: the valid row counts, true counts and overflow
    flags of every buffer in one ``all_gather`` (from the device tensors, so
    a buffer that a captured step filled needs no read before it), then the
    payloads in one per dtype, each buffer padded to the largest rank's valid
    rows (ranks may hold different capacities, since eager buffers grow
    geometrically). Each buffer comes back compacted, its rows in rank-major
    order, its count the true total, its overflow flag or-ed across ranks and
    set where a rank's count passed its capacity."""
    n = len(entries)
    device = entries[0][1].data.device
    meta = torch.cat(
        [b.count.clamp(max=b.capacity).reshape(1) for _, b in entries]
        + [b.count.reshape(1) for _, b in entries]
        + [b.overflowed.to(torch.int32).reshape(1) for _, b in entries]
    ).to(device=device, dtype=torch.int32)
    gmeta = torch.stack(_all_gather(meta, group)).cpu()  # (world, 3n): the one read of the counts
    world = gmeta.shape[0]
    rank = dist.get_rank(group)
    valid_rows, counts, flags = gmeta[:, :n], gmeta[:, n : 2 * n], gmeta[:, 2 * n :]
    max_rows = valid_rows.amax(dim=0).tolist()
    totals = counts.sum(dim=0).tolist()
    overflowed = ((flags != 0) | (counts > valid_rows)).any(dim=0).tolist()
    out: Dict[str, CatBuffer] = {}
    buckets: Dict[torch.dtype, List[Tuple[int, str, CatBuffer]]] = {}
    for i, (name, buf) in enumerate(entries):
        buckets.setdefault(buf.data.dtype, []).append((i, name, buf))
    for items in buckets.values():
        if not any(max_rows[i] for i, _, _ in items):  # no rank holds a row: nor a count, nor a flag
            out.update((name, buf.copy()) for _, name, buf in items)
            continue
        flat = torch.cat([
            _pad_rows(buf.data[: int(valid_rows[rank, i])], max_rows[i]).reshape(-1) for i, _, buf in items
        ])
        gathered = _all_gather(flat, group)
        offset = 0
        for i, name, buf in items:
            m, item = max_rows[i], buf.data.shape[1:]
            size = m * int(item.numel())
            data = torch.stack([g[offset : offset + size].view(m, *item) for g in gathered]).reshape(world * m, *item)
            offset += size
            valid = (torch.arange(m)[None, :] < valid_rows[:, i][:, None]).reshape(-1).to(device)
            out[name] = CatBuffer._compact(data, valid, totals[i], overflowed[i])
    return out


def _sync_resharded(
    entries: List[Tuple[str, Tensor, int]],
    group: dist.ProcessGroup,
    transports: Optional[Dict[str, str]] = None,
    tolerances: Optional[Dict[str, float]] = None,
) -> Dict[str, Tensor]:
    """The reshard bucket: each ``(name, block, shard_axis)`` leaf is this
    rank's disjoint block, so the sync is data movement only: one tiled
    ``all_gather`` along the shard axis rebuilds the global leaf. Leaves of
    one ``(dtype, shard dimension, transport)`` coalesce (shard axis to the
    front, ``(dim, -1)`` each, concatenated along dim 1). Every collective
    ticks ``"reshard"``.

    Transports: ``bf16`` casts each way; ``int8`` quantizes against one
    bucket-global max-abs scale (a MAX ``all_reduce`` of one float32,
    ``logical=0``). Neither accumulates, so both pass the gate with
    ``kind="reshard"`` bounds; ``sparse_count`` never applies here.
    """
    out: Dict[str, Tensor] = {}
    buckets: Dict[Tuple[torch.dtype, int, str], List[Tuple[str, Tensor, int]]] = {}
    for name, arr, axis in entries:
        axis %= max(arr.ndim, 1)
        buckets.setdefault((arr.dtype, int(arr.shape[axis]), _resolve_transport(name, transports)), []).append(
            (name, arr, axis)
        )
    world = dist.get_world_size(group) if any(t != "exact" for _, _, t in buckets) else None
    for (dtype, dim, requested), items in buckets.items():
        transport = requested
        if requested != "exact":
            names = [n for n, _, _ in items]
            nelems = sum(a.numel() for _, a, _ in items)
            transport, refusal = _gate_transport(
                requested, None, dtype, nelems, world, _bucket_tolerance(names, tolerances), kind="reshard"
            )
            if refusal is not None:
                _tick_refusal(dict(refusal, reduction="reshard", dtype=_dtype_name(dtype), states=names))
        if transport == "exact" and len(items) == 1:
            name, arr, axis = items[0]
            out[name] = torch.cat(_all_gather(arr, group, kind="reshard"), dim=axis)
            continue
        moved = [arr.movedim(axis, 0) for _, arr, axis in items]
        flat = torch.cat([m.reshape(dim, -1) for m in moved], dim=1)
        if transport == "bf16":
            wire = flat.to(torch.bfloat16)
            gathered = torch.cat(_all_gather(wire, group, kind="reshard", logical=_nbytes(flat), transport="bf16"))
            gathered = torch.round(gathered.to(torch.float32)).to(dtype) if _is_integer(dtype) else gathered.to(dtype)
        elif transport == "int8":
            fl32 = flat.to(torch.float32)
            gmax = fl32.abs().amax().reshape(1)
            _tick("all_reduce", _nbytes(gmax), logical=0, transport="int8")
            dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
            scale = torch.where(gmax > 0.0, gmax / torch.full_like(gmax, 127.0), torch.ones_like(gmax))
            q = torch.clamp(torch.round(fl32 / scale), -127.0, 127.0).to(torch.int8)
            deq = torch.cat(_all_gather(q, group, kind="reshard", logical=_nbytes(flat), transport="int8"))
            deq = deq.to(torch.float32) * scale
            gathered = torch.round(deq).to(dtype) if _is_integer(dtype) else deq.to(dtype)
        else:
            gathered = torch.cat(_all_gather(flat, group, kind="reshard"))
        offset = 0
        for (name, _, axis), m in zip(items, moved):
            width = m[0].numel() if dim else 0
            seg = gathered[:, offset : offset + width]
            offset += width
            out[name] = seg.reshape(gathered.shape[0], *m.shape[1:]).movedim(0, axis)
    return out


def _sync_resharded_multi(
    entries: List[Tuple[str, Tensor, Tuple[int, ...]]], groups: Sequence[dist.ProcessGroup]
) -> Dict[str, Tensor]:
    """Grid leaves (a tuple ``shard_axis``): one tiled ``all_gather`` per
    sharded axis over the sync's axis groups, paired positionally, left to
    right; each ticks ``"reshard"``."""
    out: Dict[str, Tensor] = {}
    for name, arr, axes in entries:
        axes = tuple(a % max(arr.ndim, 1) for a in axes)
        if len(axes) > len(groups):
            raise ValueError(
                f"state {name!r} is sharded along {len(axes)} axes but the sync spans only {len(groups)} mesh "
                "axis group(s); sync over the placement's Mesh"
            )
        for group, axis in zip(groups, axes):
            arr = torch.cat(_all_gather(arr, group, kind="reshard"), dim=axis)
        out[name] = arr
    return out


def sync_stacked_states(
    states: Dict[str, Dict[str, Any]],
    reductions: Dict[str, Dict[str, Reduction]],
    group: Group,
    transports: Optional[Dict[str, Dict[str, str]]] = None,
    tolerances: Optional[Dict[str, Dict[str, float]]] = None,
) -> Dict[str, Dict[str, Any]]:
    """Tenant-batched bucketed sync (:mod:`metrics_tpu_torch.tenancy`).

    ``states`` is ``{leader: {state: leaf}}`` whose leaves carry a leading
    tenant axis (a :class:`~metrics_tpu_torch.tenancy.TenantSet`'s
    capacity). An elementwise reduce of a stacked buffer is the stacked
    elementwise reduce, so the tenant axis folds into the flat
    ``(reduction, dtype, transport)`` buckets of :func:`_sync_bucketed`:
    every leader's leaves join the same buckets, and the collective count
    per sync is the bucket count, independent of N and of the number of
    leaders. Only elementwise reductions (and sketches, component by
    component) are legal: ``classify_tenant_member`` demotes the rest, so
    one here raises. ``transports`` and ``tolerances`` nest like
    ``reductions``. ``group=None`` returns the states unchanged.
    """
    if group is None:
        return {lname: dict(st) for lname, st in states.items()}
    entries: List[Tuple[str, Tensor, Reduction]] = []
    flat_transports: Dict[str, str] = {}
    flat_tolerances: Dict[str, float] = {}
    sketch_templates: Dict[Tuple[str, str], Any] = {}
    for lname, st in states.items():
        reds = reductions[lname]
        declared_t = (transports or {}).get(lname) or {}
        declared_tol = (tolerances or {}).get(lname) or {}
        for name, leaf in st.items():
            red = reds.get(name)
            # \x1f never appears in metric or state names: leader and state
            # join into one flat key, so all leaders share one bucket namespace
            key = f"{lname}\x1f{name}"
            if red == "sketch" and is_sketch(leaf):
                sketch_templates[(lname, name)] = leaf
                rows = _sketch_entries(key, leaf)
            elif red in _ELEMENTWISE:
                rows = [(key, leaf, red)]
            else:
                raise ValueError(
                    f"sync_stacked_states: state {lname!r}.{name!r} has non-elementwise reduction {red!r}: its"
                    " tenant axis cannot fold into a flat bucket (classify_tenant_member should have demoted"
                    " this group)."
                )
            for fkey, arr, fred in rows:
                entries.append((fkey, arr, fred))
                if name in declared_t:
                    flat_transports[fkey] = declared_t[name]
                if name in declared_tol:
                    flat_tolerances[fkey] = declared_tol[name]
    whole, _ = _axis_groups(group)
    synced = _sync_bucketed(entries, whole, flat_transports, flat_tolerances)
    out: Dict[str, Dict[str, Any]] = {lname: {} for lname in states}
    for key, leaf in synced.items():
        lname, name = key.split("\x1f", 1)
        out[lname][name] = leaf
    for (lname, name), template in sketch_templates.items():
        out[lname][name] = template.replace(**{
            f: out[lname].pop(f"{name}{_SKETCH_SEP}{f}") for f, _ in template.component_reductions()
        })
    return {lname: {name: out[lname][name] for name in st} for lname, st in states.items()}


def sync_state(
    state: Dict[str, Any],
    reductions: Dict[str, Reduction],
    group: Group,
    bucketed: Optional[bool] = None,
    transports: Optional[Dict[str, str]] = None,
    tolerances: Optional[Dict[str, float]] = None,
    shard_axes: Optional[Dict[str, ShardAxis]] = None,
    keep_sharded: bool = False,
) -> Dict[str, Any]:
    """Sync a whole state dict over ``group`` by each state's reduction tag.

    ``cat`` list states are concatenated locally first, so each costs one
    gather, and come back as a one-element container of the input's type.
    ``bucketed`` (default: :func:`bucketed_sync_enabled`) coalesces the
    leaves by ``(reduction, dtype, transport)``; materialized ``CatBuffer``
    states join their own bucket; callables always sync per leaf; a sketch
    syncs as its components (each by its own reduction, each taking the
    sketch's declared transport and tolerance) and comes back reassembled.
    ``transports`` (name -> transport) and ``tolerances`` (name -> relative
    budget) pick each state's codec; undeclared states follow
    :func:`sync_transport_default`, and every quantized bucket passes the
    error-budget gate. ``group=None`` returns the state unchanged.

    ``shard_axes`` (name -> axis or tuple of axes) names the leaves that are
    sharded blocks (an active ``Metric.shard_state`` placement): they skip
    the reduction buckets and re-materialize through the reshard bucket
    (:func:`_sync_resharded`; tuple axes through :func:`_sync_resharded_multi`;
    a sample-sharded ``CatBuffer`` through one ``all_gather`` of its blocks,
    ticked ``"reshard"``). ``keep_sharded=True`` passes them through as
    blocks (the sharded-compute protocol). ``group`` may be a
    :class:`~metrics_tpu_torch.parallel.Mesh` (its axes in order): replicated
    leaves then sum over every rank of it.

    While the tracer is on, each call records one ``sync/bucket_build`` span
    with its own collective tallies (a nested :func:`count_collectives` box:
    the caller's boxes still see every collective); each call is the
    ``sync/bucket_build`` chaos site.
    """
    if group is None:
        return dict(state)
    args = (state, reductions, group, bucketed, transports, tolerances, shard_axes, keep_sharded)
    if not _otrace.active or _hooks_quiet():
        return _sync_state_impl(*args)
    t0_us = _otrace._now_us()
    with count_collectives() as box:
        out = _sync_state_impl(*args)
    _otrace.emit_complete(
        "sync/bucket_build", "sync", t0_us, _otrace._now_us() - t0_us,
        axis=_group_label(group), leaves=len(state),
        collectives=dict(box["by_kind"]),
        collective_bytes=dict(box["bytes_by_kind"]),
        bytes_by_transport={k: dict(v) for k, v in box["bytes_by_transport"].items()},
        transport_refusals=len(box["refusals"]),
    )
    return out


def _group_label(group: Group) -> str:
    """A group's name in the tracer's args: a mesh's axes, else the group's size."""
    if isinstance(group, Mesh):
        return ",".join(group.axis_names)
    return f"group[{dist.get_world_size(group)}]"


def _sync_state_impl(
    state: Dict[str, Any],
    reductions: Dict[str, Reduction],
    group: Group,
    bucketed: Optional[bool],
    transports: Optional[Dict[str, str]],
    tolerances: Optional[Dict[str, float]],
    shard_axes: Optional[Dict[str, ShardAxis]],
    keep_sharded: bool,
) -> Dict[str, Any]:
    if _chaos.active and not _hooks_quiet():
        _chaos.maybe_fail("sync/bucket_build", leaves=len(state))
    if bucketed is None:
        bucketed = bucketed_sync_enabled()
    shard_axes = shard_axes or {}
    whole, axis_groups = _axis_groups(group)
    out: Dict[str, Any] = {}
    entries: List[Tuple[str, Tensor, Reduction]] = []
    shard_entries: List[Tuple[str, Tensor, int]] = []
    multi_entries: List[Tuple[str, Tensor, Tuple[int, ...]]] = []
    buf_entries: List[Tuple[str, CatBuffer]] = []
    rewrap: Dict[str, type] = {}
    sketches: Dict[str, Any] = {}
    eff_transports: Dict[str, str] = dict(transports or {})
    eff_tolerances: Dict[str, float] = dict(tolerances or {})
    for name, val in state.items():
        red = reductions.get(name)
        if is_sketch(val):
            if red != "sketch":
                raise ValueError(f"sketch state {name!r} requires dist_reduce_fx 'sketch', got {red!r}")
            sketches[name] = val
            _expand_sketch_maps(name, val, transports, tolerances, eff_transports, eff_tolerances)
            for key, comp, fred in _sketch_entries(name, val):
                if bucketed:
                    entries.append((key, comp, fred))
                else:
                    out[key] = sync_array(comp, fred, whole, key)
            continue
        if isinstance(val, CatBuffer):
            if red not in ("cat", None):
                raise ValueError(f"CatBuffer state {name!r} only supports dist_reduce_fx 'cat'/None, got {red!r}")
            if isinstance(val, ShardedCatBuffer):
                out[name] = val if keep_sharded else val.gather(axis_groups[0], kind="reshard")
            elif not val.materialized:
                out[name] = val
            elif bucketed:
                buf_entries.append((name, val))
            else:
                out[name] = val.gather(whole)
            continue
        if name in shard_axes and isinstance(val, Tensor):
            if keep_sharded:
                out[name] = val
            elif isinstance(shard_axes[name], tuple):
                multi_entries.append((name, val, shard_axes[name]))
            else:
                shard_entries.append((name, val, shard_axes[name]))
            continue
        if isinstance(val, (list, tuple)):
            if len(val) == 0:
                out[name] = val
                continue
            rewrap[name] = type(val)
            leaves = [torch.atleast_1d(v) for v in val]
            if len({tuple(v.shape[1:]) for v in leaves}) > 1:
                raise ValueError(
                    f"cannot sync the cat state {name!r}: its batches have different trailing shapes "
                    f"{sorted({tuple(v.shape[1:]) for v in leaves})}; pad every batch to one width before the update"
                )
            val = torch.cat(leaves)
            red = "cat" if red is None else red
        if bucketed and (red in _REDUCTIONS):
            entries.append((name, val, red))
        else:
            out[name] = sync_array(val, red, whole, name)
    if entries:
        out.update(_sync_bucketed(entries, whole, eff_transports, eff_tolerances))
    if shard_entries:
        out.update(_sync_resharded(shard_entries, axis_groups[0], transports, tolerances))
    if multi_entries:
        out.update(_sync_resharded_multi(multi_entries, axis_groups))
    if buf_entries:
        out.update(_sync_bucketed_catbuffers(buf_entries, whole))
    for name, container in rewrap.items():
        out[name] = container((out[name],))
    for name, sketch in sketches.items():
        out[name] = sketch.replace(**{f: out[f"{name}{_SKETCH_SEP}{f}"] for f, _ in sketch.component_reductions()})
    return {name: out[name] for name in state}


def sync_host_read(
    state: Dict[str, Any],
    reductions: Dict[str, Reduction],
    group: Group,
    transports: Optional[Dict[str, str]] = None,
    tolerances: Optional[Dict[str, float]] = None,
    shard_axes: Optional[Dict[str, ShardAxis]] = None,
) -> Optional[str]:
    """Why :func:`sync_state` of ``state`` would read a value back to the
    host (which a captured step cannot do), or None. Decided from the
    structure, the declarations and the group's size alone, before any
    collective runs, so every rank refuses alike. A sharded leaf reads
    nothing: its blocks are of one size and its buffer count is global."""
    if group is None:
        return None
    shard_axes = shard_axes or {}
    state = {name: val for name, val in state.items() if name not in shard_axes}
    for name, val in state.items():
        red = reductions.get(name)
        if isinstance(val, CatBuffer) and val.materialized:
            return f"the sync of CatBuffer state {name!r} reads the ranks' fill counts back to the host"
        if isinstance(val, (list, tuple)) and len(val):
            return f"the sync of list state {name!r} exchanges its ranks' shapes through the host"
        if isinstance(val, Tensor) and red == "cat":
            return f"the ragged gather of cat state {name!r} exchanges its ranks' shapes through the host"
    world = dist.get_world_size(_axis_groups(group)[0])
    for entry in transport_plan(state, reductions, world, transports, tolerances):
        if entry["transport"] == "sparse_count":
            return (f"the sparse_count sync of {entry['names']} reads its nonzero count back to the host to pick "
                    "its branch")
    return None


def gather_all_arrays(x: Tensor, group: Group = None) -> List[Tensor]:
    """Every rank's ``x``, trimmed to its own rows (ranks may hold different
    row counts), in rank order. Outside a multi-rank run: ``[x]``."""
    group = group if group is not None else _default_group()
    if group is None:
        return [x]
    x = torch.atleast_1d(x)
    shapes = [s.tolist() for s in _all_gather(torch.tensor(x.shape, dtype=torch.int64, device=x.device), group, "size_exchange")]
    rows = max(s[0] for s in shapes)
    return [g[: s[0]] for g, s in zip(_all_gather(_pad_rows(x, rows), group), shapes)]


# --------------------------------------------------------------------------- #
# incremental sync: in-streak per-bucket emissions
# --------------------------------------------------------------------------- #
# Two emission codecs, chosen so that incremental equals deferred bit for bit
# under exact transports:
#
# ``fold``     integer ``sum`` leaves. Each emission syncs the delta since the
#              last one and adds it to a synced accumulator (``acc +=
#              sum(state - last); last = state``); integer adds are exact and
#              associative, so a cadence tail costs one residual delta sync.
#              Quantized transports compound per emission: the gate judges
#              the ``emission``-th bound.
# ``replace``  float ``sum`` and any ``mean``/``max``/``min`` leaves. Each
#              emission runs the bucket's full collective and replaces the
#              accumulator; the last one is the deferred collective itself
#              when the cadence lands on the final update, else finalize
#              re-syncs the live state.
#
# Everything else (cat/None/callable reductions, list and CatBuffer states,
# and the leaves of an active shard_axis placement) is residue: the ordinary
# deferred sync at finalize, resharded or kept sharded.
def _resolve_mode(name: str, modes: Optional[Dict[str, str]]) -> str:
    m = (modes or {}).get(name)
    if m is not None and m not in SYNC_MODES:
        raise ValueError(f"unknown sync mode {m!r} for state {name!r}; expected one of {SYNC_MODES}")
    return m if m is not None else sync_mode_default()


def incremental_plan(
    state: Dict[str, Any],
    reductions: Dict[str, Reduction],
    modes: Optional[Dict[str, str]] = None,
    shard_axes: Optional[Dict[str, Any]] = None,
) -> Dict[str, Dict[str, Any]]:
    """Per-leaf routing of incremental sync: ``{name: {"mode", "codec",
    "eligible", "reason"}}``. ``mode`` is ``"incremental"`` (the leaf takes
    emissions) or ``"deferred"`` (finalize residue); ``codec`` is ``"fold"``,
    ``"replace"``, ``"sketch"`` or None; ``eligible`` says whether the leaf
    could take emissions (a dense tensor of an elementwise reduction, not
    sharded); ``reason`` explains a deferred routing. Reads only dtypes and
    declarations. ``shard_axes`` names the leaves of an active placement,
    which stay residue."""
    shard_axes = shard_axes or {}
    plan: Dict[str, Dict[str, Any]] = {}
    for name, val in state.items():
        red = reductions.get(name)
        if is_sketch(val) and red == "sketch":
            if _resolve_mode(name, modes) == "incremental":
                plan[name] = {"mode": "incremental", "codec": "sketch", "eligible": True, "reason": ""}
            else:
                plan[name] = {"mode": "deferred", "codec": "sketch", "eligible": True,
                              "reason": "sync mode resolves to deferred"}
            continue
        dtype = None if isinstance(val, CatBuffer) else getattr(val, "dtype", None)
        if isinstance(val, (list, tuple)) or dtype is None:
            entry = {"mode": "deferred", "codec": None, "eligible": False,
                     "reason": "non-array state (list/CatBuffer) has per-device layout"}
        elif callable(red) or red not in _ELEMENTWISE:
            entry = {"mode": "deferred", "codec": None, "eligible": False,
                     "reason": f"reduction {red!r} is not mergeable-elementwise"}
        elif name in shard_axes:
            entry = {"mode": "deferred", "codec": None, "eligible": False,
                     "reason": "shard_axis leaves sync gather-free/resharded at finalize"}
        else:
            codec = "fold" if red == "sum" and _is_integer(dtype) else "replace"
            if _resolve_mode(name, modes) == "incremental":
                entry = {"mode": "incremental", "codec": codec, "eligible": True, "reason": ""}
            else:
                entry = {"mode": "deferred", "codec": codec, "eligible": True, "reason": "sync mode resolves to deferred"}
        plan[name] = entry
    return plan


class IncrementalCarry:
    """A streak's ``(state, acc, last)`` with its cadence bookkeeping.

    ``state`` is the live, unsynced state (authoritative for residue);
    ``acc`` the synced accumulator of each covered leaf; ``last`` the state
    of each ``fold`` leaf at the last emission. ``sync_every``, ``pending``,
    ``emissions`` and ``track_emissions`` are Python ints and a bool: the
    static part of the JAX package's pytree, here the spec of the engines'
    tree flattener (``core/engine.py``), which flattens a carry into its
    three dicts. ``pending`` cycles ``0..K-1`` (saturating at K where
    nothing emits); ``emissions`` is the ordinal the quantized gate
    compounds by, saturating at 1 when no covered leaf is quantized.
    """

    __slots__ = ("state", "acc", "last", "sync_every", "pending", "emissions", "track_emissions")

    def __init__(
        self,
        state: Dict[str, Any],
        acc: Dict[str, Tensor],
        last: Dict[str, Tensor],
        sync_every: int = 1,
        pending: int = 0,
        emissions: int = 0,
        track_emissions: bool = False,
    ) -> None:
        self.state = state
        self.acc = acc
        self.last = last
        self.sync_every = int(sync_every)
        self.pending = int(pending)
        self.emissions = int(emissions)
        self.track_emissions = bool(track_emissions)

    @property
    def synced(self) -> bool:
        """Whether at least one emission has run (``acc`` holds real data)."""
        return self.emissions > 0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"IncrementalCarry(leaves={len(self.state)}, covered={len(self.acc)}, sync_every={self.sync_every}, "
                f"pending={self.pending}, emissions={self.emissions})")


def init_incremental(
    state: Dict[str, Any],
    reductions: Dict[str, Reduction],
    *,
    modes: Optional[Dict[str, str]] = None,
    sync_every: Optional[int] = None,
    transports: Optional[Dict[str, str]] = None,
    shard_axes: Optional[Dict[str, ShardAxis]] = None,
) -> IncrementalCarry:
    """A fresh :class:`IncrementalCarry` around ``state``: zero accumulators
    for the covered leaves and zero delta bases for the ``fold`` ones (the
    first delta is the whole state). ``sync_every`` (default
    :func:`sync_cadence_default`) is the cadence K."""
    k = sync_cadence_default() if sync_every is None else int(sync_every)
    if k < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    plan = incremental_plan(state, reductions, modes=modes, shard_axes=shard_axes)
    acc: Dict[str, Tensor] = {}
    last: Dict[str, Tensor] = {}
    covered: List[str] = []
    eff_transports: Dict[str, str] = dict(transports or {})
    for name, entry in plan.items():
        if entry["mode"] != "incremental":
            continue
        if entry["codec"] == "sketch":
            sk = state[name]
            _expand_sketch_maps(name, sk, transports, None, eff_transports, {})
            for key, comp, fred in _sketch_entries(name, sk):
                acc[key] = torch.zeros_like(comp)
                if _sketch_field_codec(fred, comp.dtype) == "fold":
                    last[key] = torch.zeros_like(comp)
                covered.append(key)
            continue
        leaf = state[name]
        acc[name] = torch.zeros_like(leaf)
        if entry["codec"] == "fold":
            last[name] = torch.zeros_like(leaf)
        covered.append(name)
    track = any(_resolve_transport(n, eff_transports) != "exact" for n in covered)
    return IncrementalCarry(dict(state), acc, last, sync_every=k, pending=0, emissions=0, track_emissions=track)


def _emission_entries(
    state: Dict[str, Any],
    last: Dict[str, Tensor],
    reductions: Dict[str, Reduction],
    modes: Optional[Dict[str, str]],
    transports: Optional[Dict[str, str]],
    tolerances: Optional[Dict[str, float]],
    shard_axes: Optional[Dict[str, ShardAxis]] = None,
) -> Tuple[List[Tuple[str, Tensor, Reduction]], List[Tuple[str, Tensor, Reduction]], Dict[str, Tensor],
           Dict[str, str], Dict[str, float]]:
    """The fold entries (deltas), the replace entries (live leaves), the live
    leaf of each, and the transports and tolerances with sketch components
    expanded, of one emission."""
    plan = incremental_plan(state, reductions, modes=modes, shard_axes=shard_axes)
    fold: List[Tuple[str, Tensor, Reduction]] = []
    replace: List[Tuple[str, Tensor, Reduction]] = []
    live: Dict[str, Tensor] = {}
    eff_transports: Dict[str, str] = dict(transports or {})
    eff_tolerances: Dict[str, float] = dict(tolerances or {})
    for name, entry in plan.items():
        if entry["mode"] != "incremental":
            continue
        if entry["codec"] == "sketch":
            sk = state[name]
            _expand_sketch_maps(name, sk, transports, tolerances, eff_transports, eff_tolerances)
            for key, comp, fred in _sketch_entries(name, sk):
                live[key] = comp
                if _sketch_field_codec(fred, comp.dtype) == "fold":
                    fold.append((key, comp - last[key], "sum"))
                else:
                    replace.append((key, comp, fred))
            continue
        arr = state[name]
        live[name] = arr
        if entry["codec"] == "fold":
            fold.append((name, arr - last[name], "sum"))
        else:
            replace.append((name, arr, reductions.get(name)))
    return fold, replace, live, eff_transports, eff_tolerances


def emit_incremental(
    state: Dict[str, Any],
    acc: Dict[str, Tensor],
    last: Dict[str, Tensor],
    reductions: Dict[str, Reduction],
    group: dist.ProcessGroup,
    *,
    modes: Optional[Dict[str, str]] = None,
    transports: Optional[Dict[str, str]] = None,
    tolerances: Optional[Dict[str, float]] = None,
    emission: int = 1,
    shard_axes: Optional[Dict[str, ShardAxis]] = None,
) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """One in-streak emission: the new ``(acc, last)``. ``fold`` leaves sync
    their delta since ``last`` (bucketed like the deferred path, gated at the
    ``emission``-th compounded bound) into ``acc``; ``replace`` leaves run
    their full bucket collective and replace ``acc``. Each emission is the
    ``sync/incremental`` chaos site, records a ``sync/incremental_emit``
    span and ticks ``metrics_tpu_engine_incremental_emissions_total``."""
    quiet = _hooks_quiet()
    if _chaos.active and not quiet:
        _chaos.maybe_fail("sync/incremental", covered=len(acc), emission=int(emission))
    fold, replace, live, eff_transports, eff_tolerances = _emission_entries(
        state, last, reductions, modes, transports, tolerances, shard_axes
    )
    axis = _group_label(group) if _otrace.active and not quiet else ""
    group = _axis_groups(group)[0]
    t0_us = _otrace._now_us() if _otrace.active else 0
    new_acc = dict(acc)
    new_last = dict(last)
    with count_collectives() as box:
        if fold:
            # fold and replace leaves never share a bucket (fold is exactly the
            # integer sums), so two calls bucket as one would
            synced = _sync_bucketed(fold, group, eff_transports, eff_tolerances, error_scale=float(emission))
            for name, _, _ in fold:
                new_acc[name] = acc[name] + synced[name]
                new_last[name] = live[name]
        if replace:
            # a full collective each time: its error does not compound
            synced = _sync_bucketed(replace, group, eff_transports, eff_tolerances)
            for name, _, _ in replace:
                new_acc[name] = synced[name]
    if not quiet:
        if _otrace.active:
            _otrace.emit_complete(
                "sync/incremental_emit", "sync", t0_us, _otrace._now_us() - t0_us,
                axis=axis, emission=int(emission), fold_leaves=len(fold), replace_leaves=len(replace),
                collectives=dict(box["by_kind"]), collective_bytes=dict(box["bytes_by_kind"]),
            )
        _REGISTRY.counter(
            "engine_incremental_emissions_total",
            "In-streak incremental sync emissions (counted where the step's Python runs: eagerly or at the probe).",
        ).inc()
    return new_acc, new_last


def finalize_incremental(
    state: Dict[str, Any],
    acc: Dict[str, Tensor],
    last: Dict[str, Tensor],
    reductions: Dict[str, Reduction],
    group: Group,
    *,
    pending: int,
    synced: bool,
    modes: Optional[Dict[str, str]] = None,
    transports: Optional[Dict[str, str]] = None,
    tolerances: Optional[Dict[str, float]] = None,
    bucketed: Optional[bool] = None,
    emission: int = 1,
    shard_axes: Optional[Dict[str, ShardAxis]] = None,
    keep_sharded: bool = False,
) -> Dict[str, Any]:
    """The synced state at the end of a streak, paying only the residue:

    - covered and fresh (``pending == 0`` after an emission): the
      accumulator is the synced leaf, no collective;
    - covered ``fold`` with a cadence tail: one residual delta sync per
      bucket, folded in (still exact for integer sums);
    - covered ``replace`` with a tail, or a carry that never emitted: the
      live state through the deferred path;
    - residue leaves: the ordinary :func:`sync_state` (sharded leaves
      resharded, or kept as blocks under ``keep_sharded``).

    Sets the ``metrics_tpu_engine_incremental_deferred_residue_buckets``
    gauge to the number of collectives this finalize paid.
    """
    if group is None:
        return dict(state)
    plan = incremental_plan(state, reductions, modes=modes, shard_axes=shard_axes)
    out: Dict[str, Any] = {}
    residue: Dict[str, Any] = {}
    fold_tail: List[Tuple[str, Tensor, Reduction]] = []
    for name, entry in plan.items():
        if entry["codec"] == "sketch" and is_sketch(state.get(name)):
            sk = state[name]
            keys = [f"{name}{_SKETCH_SEP}{fname}" for fname, _ in sk.component_reductions()]
            covered = entry["mode"] == "incremental" and all(k in acc for k in keys)
            if covered and synced and pending <= 0:
                out[name] = sk.replace(**{f: acc[f"{name}{_SKETCH_SEP}{f}"] for f, _ in sk.component_reductions()})
            else:
                # a tail or no emission: the max/min components re-sync anyway
                residue[name] = sk
            continue
        covered = entry["mode"] == "incremental" and name in acc
        if not covered or not synced:
            residue[name] = state[name]
        elif pending <= 0:
            out[name] = acc[name]
        elif entry["codec"] == "fold":
            fold_tail.append((name, state[name] - last[name], "sum"))
        else:
            residue[name] = state[name]
    with count_collectives() as box:
        if fold_tail:
            tail = _sync_bucketed(fold_tail, _axis_groups(group)[0], transports, tolerances,
                                  error_scale=float(emission))
            for name, _, _ in fold_tail:
                out[name] = acc[name] + tail[name]
        if residue:
            out.update(sync_state(
                residue, {n: reductions.get(n) for n in residue}, group, bucketed=bucketed,
                transports={n: t for n, t in (transports or {}).items() if n in residue},
                tolerances={n: t for n, t in (tolerances or {}).items() if n in residue},
                shard_axes={n: a for n, a in (shard_axes or {}).items() if n in residue}, keep_sharded=keep_sharded,
            ))
    if not _hooks_quiet():
        _REGISTRY.gauge(
            "engine_incremental_deferred_residue_buckets",
            "Collectives the last incremental finalize still paid (cadence tails + non-incremental residue).",
        ).set(float(box["count"]))
    return {name: out[name] for name in state}


def _advanced(carry: IncrementalCarry, group: Group) -> Tuple[bool, int, int]:
    """Whether advancing ``carry`` emits, and its next ``(pending,
    emissions)``: the host bookkeeping of :func:`advance_incremental`."""
    k = carry.sync_every
    pending = carry.pending + 1
    if group is None or not carry.acc:
        return False, min(pending, k), carry.emissions
    if pending < k:
        return False, pending, carry.emissions
    emission = carry.emissions + 1
    return True, 0, emission if carry.track_emissions else min(emission, 1)


def advance_incremental(
    carry: IncrementalCarry,
    new_state: Dict[str, Any],
    reductions: Dict[str, Reduction],
    group: Group = None,
    *,
    modes: Optional[Dict[str, str]] = None,
    transports: Optional[Dict[str, str]] = None,
    tolerances: Optional[Dict[str, float]] = None,
    shard_axes: Optional[Dict[str, ShardAxis]] = None,
) -> IncrementalCarry:
    """Fold one post-update state into the carry, emitting on cadence.
    ``group=None`` never emits: the carry tracks the live state and finalize
    is the deferred sync (``pending`` saturates at ``sync_every``)."""
    emits, pending, emissions = _advanced(carry, group)
    acc, last = carry.acc, carry.last
    if emits:
        acc, last = emit_incremental(
            new_state, carry.acc, carry.last, reductions, group, modes=modes, transports=transports,
            tolerances=tolerances, emission=carry.emissions + 1, shard_axes=shard_axes,
        )
    return IncrementalCarry(new_state, acc, last, carry.sync_every, pending, emissions, carry.track_emissions)


def emission_transports(
    carry: IncrementalCarry,
    reductions: Dict[str, Reduction],
    world: int,
    *,
    modes: Optional[Dict[str, str]] = None,
    transports: Optional[Dict[str, str]] = None,
    tolerances: Optional[Dict[str, float]] = None,
    shard_axes: Optional[Dict[str, ShardAxis]] = None,
) -> Tuple[Tuple[Tuple[str, ...], str], ...]:
    """The gate's decision for each fold bucket at the carry's next
    emission (its names and final transport): what a captured emission
    bakes in besides the state's shapes. Empty when no covered leaf is
    quantized, since then nothing compounds."""
    if not carry.track_emissions:
        return ()
    fold, _, _, eff_transports, eff_tolerances = _emission_entries(
        carry.state, carry.last, reductions, modes, transports, tolerances, shard_axes
    )
    plan = transport_plan({n: x for n, x, _ in fold}, {n: "sum" for n, _, _ in fold}, world,
                          eff_transports, eff_tolerances, error_scale=float(carry.emissions + 1))
    return tuple((tuple(p["names"]), p["transport"]) for p in plan)


def finalize_incremental_state(
    carry: IncrementalCarry,
    reductions: Dict[str, Reduction],
    group: Group,
    *,
    modes: Optional[Dict[str, str]] = None,
    transports: Optional[Dict[str, str]] = None,
    tolerances: Optional[Dict[str, float]] = None,
    bucketed: Optional[bool] = None,
    shard_axes: Optional[Dict[str, ShardAxis]] = None,
    keep_sharded: bool = False,
) -> Dict[str, Any]:
    """Carry-level wrapper over :func:`finalize_incremental`."""
    return finalize_incremental(
        carry.state, carry.acc, carry.last, reductions, group, pending=carry.pending, synced=carry.synced,
        modes=modes, transports=transports, tolerances=tolerances, bucketed=bucketed,
        emission=carry.emissions + 1, shard_axes=shard_axes, keep_sharded=keep_sharded,
    )


# --------------------------------------------------------------------------- #
# stacked (tenancy) incremental sync: the tenant axis folds into the buckets
# --------------------------------------------------------------------------- #
def _stacked_flat(
    states: Dict[str, Dict[str, Any]],
    reductions: Dict[str, Dict[str, Reduction]],
    transports: Optional[Dict[str, Dict[str, str]]],
    tolerances: Optional[Dict[str, Dict[str, float]]],
) -> Tuple[Dict[str, Any], Dict[str, Reduction], Dict[str, str], Dict[str, float]]:
    """A ``{leader: {state: leaf}}`` stacked tree in the ``\x1f``-joined flat
    namespace of :func:`sync_stacked_states`, under the same elementwise-only
    contract."""
    flat_state: Dict[str, Any] = {}
    flat_reds: Dict[str, Reduction] = {}
    flat_transports: Dict[str, str] = {}
    flat_tolerances: Dict[str, float] = {}
    for lname, st in states.items():
        reds = reductions[lname]
        for name, leaf in st.items():
            red = reds.get(name)
            if red not in _ELEMENTWISE and not (red == "sketch" and is_sketch(leaf)):
                raise ValueError(
                    f"incremental stacked sync: state {lname!r}.{name!r} has non-elementwise reduction {red!r}"
                    " (classify_tenant_member should have demoted this group)."
                )
            key = f"{lname}\x1f{name}"
            flat_state[key] = leaf
            flat_reds[key] = red
            if name in ((transports or {}).get(lname) or {}):
                flat_transports[key] = transports[lname][name]
            if name in ((tolerances or {}).get(lname) or {}):
                flat_tolerances[key] = tolerances[lname][name]
    return flat_state, flat_reds, flat_transports, flat_tolerances


def _flat_config(per_leader: Optional[Dict[str, Dict[str, Any]]]) -> Dict[str, Any]:
    return {f"{lname}\x1f{name}": v for lname, per in (per_leader or {}).items() for name, v in (per or {}).items()}


def _stacked_nest(flat: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    out: Dict[str, Dict[str, Any]] = {}
    for key, leaf in flat.items():
        lname, name = key.split("\x1f", 1)
        out.setdefault(lname, {})[name] = leaf
    return out


def init_incremental_stacked(
    states: Dict[str, Dict[str, Any]],
    reductions: Dict[str, Dict[str, Reduction]],
    *,
    sync_every: Optional[int] = None,
    transports: Optional[Dict[str, Dict[str, str]]] = None,
    tolerances: Optional[Dict[str, Dict[str, float]]] = None,
) -> IncrementalCarry:
    """Incremental carry over a tenant-stacked state tree. Every stacked leaf
    is elementwise by contract, so all are covered; the tenant axis folds
    into the flat buckets as in :func:`sync_stacked_states`, so the
    collective count of an emission does not grow with N or the leaders.
    The carry holds the flat (``\x1f``-keyed) view;
    :func:`finalize_incremental_stacked` nests it again."""
    flat_state, flat_reds, flat_t, _ = _stacked_flat(states, reductions, transports, tolerances)
    return init_incremental(flat_state, flat_reds, modes={k: "incremental" for k in flat_state},
                            sync_every=sync_every, transports=flat_t)


def advance_incremental_stacked(
    carry: IncrementalCarry,
    states: Dict[str, Dict[str, Any]],
    reductions: Dict[str, Dict[str, Reduction]],
    group: Group,
    *,
    transports: Optional[Dict[str, Dict[str, str]]] = None,
    tolerances: Optional[Dict[str, Dict[str, float]]] = None,
) -> IncrementalCarry:
    """Stacked counterpart of :func:`advance_incremental`."""
    flat_state, flat_reds, flat_t, flat_tol = _stacked_flat(states, reductions, transports, tolerances)
    return advance_incremental(carry, flat_state, flat_reds, group, modes={k: "incremental" for k in flat_state},
                               transports=flat_t, tolerances=flat_tol)


def finalize_incremental_stacked(
    carry: IncrementalCarry,
    reductions: Dict[str, Dict[str, Reduction]],
    group: Group,
    *,
    transports: Optional[Dict[str, Dict[str, str]]] = None,
    tolerances: Optional[Dict[str, Dict[str, float]]] = None,
) -> Dict[str, Dict[str, Any]]:
    """Stacked counterpart of :func:`finalize_incremental_state`: the nested
    ``{leader: {state: leaf}}`` synced tree."""
    flat = finalize_incremental_state(
        carry, _flat_config(reductions), group, modes={k: "incremental" for k in carry.state},
        transports=_flat_config(transports), tolerances=_flat_config(tolerances),
    )
    return _stacked_nest(flat)
