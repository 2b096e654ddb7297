"""The compiled update and compute engines: CUDA-graph capture for the facade.

Counterpart of ``metrics_tpu/core/engine.py``. There, ``Metric.update()``,
``Metric.compute()`` and their collection twins run every steady-state call
as one cached ``jax.jit`` executable per input signature. Here the cached
unit is a :class:`CapturedStep`: engine-owned static buffers and, on the
card, a ``torch.cuda.CUDAGraph`` captured over them.

The dispatch follows the JAX engine call for call:

- **The first call of each signature runs eager** (warmup). The value checks
  fire on it, once per input shape.
- **The second call probes the step and captures it.** The functional step
  ``state -> update_state(state, *args)`` runs once under a
  ``TorchDispatchMode`` that raises :class:`Uncapturable` on every operation a
  stream capture refuses: a read of a value to the host
  (``aten._local_scalar_dense``, which ``bool()``, ``.item()`` and ``int()``
  reach; ``tolist``, ``numpy`` and copies to the host; on CUDA,
  ``torch.linalg.eigh``, which reads cusolver's status inside its kernel, and
  ``torch.linalg.solve_ex``, whose batched LU solve a capture refuses) and
  operations whose output shape depends on values (``nonzero``, ``unique``,
  ``masked_select``, indexing with a bool tensor). A probe that raises
  leaves the state as it was and reverts the metric, or the collection
  member, to eager for good, with the reason recorded. A probe that passes
  commits its result: that is the call's update. On the card the step is
  then captured into a graph on
  the engine's capture stream (the probe ran there too, so what a kernel
  wrapper keeps per stream, such as B1's large-T workspace, exists before the
  capture starts). Capture executes nothing.
- **Every later call replays**: the inputs are copied into the static input
  buffers, then ``graph.replay()``. On the CPU there is no graph: the same
  step runs with the value checks off and writes into the same engine-owned
  static buffers.

The value checks are off (``utils.checks._capturing``) in the probe, the
capture and the steady state, where the JAX package skips them under a
trace.

**In-place state plays the role of donation.** An update step reads and
writes its static state buffers; the metric's state attributes then *are*
those buffers, and the next call updates them in place. The JAX engine's
alias guard decides when that is allowed: not when a state tensor is a
registered default (here: a copy ``reset()`` handed out), is shared across
a collection compute group, or is held anywhere else (a caller's reference, a
``get_state()`` snapshot). Such a call counts as not donated; its result is
handed out as fresh tensors, and static buffers that someone still holds are
restored after the replay, so every held tensor keeps its value. The static
buffers, and the static outputs of compute steps, are allocated outside the
graphs' memory pool, so the graphs of one engine share one pool and may
replay in any order (a ragged batch's pow2 chunks replay 512, 256, 64, 16
after a 1,024-row batch was captured first).

**Launch counts stay honest.** A kernel wrapper counts a launch when it
launches; a capture launches nothing, and a replay launches what the capture
recorded. So :class:`CapturedStep` records the capturing thread's launches
apart from the counts (``ops.kernels.recording_launches``) and adds them at
every replay.

**Threads.** A serving replica's dispatcher thread, the HTTP handlers and
the caller may all drive engines on one card at once. What a probe or a
capture changes is the calling thread's own: the dispatch mode, the checks
switch, the refusal of ``tolist``/``numpy`` (the methods refuse in a probing
thread and work in every other), the side stream (one a thread and device),
the launch record and the capture's error mode (``thread_local``). What is
the process's is held under locks: every probe and capture on the card runs
under one lock, so two threads never capture at once, and the garbage
collector stays off while any capture runs (a counted hold).

**Buffer states** (``core/buffers.py``) are three leaves each: the data, the
0-d ``count`` and the 0-d ``overflowed``. A captured append cannot grow the
buffer; it writes at the count clamped into the capacity, read from device
memory. In a graph's body the buffers are the step's own statics and are
appended to in place (``buffers.writes_in_place``), so a replay writes the
batch's rows and nothing else of the buffer. The host mirror of each count
and overflow flag gets the step's row count added at every call, as the
launch counts do: nothing is read back.

**Collectives inside a step.** A compute that syncs (``compute()`` under
:func:`~metrics_tpu_torch.parallel.sync_axes`, or in a multi-rank default
group) is captured as ``sync_states`` then ``compute_state``, keyed by its
group besides the state signature: the bucketed ``all_reduce``s replay inside
the graph. A sync that would read a value back to the host (a ``CatBuffer``'s
fill counts, a ragged gather's shapes, sparse_count's nonzero count:
``parallel.sync.sync_host_read``) is refused before any collective runs, so
every rank refuses alike, and the member stays eager with that reason. A
capture that NCCL refuses is refused the same way. The collectives count
(``parallel.count_collectives``) at the probe, which also fills the
``EngineStats`` collective fields as the JAX engine fills them at trace time,
and again at every replay. :class:`CompiledIncrementalStep` captures the
incremental protocol's ``update_state_incremental``: one graph per input
signature that emits and one that does not, the cadence kept on the host.
NCCL has run its first collective on the group before any capture, at the
eager first call.

**Sharded state.** A placed metric's update step (``Metric.shard_state``)
runs the metric's update on a whole-size identity delta and merges it into
the rank's blocks with one ``reduce_scatter`` per bucket: the step captures
the delta's fill, the update, the collective and the add, and replays them
like any other collective. A placed compute captures the sharded-compute
protocol. A sample-sharded buffer's update exchanges the ranks' row counts
through the host, so the update engine declines it before any collective,
on every rank alike, with the reason in ``fallback_reasons``; the
collection dispatcher classifies such a leader eager for the same reason.

**Errors.** Only :class:`Uncapturable`, the errors torch raises for an
operation a capture refuses, and an injected
:class:`~metrics_tpu_torch.resilience.chaos.ChaosError` revert a member: the
fault takes the real fallback path, and in a collection the migration and
probation path. A kernel build or launch error propagates, as it does
eagerly.

**Observability.** Every engine registers with the instrument registry
(``metrics_tpu_engine_*{kind,owner}``) and every dispatcher with its
partition bridge. While the tracer is on, the dispatch records
``dispatch/eager`` (warmup), ``dispatch/compile`` (the probe and capture,
with the probe's collective tallies), ``dispatch/cached`` (a replay) and
``dispatch/fallback``, and, while a ``torch.profiler`` session records,
runs the probe and each replay under a ``torch.profiler.record_function``
named ``metrics_tpu/<Owner>.<kind>`` (``observability.shards.dispatch_annotation``);
the fused streak records ``streak/detach``, the dispatcher
``partition/build``, ``partition/rebuild``, ``partition/migrate`` and
``partition/repromote``. The chaos sites ``engine/compile`` and
``engine/dispatch`` fire before the probe or the replay touches anything, so
the eager rerun of the call is bit for bit. Off, each hook is one flag check
and reads nothing from the card.

**Tenancy.** :func:`classify_tenant_member` decides which members a
:class:`~metrics_tpu_torch.tenancy.TenantSet` stacks on a leading tenant
axis (``PATH_TENANT``), with the JAX engine's rules and reasons; a
dispatcher built with ``tenant_context`` carries that class in its
partition and grows a ``tenant`` section in its view. The TenantSet owns
the stacked state and its captured steps (one ``torch.func.vmap`` of the
members' pure protocol per bucket width, a :class:`CapturedStep` each).

**Self-tuning sync** (:mod:`metrics_tpu_torch.autotune`). A decision of
the tuner moves its epoch (:func:`_autotune_token`, a constant while tuning
is off), which joins the dispatcher's partition key, a metric's key of a
synced compute and the incremental step's key of an emitting call,
as the JAX dispatcher keys on it: a decision rebuilds at the next call, and
a committed tuner or a pinned plan adds no rebuild or capture. A probe
records the transports (and cadence) the tuner gave its syncs
(``parallel.sync.recording_tuned``) and every later run of the captured body
replays them (``replaying_tuned``): the probe's own observation may move the
tuner, and the graph must sync as the probe did. The controller's lock is the
only state this adds that threads share.

Global switches: ``set_compiled_update``, ``set_compiled_compute`` and
``set_fused_update`` (environment variables ``METRICS_TPU_COMPILED_UPDATE``,
``METRICS_TPU_COMPILED_COMPUTE`` and ``METRICS_TPU_FUSED_UPDATE``, on unless
set to ``0``); per instance ``compiled_update=`` / ``compiled_compute=`` /
``fused_update=`` take precedence in both directions.
"""
from __future__ import annotations

import contextlib
import gc
import inspect
import os
import sys
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import Tensor
from torch.utils._python_dispatch import TorchDispatchMode

from metrics_tpu_torch.core.buffers import CatBuffer, ShardedCatBuffer, buffers_in, writes_in_place
from metrics_tpu_torch.observability import instruments as _instruments
from metrics_tpu_torch.observability import tracer as _otrace
from metrics_tpu_torch.observability.shards import dispatch_annotation as _dispatch_annotation
from metrics_tpu_torch.ops import kernels as _kernels
from metrics_tpu_torch.parallel import sync as _sync
from metrics_tpu_torch.resilience import chaos as _chaos
from metrics_tpu_torch.resilience import guard as _guard
from metrics_tpu_torch.utils.checks import _capturing, _checks_off
from metrics_tpu_torch.utils.exceptions import Uncapturable
from metrics_tpu_torch.utils.prints import rank_zero_warn

# number of eager sightings of a signature before compiling it
_WARMUP_CALLS = 1

_ENV_FLAG = "METRICS_TPU_COMPILED_UPDATE"
_ENV_FLAG_COMPUTE = "METRICS_TPU_COMPILED_COMPUTE"
_ENV_FLAG_FUSED = "METRICS_TPU_FUSED_UPDATE"

_SCALAR_TYPES = (int, float, bool, complex)


def _autotune_token() -> int:
    """The self-tuning sync decision epoch (a constant while tuning is off).
    A lazy import: the autotune package sits above ``parallel``, which this
    module imports too."""
    from metrics_tpu_torch.autotune import controller as _at

    return _at.partition_token()


def _env_default(flag: str = _ENV_FLAG) -> bool:
    return os.environ.get(flag, "1").lower() not in ("0", "false", "off")


_global_enabled: Optional[bool] = None  # None = follow the environment
_global_compute_enabled: Optional[bool] = None
_global_fused_enabled: Optional[bool] = None


def compiled_update_enabled() -> bool:
    """Whether the compiled-update engine is globally enabled."""
    return _env_default() if _global_enabled is None else _global_enabled


def set_compiled_update(enabled: Optional[bool]) -> None:
    """Globally enable/disable the compiled-update engine. ``None`` restores
    the environment default (``METRICS_TPU_COMPILED_UPDATE``, on unless set to
    ``0``). Per-instance ``compiled_update=`` flags take precedence."""
    global _global_enabled
    _global_enabled = enabled


def compiled_compute_enabled() -> bool:
    """Whether the compiled-compute engine is globally enabled."""
    return _env_default(_ENV_FLAG_COMPUTE) if _global_compute_enabled is None else _global_compute_enabled


def set_compiled_compute(enabled: Optional[bool]) -> None:
    """Globally enable/disable the compiled-compute engine (``None``: the
    environment default, ``METRICS_TPU_COMPILED_COMPUTE``)."""
    global _global_compute_enabled
    _global_compute_enabled = enabled


def fused_update_enabled() -> bool:
    """Whether the fused collection-update engine is globally enabled."""
    return _env_default(_ENV_FLAG_FUSED) if _global_fused_enabled is None else _global_fused_enabled


def set_fused_update(enabled: Optional[bool]) -> None:
    """Globally enable/disable the fused collection-update engine, the one
    captured step a ``MetricCollection.update()`` dispatches through. ``False``
    reverts collections to the eager per-group loop (members' own engines
    still apply). ``None`` restores the environment default
    (``METRICS_TPU_FUSED_UPDATE``)."""
    global _global_fused_enabled
    _global_fused_enabled = enabled


_ENV_PROBATION = "METRICS_TPU_PROBATION_COOLDOWN"
_DEFAULT_PROBATION_COOLDOWN = 25
# failed re-probe trials before a migration becomes permanent
_MAX_PROBATION_TRIALS = 6

_global_probation: Optional[int] = None


def probation_cooldown() -> int:
    """Dispatches a migrated member waits before its first re-probe trial
    (``0``: migrations are permanent). Each failed trial doubles the wait."""
    if _global_probation is not None:
        return _global_probation
    try:
        return max(int(os.environ.get(_ENV_PROBATION, _DEFAULT_PROBATION_COOLDOWN)), 0)
    except ValueError:
        return _DEFAULT_PROBATION_COOLDOWN


def set_probation(cooldown: Optional[int]) -> None:
    """Set the probation cooldown; ``None`` restores the environment default
    (``METRICS_TPU_PROBATION_COOLDOWN``, 25)."""
    global _global_probation
    _global_probation = None if cooldown is None else max(int(cooldown), 0)


@dataclass
class EngineStats:
    """Dispatch counters for one engine (all monotonically increasing)."""

    eager_calls: int = 0  # warmup / fallback executions of the raw update
    cache_misses: int = 0  # first compiled call per signature (probe + capture)
    cache_hits: int = 0  # steady-state compiled calls (replays)
    donated_calls: int = 0  # compiled calls that updated the state in place
    bucketed_calls: int = 0  # updates routed through the shape-bucketing layer
    key_fast_hits: int = 0  # dispatch keys served from the id-keyed memo
    # the collectives of each probed step (counted once per signature, as the
    # JAX engine counts them at trace time)
    collective_counts: Dict[str, int] = field(default_factory=dict)
    collective_bytes: Dict[str, int] = field(default_factory=dict)
    collective_bytes_by_transport: Dict[str, Dict[str, int]] = field(default_factory=dict)
    transport_refusals: int = 0
    # owner class name -> why the engine reverted it to eager for good
    fallback_reasons: Dict[str, str] = field(default_factory=dict)
    # wall time of the probe-and-capture calls
    compile_seconds: float = 0.0
    last_fallback_step: Optional[int] = None
    last_fallback_exception: Optional[str] = None

    @property
    def compiled_calls(self) -> int:
        return self.cache_misses + self.cache_hits


# --------------------------------------------------------------------------- #
# trees: the dispatch walks the inputs and the state every call, so it keeps
# its own small flattener for dicts, lists, tuples, named tuples and buffers
# (leaves are anything else); the spec is a hashable nested tuple. A buffer
# is three leaves (data, count, overflowed); its host mirrors are not part
# of the spec, and a buffer built from leaves has them zero until the
# dispatch carries them over (_carry_mirrors). A sketch is its components in
# field order, with its class and static config in the spec (the JAX
# package's pytree node), so an insert is captured and replayed in place
# --------------------------------------------------------------------------- #
def _flatten_into(tree: Any, leaves: list) -> Any:
    kind = type(tree)
    if kind is CatBuffer:
        leaves.extend((tree.data, tree.count, tree.overflowed))
        return ("c", tree._capacity)
    if kind is ShardedCatBuffer:
        leaves.extend((tree.data, tree.count, tree.overflowed))
        return ("C", tree._capacity, tree.index, tree.width)
    if kind is dict:
        return ("d", tuple(tree), tuple(_flatten_into(v, leaves) for v in tree.values()))
    if kind is list:
        return ("l", tuple(_flatten_into(v, leaves) for v in tree))
    if kind is tuple:
        return ("t", tuple(_flatten_into(v, leaves) for v in tree))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return ("n", kind, tuple(_flatten_into(v, leaves) for v in tree))
    if getattr(kind, "_is_mergeable_sketch", False) is True:
        leaves.extend(getattr(tree, f) for f, _ in kind.sketch_fields)
        return ("s", kind, tree.config())
    if kind is _sync.IncrementalCarry:
        return ("i", (tree.sync_every, tree.pending, tree.emissions, tree.track_emissions),
                tuple(_flatten_into(part, leaves) for part in (tree.state, tree.acc, tree.last)))
    leaves.append(tree)
    return None


def tree_flatten(tree: Any) -> Tuple[list, Any]:
    leaves: list = []
    return leaves, _flatten_into(tree, leaves)


def tree_leaves(tree: Any) -> list:
    leaves: list = []
    _flatten_into(tree, leaves)
    return leaves


def _build(node: Any, it: Any) -> Any:
    if node is None:
        return next(it)
    if node[0] == "d":
        return {k: _build(c, it) for k, c in zip(node[1], node[2])}
    if node[0] == "l":
        return [_build(c, it) for c in node[1]]
    if node[0] == "t":
        return tuple(_build(c, it) for c in node[1])
    if node[0] == "c":
        return CatBuffer._from_parts(next(it), next(it), next(it), capacity=node[1])
    if node[0] == "C":
        return ShardedCatBuffer.block(next(it), next(it), next(it), 0, False, node[2], node[3], node[1])
    if node[0] == "s":
        return node[1]._from_parts(node[2], [next(it) for _ in node[1].sketch_fields])
    if node[0] == "i":
        return _sync.IncrementalCarry(*(_build(c, it) for c in node[2]), *node[1])
    return node[1](*(_build(c, it) for c in node[2]))


def tree_unflatten(leaves: list, spec: Any) -> Any:
    # no closure: a recursive inner function would form a cycle that keeps
    # the leaves alive until the next garbage collection
    return _build(spec, iter(leaves))


def _carry_mirrors(before: Any, after: Any, rows: Tuple[int, ...]) -> None:
    """Set the host mirrors of the buffers in ``after`` (a step's result)
    from those in ``before`` (its input) and the step's row count per buffer:
    what its captured appends did to ``count`` and ``overflowed``."""
    for a, b, n in zip(buffers_in(before), buffers_in(after), rows):
        b._n = a._n + n
        b._over = a._over or b._n > b.capacity


def _sketches_in(tree: Any) -> list:
    """The sketches among a state tree's values (a state dict's, or each
    member's of a collection's ``{leader: state}``)."""
    out = []
    for value in tree.values() if isinstance(tree, dict) else ():
        if getattr(value, "_is_mergeable_sketch", False) is True:
            out.append(value)
        elif isinstance(value, dict):
            out.extend(_sketches_in(value))
    return out


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _pow2_chunks(n: int) -> Tuple[int, ...]:
    """Binary decomposition of ``n`` into descending powers of two."""
    out = []
    bit = 1 << max(n.bit_length() - 1, 0)
    while bit:
        if n & bit:
            out.append(bit)
        bit >>= 1
    return tuple(out)


# python leaves keyed by VALUE: a graph bakes them in as constants, so unlike
# the JAX engine (which records only their type) their value is part of the
# signature
_INTERNABLE_TYPES = _SCALAR_TYPES + (str, bytes, type(None))


def _leaf_signature(leaf: Any) -> Any:
    if isinstance(leaf, Tensor):
        return (tuple(leaf.shape), leaf.dtype, leaf.device, leaf.stride())
    if isinstance(leaf, _INTERNABLE_TYPES):
        return (type(leaf), leaf)
    return type(leaf)


def _signature_flat(leaves: list, treedef: Any) -> Tuple:
    return treedef, tuple(_leaf_signature(leaf) for leaf in leaves)


class _SigCache:
    """Single-entry identity-keyed memo of a tree's signature.

    When the incoming tree is built from the very same leaf objects as last
    time (the state an update just produced; repeated inputs), the signature
    cannot have changed, so a key-tuple comparison replaces the per-leaf walk.
    Tensor leaves are keyed by ``id()`` and pinned by weak references (the memo
    answers only while every original leaf is alive); python scalars are
    keyed by value.
    """

    __slots__ = ("_keys", "_treedef", "_refs", "_sig")

    def __init__(self) -> None:
        self._keys: Optional[Tuple] = None
        self._treedef = None
        self._refs: Tuple = ()
        self._sig: Optional[Tuple] = None

    @staticmethod
    def _leaf_keys(leaves: list) -> Tuple:
        return tuple((type(leaf), leaf) if isinstance(leaf, _INTERNABLE_TYPES) else id(leaf) for leaf in leaves)

    def signature(self, tree: Any, stats: Optional[EngineStats] = None,
                  verify: Optional[Callable[[list], bool]] = None) -> Tuple[Optional[Tuple], list]:
        """The tree's signature (None when ``verify`` rejects its leaves;
        ``verify`` runs only on a memo miss) and its leaves."""
        leaves, treedef = tree_flatten(tree)
        keys = self._leaf_keys(leaves)
        if keys == self._keys and treedef == self._treedef and all(ref() is not None for ref in self._refs):
            if stats is not None:
                stats.key_fast_hits += 1
            return self._sig, leaves
        if verify is not None and not verify(leaves):
            return None, leaves
        sig = _signature_flat(leaves, treedef)
        self._store(leaves, treedef, keys, sig)
        return sig, leaves

    def seed(self, leaves: list, treedef: Any, sig: Tuple) -> None:
        """Pre-warm the memo with a tree about to be seen again."""
        self._store(leaves, treedef, self._leaf_keys(leaves), sig)

    def _store(self, leaves: list, treedef: Any, keys: Tuple, sig: Tuple) -> None:
        try:
            self._refs = tuple(weakref.ref(leaf) for leaf, key in zip(leaves, keys) if isinstance(key, int))
        except TypeError:  # a leaf that cannot be weakly referenced: stay un-memoized
            self._keys = None
            return
        self._keys, self._treedef, self._sig = keys, treedef, sig


def _flat_leaves_compilable(leaves: list) -> bool:
    """True when every leaf is a tensor that needs no gradient, or a python
    scalar or None."""
    for leaf in leaves:
        if isinstance(leaf, Tensor):
            if leaf.requires_grad:
                return False
        elif not isinstance(leaf, _SCALAR_TYPES + (type(None),)):
            return False
    return True


def _leaves_compilable(tree: Any) -> bool:
    return _flat_leaves_compilable(tree_leaves(tree))


def _protected_leaf_ids(*metrics: Any, include_shared: bool = True) -> set:
    """ids of state tensors the caller can still reach after this update: the
    copies ``reset()`` handed out (the JAX package's reset hands out the
    registered defaults themselves, which its engine never donates) and state
    shared across a collection compute group."""
    protected: set = set()
    for m in metrics:
        protected.update(m._reset_leaf_ids())
        if include_shared:
            protected.update(getattr(m, "_shared_state_ids", ()))
    return protected


# References to a state tensor that nobody else holds, at the guard below:
# the metric's attribute, the get_state() dict, the flattened leaves list,
# the loop variable and getrefcount's own argument (the same five as the JAX
# engine's _DONATION_MAX_REFS); an engine-owned static buffer has one more,
# the engine's own list.
_DONATION_MAX_REFS = 5


# --------------------------------------------------------------------------- #
# the probe
# --------------------------------------------------------------------------- #
_aten = torch.ops.aten
_HOST_READS = frozenset({_aten._local_scalar_dense})
_VALUE_SHAPED = frozenset({
    _aten.nonzero, _aten.nonzero_numpy, _aten.argwhere, _aten.masked_select,
    _aten._unique, _aten._unique2, _aten.unique_dim, _aten.unique_consecutive, _aten.unique_dim_consecutive,
})
_INDEXING = frozenset({_aten.index, _aten.index_put, _aten.index_put_, _aten._index_put_impl_})
_COPIES = frozenset({_aten._to_copy, _aten.copy_})
# operations that a capture on CUDA refuses below the dispatch mode (the probe
# sees no `_local_scalar_dense`): torch.linalg.eigh checks cusolver's `info`,
# and a capture of one fails and leaves the solver's handle unusable; a
# capture of torch.linalg.solve_ex's batched LU solve (SDR's, 16 systems of
# 512 x 512) failed on the H100 with "operation failed due to a previous
# error during capture". The probe refuses them on CUDA; on the CPU they
# capture (FID's compute and SDR's update, as the JAX engine compiles them)
_DEVICE_CHECKED = {
    _aten._linalg_eigh: "reads its solver's status back to the host on CUDA",
    _aten._linalg_solve_ex: "cannot be captured on CUDA (a capture of its batched LU solve fails)",
}


def _is_bool_index(index: Any) -> bool:
    return isinstance(index, Tensor) and index.dtype in (torch.bool, torch.uint8)


class _ProbeMode(TorchDispatchMode):
    """Raise :class:`Uncapturable` on every operation a stream capture refuses."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if packet in _HOST_READS:
            raise Uncapturable(f"{func} reads a value back to the host")
        if packet in _DEVICE_CHECKED and any(isinstance(a, Tensor) and a.is_cuda for a in args):
            raise Uncapturable(f"{func} {_DEVICE_CHECKED[packet]}")
        if packet in _VALUE_SHAPED:
            raise Uncapturable(f"{func} makes a tensor whose shape depends on values")
        if packet is _aten.repeat_interleave and kwargs.get("output_size") is None:
            raise Uncapturable(f"{func} without output_size makes a tensor whose shape depends on values")
        if packet in _INDEXING and len(args) > 1 and any(_is_bool_index(i) for i in args[1] or ()):
            raise Uncapturable(f"{func} with a bool index makes a tensor whose shape depends on values")
        if packet in _COPIES:
            src = args[1] if packet is _aten.copy_ else args[0]
            dst = args[0].device if packet is _aten.copy_ else kwargs.get("device")
            if isinstance(src, Tensor) and src.device.type != "cpu" and dst is not None and torch.device(dst).type == "cpu":
                raise Uncapturable(f"{func} copies a value back to the host")
        return func(*args, **kwargs)


# the probe refuses Tensor.tolist/numpy in the probing thread only: another
# thread (a second replica's reads, the caller's oracle) keeps its own
_PROBE_LOCAL = threading.local()
_PROBE_PATCH_LOCK = threading.Lock()
_probe_patches = 0  # probes in progress in any thread; the patch lives while > 0
_PATCHED_SAVED: Dict[str, Any] = {}


def _probing() -> bool:
    return getattr(_PROBE_LOCAL, "depth", 0) > 0


def _refusing(name: str, original: Callable) -> Callable:
    def method(self, *args: Any, **kwargs: Any) -> Any:
        if _probing():
            raise Uncapturable(f"Tensor.{name} reads a value back to the host")
        return original(self, *args, **kwargs)

    method.__name__ = name
    return method


class _probe:
    """The probe context: the dispatch mode, ``tolist``/``numpy`` refused
    (they reach no operator on the CPU), value checks off, no autograd.

    The dispatch mode, the checks switch and ``no_grad`` are the calling
    thread's own. ``tolist`` and ``numpy`` are methods of the one class:
    while any thread probes they are replaced by methods that refuse in a
    probing thread and call the saved ones in every other."""

    _PATCHED = ("tolist", "numpy")

    def __enter__(self) -> "_probe":
        global _probe_patches
        with _PROBE_PATCH_LOCK:
            if _probe_patches == 0:
                for name in self._PATCHED:
                    _PATCHED_SAVED[name] = torch.Tensor.__dict__.get(name)
                    setattr(torch.Tensor, name, _refusing(name, getattr(torch.Tensor, name)))
            _probe_patches += 1
        _PROBE_LOCAL.depth = getattr(_PROBE_LOCAL, "depth", 0) + 1
        self._ctx = [_checks_off(), torch.no_grad(), _ProbeMode()]
        for ctx in self._ctx:
            ctx.__enter__()
        return self

    def __exit__(self, *exc: Any) -> None:
        global _probe_patches
        for ctx in reversed(self._ctx):
            ctx.__exit__(*exc)
        _PROBE_LOCAL.depth -= 1
        with _PROBE_PATCH_LOCK:
            _probe_patches -= 1
            if _probe_patches == 0:
                for name, saved in _PATCHED_SAVED.items():
                    if saved is None:
                        delattr(torch.Tensor, name)
                    else:
                        setattr(torch.Tensor, name, saved)
                _PATCHED_SAVED.clear()


class _steady:
    """A steady-state step: value checks off, no autograd."""

    def __enter__(self) -> None:
        self._ctx = [_checks_off(), torch.no_grad()]
        for ctx in self._ctx:
            ctx.__enter__()

    def __exit__(self, *exc: Any) -> None:
        for ctx in reversed(self._ctx):
            ctx.__exit__(*exc)


# one lock for every probe and capture on the card, in every thread: two
# dispatcher threads never capture at once, so neither can spoil the other's
# capture, and the collector is held off while any capture runs
_CAPTURE_LOCK = threading.RLock()
_GC_LOCK = threading.Lock()
_gc_holds = 0
_gc_was_enabled = False
_STREAMS = threading.local()


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The side stream this thread probes and captures on, one per device. A
    graph keeps using what a kernel wrapper made per stream at its probe (B1's
    workspace), so two threads' graphs, which may replay at once, share none."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    streams = getattr(_STREAMS, "by_device", None)
    if streams is None:
        streams = _STREAMS.by_device = {}
    stream = streams.get(index)
    if stream is None:
        stream = streams[index] = torch.cuda.Stream(device=index)
    return stream


@contextlib.contextmanager
def _collector_held() -> Iterator[None]:
    """Python's garbage collector off for the body, counted across threads:
    it comes back on when the last hold ends, if it was on at the first."""
    global _gc_holds, _gc_was_enabled
    with _GC_LOCK:
        if _gc_holds == 0:
            _gc_was_enabled = gc.isenabled()
            gc.disable()
        _gc_holds += 1
    try:
        yield
    finally:
        with _GC_LOCK:
            _gc_holds -= 1
            if _gc_holds == 0 and _gc_was_enabled:
                gc.enable()


class CapturedStep:
    """One signature's compiled step.

    ``fn(state, args, kwargs) -> out`` is the functional step. An update step
    (``writes_state``) returns the next state, of the state's own shapes; a
    compute step returns the metric value. The step owns static buffers for
    the state leaves and the tensor leaves of the inputs (python leaves are
    part of the signature and baked in), and for a compute step one flat
    static output buffer per dtype (a binned AP returns a thousand 0-d
    tensors: one ``cat`` into it, one ``clone`` out of it); all of them are
    allocated outside the graph's memory pool. On the card :meth:`probe`
    captures ``graph``: read the statics, run ``fn``, copy the result into the
    static state (or output) buffers.

    ``launch_delta`` is each kernel's count recorded by the capture; it is
    taken back after the capture (which launches nothing) and added at every
    replay. ``buffer_rows`` is the row count an update step appends to each
    buffer of the state, which the dispatch adds to the buffers' host mirrors.
    """

    def __init__(self, fn: Callable, writes_state: bool, pool: Any = None) -> None:
        self.fn = fn
        self.writes_state = writes_state
        self.pool = pool
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.state_static: List[Tensor] = []
        self.arg_static: List[Optional[Tensor]] = []
        self.out_flat: Dict[torch.dtype, Tensor] = {}
        # runs of equal dtype and shape in the flat output buffers:
        # (dtype, shape, offset, count), handed out by one unbind each
        self._out_layout: List[Tuple[torch.dtype, torch.Size, int, int]] = []
        self.launch_delta: Dict[str, int] = {}
        # the probe's collectives, counted again at every replay
        self.collectives: Optional[Dict[str, Any]] = None
        # the tuner's answers to the probe's syncs, replayed by every later run
        self.tuned: List[Tuple[Tuple, Any]] = []
        self.buffer_rows: Tuple[int, ...] = ()
        self._state_spec = self._args_spec = self._out_spec = None
        self._consts: List[Any] = []

    # ------------------------------------------------------------------ #
    def probe(self, state: Any, args: Tuple, kwargs: Dict) -> Any:
        """The first compiled call: run ``fn`` once under the probe, make the
        statics, capture on the card. Returns ``fn``'s result, which is this
        call's update (fresh tensors, not the statics)."""
        state_leaves, self._state_spec = tree_flatten(state)
        arg_leaves, self._args_spec = tree_flatten((args, kwargs))
        self._consts = [None if isinstance(x, Tensor) else x for x in arg_leaves]
        device = next((x.device for x in state_leaves + arg_leaves if isinstance(x, Tensor)), torch.device("cpu"))
        if device.type != "cuda":
            with _probe(), _sync.count_collectives() as self.collectives, _sync.recording_tuned() as self.tuned:
                out = self.fn(state, args, kwargs)
            out_leaves = self._check_out(state, state_leaves, out)
            self._make_statics(state_leaves, arg_leaves, out_leaves)
            return out

        current = torch.cuda.current_stream(device)
        side = _capture_stream(device)
        with _CAPTURE_LOCK:
            side.wait_stream(current)
            try:
                with torch.cuda.stream(side):
                    # the probe runs where the capture will: per-stream resources
                    # a kernel wrapper makes on first use exist before the capture
                    with _probe(), _sync.count_collectives() as self.collectives, \
                            _sync.recording_tuned() as self.tuned:
                        out = self.fn(state, args, kwargs)
                    out_leaves = self._check_out(state, state_leaves, out)
                with torch.cuda.stream(current):
                    self._make_statics(state_leaves, arg_leaves, out_leaves)
                side.wait_stream(current)
                self._capture(side)
            finally:
                # every use of the side stream starts by waiting for the current
                # one, so the probe's results (made there) may be handed out
                current.wait_stream(side)
        return out

    def _check_out(self, state: Any, state_leaves: list, out: Any) -> list:
        out_leaves, self._out_spec = tree_flatten(out)
        for x in out_leaves:
            if not isinstance(x, Tensor):
                raise Uncapturable(f"the step returns a {type(x).__name__}, which a graph would freeze")
        if self.writes_state and [(x.shape, x.dtype) for x in out_leaves] != [
            (x.shape, x.dtype) for x in state_leaves
        ]:
            raise Uncapturable("the step changes the state's shapes or dtypes")
        if self.writes_state:
            self.buffer_rows = tuple(b._n - a._n for a, b in zip(buffers_in(state), buffers_in(out)))
        return out_leaves

    def _make_statics(self, state_leaves: list, arg_leaves: list, out_leaves: list) -> None:
        self.state_static = [torch.empty_like(x) for x in state_leaves]
        self.arg_static = [torch.empty_like(x) if isinstance(x, Tensor) else None for x in arg_leaves]
        if not self.writes_state:
            sizes: Dict[torch.dtype, int] = {}
            for x in out_leaves:
                run = self._out_layout[-1] if self._out_layout else None
                if run is not None and run[:2] == (x.dtype, x.shape) and run[2] + run[3] * x.numel() == sizes[x.dtype]:
                    self._out_layout[-1] = (*run[:3], run[3] + 1)
                else:
                    self._out_layout.append((x.dtype, x.shape, sizes.get(x.dtype, 0), 1))
                sizes[x.dtype] = sizes.get(x.dtype, 0) + x.numel()
            device = out_leaves[0].device if out_leaves else torch.device("cpu")
            self.out_flat = {dtype: torch.empty(n, dtype=dtype, device=device) for dtype, n in sizes.items()}

    def _static_inputs(self) -> Tuple[Any, Tuple, Dict]:
        state = tree_unflatten(self.state_static, self._state_spec)
        leaves = [s if s is not None else c for s, c in zip(self.arg_static, self._consts)]
        args, kwargs = tree_unflatten(leaves, self._args_spec)
        return state, args, kwargs

    def _body(self) -> None:
        with _sync.replaying_tuned(self.tuned):
            self._run_body()

    def _run_body(self) -> None:
        state, args, kwargs = self._static_inputs()
        if self.writes_state:
            with writes_in_place():
                out = tree_leaves(self.fn(state, args, kwargs))
            # a buffer appended to in place is its own result
            pairs = [(dst, src) for dst, src in zip(self.state_static, out) if dst is not src]
            if pairs:
                torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])
            return
        out = tree_leaves(self.fn(state, args, kwargs))
        i = 0
        for dtype, shape, offset, count in self._out_layout:
            run, i = out[i:i + count], i + count
            dst = self.out_flat[dtype][offset:offset + count * shape.numel()]
            src = _one_block(run, shape.numel())
            dst.copy_(src if src is not None else torch.cat([x.reshape(-1) for x in run]))

    def _capture(self, side: "torch.cuda.Stream") -> None:
        graph = torch.cuda.CUDAGraph()
        # no garbage collection inside the capture: a collection there can
        # free another engine's graph (engines and metrics form reference
        # cycles), whose destruction the capturing stream refuses, and the
        # capture fails ("operation not permitted when stream is capturing");
        # torch.cuda.graph no longer collects on entry. The capture's error
        # mode is this thread's: another thread's allocation or
        # synchronisation meanwhile neither fails it nor fails there. A
        # capture records launches, this thread's only; it makes none.
        try:
            with _collector_held(), _kernels.recording_launches() as launches:
                with _steady(), _sync._muted(), torch.cuda.graph(graph, pool=self.pool, stream=side,
                                                                 capture_error_mode="thread_local"):
                    self._body()
        except RuntimeError as err:
            first = str(err).splitlines()[0][:200] if str(err) else type(err).__name__
            if self.collectives and self.collectives["count"]:
                # NCCL's refusals do not all say "capture"
                raise Uncapturable(f"the CUDA graph capture of the step's collectives failed: {first}") from err
            if "captur" not in str(err).lower():
                raise
            raise Uncapturable(f"the CUDA graph capture refused the step: {first}") from err
        self.launch_delta = {k: n for k, n in launches.items() if n}
        self.graph = graph

    def replay(self) -> None:
        self.graph.replay()
        _kernels.add_launches(self.launch_delta)
        if self.collectives and self.collectives["count"]:
            _sync.replay_ticks(self.collectives)

    def _load_args(self, arg_leaves: list) -> None:
        for dst, src in zip(self.arg_static, arg_leaves):
            if dst is not None:
                dst.copy_(src)

    # ------------------------------------------------------------------ #
    def run_update(self, state: Any, leaves: list, args: Tuple, kwargs: Dict, arg_leaves: list,
                   donate: bool, free: List[bool]) -> Any:
        """A steady-state update (``leaves``, ``arg_leaves``: the state's and
        the inputs' leaves). ``donate``: the state may be consumed and the
        statics handed out as the new state; ``free[i]``: static buffer ``i``
        is held by nobody outside the engine, so it may be overwritten without
        a backup. Returns the new state tree."""
        hand_out_statics = donate and all(free)
        if self.graph is None:  # the CPU: run the step, no graph; quiet, as a replay
            with _steady(), _sync._quiet(), _sync.replaying_tuned(self.tuned):
                out = tree_leaves(self.fn(state, args, kwargs))
            if hand_out_statics:
                for dst, src in zip(self.state_static, out):
                    dst.copy_(src)
                out = self.state_static
            return tree_unflatten(list(out), self._state_spec)
        backups = [None if ok else s.clone() for s, ok in zip(self.state_static, free)]
        for s, x in zip(self.state_static, leaves):
            if s is not x:
                s.copy_(x)
        self._load_args(arg_leaves)
        self.replay()
        if hand_out_statics:
            out = self.state_static
        else:
            out = [s.clone() for s in self.state_static]
            for s, b in zip(self.state_static, backups):
                if b is not None:
                    s.copy_(b)  # a holder of this static keeps its value
        return tree_unflatten(list(out), self._state_spec)

    def run_compute(self, state: Any, leaves: list, args: Tuple = (), kwargs: Optional[Dict] = None) -> Any:
        """A steady-state compute; returns fresh tensors."""
        if self.graph is None:
            with _steady(), _sync._quiet(), _sync.replaying_tuned(self.tuned):
                return self.fn(state, args, kwargs or {})
        for s, x in zip(self.state_static, leaves):
            s.copy_(x)
        self.replay()
        return self._unpack_outputs()

    def _unpack_outputs(self) -> Any:
        """Fresh copies of the static outputs, in the step's output tree."""
        flat = {dtype: f.clone() for dtype, f in self.out_flat.items()}
        out: List[Tensor] = []
        for dtype, shape, offset, count in self._out_layout:
            out.extend(flat[dtype][offset:offset + count * shape.numel()].view(count, *shape).unbind(0))
        return tree_unflatten(out, self._out_spec)


def _one_block(run: List[Tensor], numel: int) -> Optional[Tensor]:
    """The run of outputs as one flat view when they lie back to back in one
    storage (``list(x)`` of a tensor, as a binned AP returns it), else None."""
    first = run[0]
    if not all(x.is_contiguous() for x in run):
        return None
    ptr, offset = first.untyped_storage().data_ptr(), first.storage_offset()
    for k, x in enumerate(run):
        if x.untyped_storage().data_ptr() != ptr or x.storage_offset() != offset + k * numel:
            return None
    return first.as_strided((len(run) * numel,), (1,), offset)


def _first_line(err: BaseException, limit: int = 200) -> str:
    msg = str(err).splitlines()[0][:limit] if str(err) else ""
    return f"{type(err).__name__}: {msg}" if msg else type(err).__name__


# --------------------------------------------------------------------------- #
# the dispatch machinery
# --------------------------------------------------------------------------- #
class _EngineBase:
    """Shared dispatch machinery; subclasses provide the step and bookkeeping."""

    _kind = "update"
    _target = "update_state"
    _opt_out = "compiled_update=False"
    _result_is_state = True

    def __init__(self, donate: bool) -> None:
        self.stats = EngineStats()
        self._seen: Dict[Any, int] = {}
        self._steps: Dict[Any, CapturedStep] = {}
        self._static_ids: set = set()  # ids of every step's static state buffers
        self._broken: Optional[str] = None
        self._donate = donate
        self._pool: Any = None
        self._args_sig = _SigCache()
        self._state_sig = _SigCache()
        self._out_sigs: Dict[Any, Tuple] = {}
        self._fast_lane: Optional[Tuple] = None
        # weakly tracked by the instrument registry: this engine's stats show
        # up in snapshots as metrics_tpu_engine_*{kind,owner}
        _instruments.register_engine(self)

    def __deepcopy__(self, memo: Dict) -> None:
        # clones and pickles rebuild their engine lazily: graphs bind device
        # addresses and the steps close over the original metric
        return None

    @property
    def broken(self) -> Optional[str]:
        """Why the engine fell back to eager for good (None = healthy)."""
        return self._broken

    def reset_signature_memos(self) -> None:
        """Drop the id-keyed memos after an out-of-band state replacement
        (``load_state_dict``); the captured steps stay cached."""
        self._args_sig = _SigCache()
        self._state_sig = _SigCache()
        self._fast_lane = None

    def _owner_name(self) -> str:
        owner = getattr(self, "metric", None) or getattr(self, "collection", None)
        return type(owner).__name__ if owner is not None else type(self).__name__

    def _step_fn(self) -> Callable:
        raise NotImplementedError

    def _bridge(self) -> Any:
        """The ``record_function`` a dispatch runs under while the tracer is
        on, so a ``torch.profiler`` trace of the same run correlates with the
        host spans (``observability.correlate_device_trace``). It is opened
        only while a profiler records: like the JAX package's
        ``TraceAnnotation`` without an active trace, it then costs nothing,
        where a ``record_function`` makes two dispatcher calls either way."""
        if not torch.autograd._profiler_enabled():
            return _NO_BRIDGE
        return torch.profiler.record_function(_dispatch_annotation(self._owner_name(), self._kind))

    def _new_step(self) -> CapturedStep:
        pool = None
        if torch.cuda.is_available() and self._on_cuda():
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            pool = self._pool
        return CapturedStep(self._step_fn(), writes_state=self._result_is_state, pool=pool)

    def _on_cuda(self) -> bool:
        return False

    def _statics_free(self, step: CapturedStep, leaves: list, donate_ok: bool) -> List[bool]:
        """Per static state buffer: may it be overwritten without a backup?
        A static that is a state leaf is free when the call may consume the
        state; any other is free when nobody outside the engine holds it."""
        free = []
        for static in step.state_static:
            if any(static is leaf for leaf in leaves):
                free.append(donate_ok)
            else:
                # the engine's list, the loop variable, getrefcount's argument
                free.append(sys.getrefcount(static) <= 3)
        return free

    def _dispatch(self, state: Any, args: Tuple, kwargs: Dict, protected: set,
                  verify_args: Optional[Callable[[list], bool]] = None) -> Tuple[bool, Any]:
        """Core cache dance. Returns ``(handled, result)``; ``handled=False``
        tells the caller to run eager."""
        args_sig, arg_leaves = self._args_sig.signature((args, kwargs), self.stats, verify_args)
        if args_sig is None:
            self.stats.eager_calls += 1
            return False, None
        state_sig, leaves = self._state_sig.signature(state, self.stats)
        fast = self._fast_lane
        if fast is not None and fast[0] is args_sig and fast[1] is state_sig:
            key = fast[2]
            count = _WARMUP_CALLS + 1
        else:
            key = (args_sig, state_sig)
            count = self._seen.get(key, 0)
            self._seen[key] = count + 1
            if count > _WARMUP_CALLS:
                self._fast_lane = (args_sig, state_sig, key)
        if count < _WARMUP_CALLS:
            self.stats.eager_calls += 1
            if _otrace.active:
                _otrace.emit_instant("dispatch/eager", "engine", owner=self._owner_name(), kind=self._kind)
            return False, None

        donate_ok = self._donate and count > _WARMUP_CALLS  # the first compiled call probes
        step = self._steps.get(key)
        if donate_ok:
            for leaf in leaves:
                extra = 1 if id(leaf) in self._static_ids else 0
                if id(leaf) in protected or (
                    isinstance(leaf, Tensor) and sys.getrefcount(leaf) > _DONATION_MAX_REFS + extra
                ):
                    donate_ok = False
                    break
        if donate_ok and self._result_is_state:
            # a buffer or sketch object held elsewhere (a get_state()
            # snapshot) holds its tensors too: the metric's attribute, the
            # state tree, this list, the loop variable and getrefcount's
            # argument are all
            buffers = buffers_in(state) + _sketches_in(state)
            for buf in buffers:
                if sys.getrefcount(buf) > _DONATION_MAX_REFS:
                    donate_ok = False
                    break
            del buffers
        try:
            if _chaos.active:
                # before the probe or the replay touches anything: the fault
                # takes the fallback (or migration) path a refused capture
                # takes, and the eager rerun of this call is bit for bit
                _chaos.maybe_fail("engine/compile" if count == _WARMUP_CALLS else "engine/dispatch",
                                  owner=self._owner_name(), kind=self._kind)
            if count == _WARMUP_CALLS or step is None:
                t0 = time.perf_counter()
                step = self._new_step()
                try:
                    with self._bridge() if _otrace.active else _NO_BRIDGE:
                        result = step.probe(state, args, kwargs)
                finally:
                    _add_collectives(self.stats, step.collectives)
                self._steps[key] = step
                self._static_ids.update(id(x) for x in step.state_static)
                compile_s = time.perf_counter() - t0
                self.stats.compile_seconds += compile_s
                if self._result_is_state and self._donate:
                    # the next call finds the statics as its state and
                    # updates them in place
                    for dst, src in zip(step.state_static, tree_leaves(result)):
                        dst.copy_(src)
                    result = tree_unflatten(list(step.state_static), step._state_spec)
                if _otrace.active:
                    box = step.collectives or _sync._new_box()
                    compile_us = int(compile_s * 1e6)
                    _otrace.emit_complete(
                        "dispatch/compile", "engine", _otrace._now_us() - compile_us, compile_us,
                        owner=self._owner_name(), kind=self._kind, compile_s=compile_s,
                        collectives=dict(box["by_kind"]), collective_bytes=dict(box["bytes_by_kind"]),
                        bytes_by_transport={k: dict(v) for k, v in box["bytes_by_transport"].items()},
                        transport_refusals=len(box["refusals"]),
                    )
            elif _otrace.active:
                t0_us = _otrace._now_us()
                with self._bridge():
                    result = self._run(step, state, leaves, args, kwargs, arg_leaves, donate_ok)
                _otrace.emit_complete("dispatch/cached", "engine", t0_us, _otrace._now_us() - t0_us,
                                      owner=self._owner_name(), kind=self._kind, donated=donate_ok)
            else:
                result = self._run(step, state, leaves, args, kwargs, arg_leaves, donate_ok)
        except (Uncapturable, _chaos.ChaosError) as err:
            self._broken = _first_line(err, 400)
            self.stats.fallback_reasons[self._owner_name()] = self._broken
            self.stats.last_fallback_step = self.stats.eager_calls + self.stats.compiled_calls + 1
            self.stats.last_fallback_exception = _first_line(err, 160)
            if _otrace.active:
                _otrace.emit_instant("dispatch/fallback", "engine", owner=self._owner_name(), kind=self._kind,
                                     reason=self._broken.splitlines()[0][:200], step=self.stats.last_fallback_step)
            rank_zero_warn(
                f"compiled-{self._kind} engine disabled for {self._owner_name()} ({type(self).__name__}) target: "
                f"{self._target} cannot be captured ({self._broken[:200]}). "
                f"Reverting to eager {self._kind}s; pass {self._opt_out} to silence.",
                UserWarning,
            )
            return False, None
        if count == _WARMUP_CALLS:
            self.stats.cache_misses += 1
        else:
            self.stats.cache_hits += 1
        if donate_ok:
            self.stats.donated_calls += 1
        if self._result_is_state:
            if step.buffer_rows:
                _carry_mirrors(state, result, step.buffer_rows)
            # the next call's state is this result: its signature is known
            out_leaves, out_spec = tree_flatten(result)
            out_sig = self._out_sigs.get(key)
            if out_sig is None:
                out_sig = self._out_sigs[key] = _signature_flat(out_leaves, out_spec)
            self._state_sig.seed(out_leaves, out_spec, out_sig)
        else:
            result = _fresh_outputs(result, leaves)
        return True, result

    def _run(self, step: CapturedStep, state: Any, leaves: list, args: Tuple, kwargs: Dict, arg_leaves: list,
             donate_ok: bool) -> Any:
        """A steady-state call of a captured step."""
        if self._result_is_state:
            free = self._statics_free(step, leaves, donate_ok)
            return step.run_update(state, leaves, args, kwargs, arg_leaves, donate_ok, free)
        return step.run_compute(state, leaves, args, kwargs)


_NO_BRIDGE = contextlib.nullcontext()


def _add_collectives(stats: EngineStats, box: Optional[Dict[str, Any]]) -> None:
    """Add a probe's collectives and refusals to ``stats``."""
    if not box:
        return
    for kind, n in box["by_kind"].items():
        stats.collective_counts[kind] = stats.collective_counts.get(kind, 0) + n
    for kind, n in box["bytes_by_kind"].items():
        stats.collective_bytes[kind] = stats.collective_bytes.get(kind, 0) + n
    for transport, split in box["bytes_by_transport"].items():
        per = stats.collective_bytes_by_transport.setdefault(transport, {"wire": 0, "logical": 0})
        per["wire"] += split["wire"]
        per["logical"] += split["logical"]
    stats.transport_refusals += len(box["refusals"])


def _fresh_outputs(result: Any, leaves: list) -> Any:
    """A compute's outputs that share storage with a state leaf, as copies.
    A compute that returns its state as it is (a confusion matrix, an
    aggregate) would otherwise hand out the engine's static, and a caller
    holding it would keep the next update from writing in place; a jit
    output is always a fresh buffer."""
    ptrs = {x.untyped_storage().data_ptr() for x in leaves if isinstance(x, Tensor) and x.numel()}
    flat, spec = tree_flatten(result)
    shared = [isinstance(x, Tensor) and x.numel() > 0 and x.untyped_storage().data_ptr() in ptrs for x in flat]
    if not any(shared):
        return result
    return tree_unflatten([x.clone() if s else x for x, s in zip(flat, shared)], spec)


class CompiledUpdateEngine(_EngineBase):
    """Per-metric cache of captured ``update_state`` steps, one per input
    signature; built by ``Metric.update()`` on its first eligible call."""

    def __init__(self, metric: Any) -> None:
        super().__init__(donate=getattr(metric, "_donate_state", True))
        self.metric = metric
        self._has_children = bool(metric._child_metrics())
        # pad+mask bucketing needs the update to accept a validity mask
        mask_ok = getattr(metric, "_accepts_sample_mask", False)
        if mask_ok:
            mask_ok = "sample_mask" in inspect.signature(metric._update).parameters
        self._mask_param = "sample_mask" if mask_ok else None
        self._refresh_probes()

    def _refresh_probes(self) -> None:
        m = self.metric
        self._supports_compiled = m.supports_compiled_update
        self._accepts = getattr(m, "_engine_accepts", None)
        self._buckets_flag = bool(getattr(m, "_batch_buckets", False))

    def reset_signature_memos(self) -> None:
        super().reset_signature_memos()
        self._refresh_probes()

    def _on_cuda(self) -> bool:
        return self.metric.device.type == "cuda"

    def _step_fn(self) -> Callable:
        metric = self.metric
        return lambda state, args, kwargs: metric.update_state(state, *args, **kwargs)

    def dispatch(self, args: Tuple, kwargs: Dict) -> bool:
        """Apply one update through the step cache. True when the update has
        been applied (compiled or bucketed); False tells the caller to run the
        eager update itself."""
        if self._broken is not None or self._has_children or not self._supports_compiled:
            return False
        if _capturing():  # inside another engine's step, or a caller's own capture
            return False
        reason = self.metric._sharded_update_host_read()
        if reason is not None:
            # no probe: every rank declines alike, before any collective
            self._broken = reason
            self.stats.fallback_reasons[self._owner_name()] = reason
            self.stats.eager_calls += 1
            return False
        accepts = self._accepts
        if accepts is not None and not accepts(args, kwargs):
            return False
        if self._buckets_flag:
            if not _leaves_compilable((args, kwargs)):
                return False
            return self._dispatch_bucketed(args, kwargs)
        return self._dispatch_compiled(args, kwargs)

    def _dispatch_compiled(self, args: Tuple, kwargs: Dict) -> bool:
        m = self.metric
        state = m.get_state()
        handled, new_state = self._dispatch(
            state, args, kwargs, _protected_leaf_ids(m), verify_args=_flat_leaves_compilable,
        )
        if handled:
            m.set_state(new_state)
        return handled

    # ------------------------------------------------------------------ #
    # shape bucketing
    # ------------------------------------------------------------------ #
    @staticmethod
    def _batch_leaves(args: Tuple, kwargs: Dict) -> Tuple[Any, Optional[int]]:
        leaves, treedef = tree_flatten((args, kwargs))
        n = next((leaf.shape[0] for leaf in leaves if isinstance(leaf, Tensor) and leaf.ndim >= 1), None)
        return (leaves, treedef), n

    def _dispatch_bucketed(self, args: Tuple, kwargs: Dict) -> bool:
        """Pad to a power-of-two bucket with a ``sample_mask`` (metrics whose
        update takes one) or split the batch into power-of-two chunks, so that
        ragged batches reuse at most log2(N) captured steps."""
        m = self.metric
        (leaves, treedef), n = self._batch_leaves(args, kwargs)
        if not n:
            return False if n is None else self._dispatch_compiled(args, kwargs)
        self.stats.bucketed_calls += 1

        def batch_rows(leaf: Any) -> bool:
            return isinstance(leaf, Tensor) and leaf.ndim >= 1 and leaf.shape[0] == n

        if self._mask_param is not None and self._mask_param not in kwargs:
            bucket = _next_pow2(n)
            if bucket != n:
                padded = [
                    torch.cat([leaf, leaf.new_zeros((bucket - n, *leaf.shape[1:]))]) if batch_rows(leaf) else leaf
                    for leaf in leaves
                ]
                args, kwargs = tree_unflatten(padded, treedef)
            # the mask rides along even for exact power-of-two batches, so
            # padded and unpadded batches of one bucket share a signature
            kwargs = dict(kwargs)
            kwargs[self._mask_param] = torch.arange(bucket, device=m.device) < n
            if not self._dispatch_compiled(args, kwargs):
                m._eager_update(*args, **kwargs)
            return True

        # chunk decomposition: exact whenever the update treats rows independently
        offset = 0
        for chunk in _pow2_chunks(n):
            c_leaves = [leaf[offset:offset + chunk] if batch_rows(leaf) else leaf for leaf in leaves]
            c_args, c_kwargs = tree_unflatten(c_leaves, treedef)
            if not self._dispatch_compiled(c_args, c_kwargs):
                m._eager_update(*c_args, **c_kwargs)
            offset += chunk
        return True


# --------------------------------------------------------------------------- #
# partition classification
# --------------------------------------------------------------------------- #
PATH_FUSED = "fused"
PATH_BUCKETED = "bucketed"
PATH_EAGER = "eager"
PATH_TENANT = "tenant_stacked"

# reductions whose tenant axis folds into the flat sync buckets (an
# elementwise reduce of a stacked buffer is the stacked elementwise reduce);
# cat/None/callable reductions change layout per tenant and cannot stack.
_TENANT_STACKABLE_REDUCTIONS = ("sum", "mean", "max", "min", "sketch")


def classify_update_member(metric: Any) -> Tuple[str, str]:
    """Which update path a member belongs on (``fused``, ``bucketed`` or
    ``eager``) and why: the static checks of the JAX engine."""
    if getattr(metric, "_compiled_update", None) is False:
        return PATH_EAGER, "compiled_update=False"
    if metric._child_metrics():
        return PATH_EAGER, "has child metrics"
    if not metric.supports_compiled_update:
        return PATH_EAGER, "state unsupported by compiled update (unbounded list state)"
    sharded_read = metric._sharded_update_host_read()
    if sharded_read is not None:
        return PATH_EAGER, sharded_read
    statics = tuple(getattr(metric, "_static_update_kwargs", ()) or ())
    if statics:
        # routing flags (FID's and KID's `real`): the metric's own engine keys
        # their values into its signatures, one captured step per value
        return PATH_BUCKETED, (
            f"static update kwargs ({', '.join(statics)}) close over per-value "
            "jit variants in the per-metric engine"
        )
    if getattr(metric, "_batch_buckets", False):
        return PATH_BUCKETED, "batch_buckets=True (pow2-bucketed per-metric engine)"
    return PATH_FUSED, "compilable"


def classify_compute_member(metric: Any) -> Tuple[str, str]:
    """Which compute path a member belongs on (``fused`` or ``eager``) and
    why; the dynamic escapes stay per call in the engines."""
    if getattr(metric, "_compiled_compute", None) is False:
        return PATH_EAGER, "compiled_compute=False"
    if metric._child_metrics():
        return PATH_EAGER, "has child metrics"
    if not metric.supports_compiled_compute:
        return PATH_EAGER, "compute_state unsupported by compiled compute"
    if metric.compute_on_cpu:
        return PATH_EAGER, "compute_on_cpu=True"
    if metric.dist_sync_fn is not None:
        return PATH_EAGER, "custom dist_sync_fn"
    return PATH_FUSED, "compilable"


def classify_tenant_member(metric: Any) -> Tuple[str, str]:
    """Whether a member can join a :class:`~metrics_tpu_torch.tenancy.TenantSet`'s
    stacked leading-axis state, and why (not).

    ``"tenant_stacked"`` members run N tenants through one vmapped captured
    step a bucket; everything else falls back to per-tenant eager clones.
    Stacking needs more than fusing: the member must be fused-classifiable
    for both dispatch kinds, every registered state a dense fixed-shape
    tensor (a ``CatBuffer``'s fill count makes compaction and compute
    value-dependent per tenant; list states have data-dependent shape),
    every reduction elementwise (so the tenant-batched sync folds the tenant
    axis into the flat buckets), and the state not placed by
    :meth:`~metrics_tpu_torch.Metric.shard_state` (the tenant axis would
    fight the placement). The JAX engine's rules and reasons."""
    path, reason = classify_update_member(metric)
    if path != PATH_FUSED:
        return PATH_EAGER, f"update not stackable: {reason}"
    cpath, creason = classify_compute_member(metric)
    if cpath != PATH_FUSED:
        return PATH_EAGER, f"compute not stackable: {creason}"
    for name, default in metric._defaults.items():
        if isinstance(default, CatBuffer):
            return PATH_EAGER, (
                f"state {name!r} is a CatBuffer: its fill count makes compaction and "
                "compute value-dependent per tenant"
            )
        if isinstance(default, (list, tuple)):
            return PATH_EAGER, f"state {name!r} is a {type(default).__name__}: data-dependent state shape"
    for name, red in metric._reductions.items():
        if red not in _TENANT_STACKABLE_REDUCTIONS:
            tag = red if isinstance(red, str) or red is None else "callable"
            return PATH_EAGER, (
                f"state {name!r} dist_reduce_fx {tag!r} is not elementwise: the "
                "tenant-batched sync cannot fold its tenant axis into a flat bucket"
            )
    if metric._state_sharding is not None:
        return PATH_EAGER, "sharded state: the tenant axis would conflict with the mesh placement"
    return PATH_TENANT, "stackable (fused update/compute, dense states, elementwise reductions)"


def _classify_tenant_groups(coll: Any):
    """Partition the compute groups for tenant-stacked dispatch: a group
    stacks only when every member is tenant-stackable (one member's
    value-dependent compute would poison the group's shared vmapped step).
    Returns ``(stacked, eager)`` leader names plus the per-member map. No
    member migrates at runtime: a stacked step that vmap or the capture
    refuses raises."""
    stacked, eager = [], []
    members: Dict[str, Dict[str, str]] = {}
    for group in coll._groups:
        lname = group[0]
        infos = {name: classify_tenant_member(coll._metrics[name]) for name in group}
        stragglers = [n for n, (p, _) in infos.items() if p != PATH_TENANT]
        if stragglers:
            eager.append(lname)
            for name in group:
                path, reason = infos[name]
                if path == PATH_TENANT:
                    reason = f"group demoted by {stragglers[0]!r}: {infos[stragglers[0]][1]}"
                members[name] = {"path": PATH_EAGER, "reason": reason}
        else:
            stacked.append(lname)
            for name in group:
                members[name] = {"path": PATH_TENANT, "reason": infos[name][1]}
    return tuple(stacked), tuple(eager), members


def classify_incremental_member(metric: Any) -> Tuple[str, str]:
    """Whether a member's states take in-streak incremental emissions under
    the resolved sync mode (``"incremental"``, when at least one leaf does)
    or not (``"deferred"``), and why: :func:`parallel.sync.incremental_plan`
    over the registered defaults and declarations."""
    plan = _sync.incremental_plan(metric._defaults, metric._reductions, modes=getattr(metric, "_sync_modes", None),
                                  shard_axes=metric.active_shard_axes)
    covered = [n for n, e in plan.items() if e["mode"] == "incremental"]
    if covered:
        return "incremental", f"{len(covered)}/{len(plan)} state leaves take in-streak emissions"
    if not plan:
        return "deferred", "no registered states"
    if any(e["eligible"] for e in plan.values()):
        return "deferred", "sync mode resolves to deferred for every leaf"
    return "deferred", next(iter(plan.values()))["reason"]


def _classify_incremental_groups(coll: Any) -> Dict[str, Dict[str, str]]:
    """Per-member incremental classification; the leader decides its group."""
    members: Dict[str, Dict[str, str]] = {}
    for group in coll._groups:
        lname = group[0]
        path, reason = classify_incremental_member(coll._metrics[lname])
        for name in group:
            members[name] = {"path": path, "reason": reason if name == lname else f"follows group leader {lname!r}: {reason}"}
    return members


def _classify_update_groups(coll: Any, migrated: Dict[str, str]):
    """Partition the compute groups for ``update()``: the leader's
    classification decides its group. Returns ``(fused, bucketed, eager)``
    leader names and a per-member ``{name: {"path", "reason"}}`` map."""
    fused, bucketed, eager = [], [], []
    members: Dict[str, Dict[str, str]] = {}
    for group in coll._groups:
        lname = group[0]
        if lname in migrated:
            path, reason = PATH_EAGER, f"migrated at runtime: {migrated[lname]}"
        else:
            path, reason = classify_update_member(coll._metrics[lname])
        {PATH_FUSED: fused, PATH_BUCKETED: bucketed, PATH_EAGER: eager}[path].append(lname)
        for name in group:
            members[name] = {"path": path, "reason": reason if name == lname else f"follows group leader {lname!r}: {reason}"}
    return tuple(fused), tuple(bucketed), tuple(eager), members


def _classify_compute_groups(coll: Any, migrated: Dict[str, str]):
    """Partition the compute groups for ``compute()``: a group fuses only
    when every member's finalize is compilable."""
    fused, eager = [], []
    members: Dict[str, Dict[str, str]] = {}
    for group in coll._groups:
        lname = group[0]
        if lname in migrated:
            for name in group:
                members[name] = {"path": PATH_EAGER, "reason": f"migrated at runtime: {migrated[lname]}"}
            eager.append(lname)
            continue
        infos = {name: classify_compute_member(coll._metrics[name]) for name in group}
        stragglers = [n for n, (p, _) in infos.items() if p != PATH_FUSED]
        if stragglers:
            eager.append(lname)
            for name in group:
                path, reason = infos[name]
                if path == PATH_FUSED:
                    reason = f"group demoted by {stragglers[0]!r}: {infos[stragglers[0]][1]}"
                members[name] = {"path": PATH_EAGER, "reason": reason}
        else:
            fused.append(lname)
            for name in group:
                members[name] = {"path": PATH_FUSED, "reason": infos[name][1]}
    return tuple(fused), tuple(eager), members


class CollectionUpdateEngine(_EngineBase):
    """One captured update over a subset of a collection's compute groups
    (``{leader: state}`` in, out): the fused partition's whole step is one
    graph. Rebuilt whenever membership or the partition changes."""

    _opt_out = "fused_update=False"

    def __init__(self, collection: Any, group_names: Optional[Tuple[str, ...]] = None) -> None:
        if group_names is None:
            group_names = tuple(g[0] for g in collection._groups)
        self._group_names = tuple(group_names)
        subset = frozenset(self._group_names)
        super().__init__(donate=all(
            getattr(collection._metrics[g[0]], "_donate_state", True) for g in collection._groups if g[0] in subset
        ))
        self.collection = collection
        self._subset_groups = tuple(tuple(g) for g in collection._groups if g[0] in subset)

    def _leaders(self) -> list:
        coll = self.collection
        return [coll._metrics[g[0]] for g in self._subset_groups]

    def _on_cuda(self) -> bool:
        return any(m.device.type == "cuda" for m in self._leaders())

    def _step_fn(self) -> Callable:
        leaders = [(g[0], self.collection._metrics[g[0]]) for g in self._subset_groups]

        def step(states, args, kwargs):
            return {
                name: leader.update_state(states[name], *args, **leader._filter_kwargs(**kwargs))
                for name, leader in leaders
            }

        return step

    def eligible(self, args: Tuple, kwargs: Dict) -> bool:
        """Per-call dynamic checks; the static member probes ran at partition
        build. A leader's per-call gate (``_engine_accepts``) applies here too."""
        if self._broken is not None or _capturing() or not _leaves_compilable((args, kwargs)):
            return False
        for leader in self._leaders():
            accepts = getattr(leader, "_engine_accepts", None)
            if accepts is not None and not accepts(args, leader._filter_kwargs(**kwargs)):
                return False
        return True

    def dispatch(self, args: Tuple, kwargs: Dict) -> bool:
        coll = self.collection
        # Detach the fused groups' members once: they hold the leader's state
        # tensors, which would defeat the alias guard. While detached only the
        # leaders advance; members realias at the next observation
        # (MetricCollection._realias_members).
        if not coll._members_stale:
            for group in self._subset_groups:
                for name in group[1:]:
                    coll._metrics[name]._detach_states()
            coll._members_stale = True
            if _otrace.active:
                _otrace.emit_instant("streak/detach", "streak", owner=self._owner_name(),
                                     members=sum(len(g) - 1 for g in self._subset_groups))
        states = {g[0]: coll._metrics[g[0]].get_state() for g in self._subset_groups}
        handled, new_states = self._dispatch(states, args, kwargs, _protected_leaf_ids(*self._leaders(), include_shared=False))
        if not handled:
            return False
        for group in self._subset_groups:
            leader = coll._metrics[group[0]]
            leader.set_state(new_states[group[0]])
            leader._update_count += 1
            leader._computed = None
            leader._shared_state_ids = frozenset()
            # the fused step bypasses the facade's update wrapper
            if leader._buffer_states:
                leader._surface_buffer_overflows()
        return True


def _refuse_host_read_sync(metric: Any, state: Any, group: Any) -> None:
    """Raise :class:`Uncapturable` before any collective when ``metric``'s
    sync of ``state`` over ``group`` would read a value back to the host."""
    reason = _sync.sync_host_read(state, metric._reductions, group, metric._sync_transports, metric._sync_tolerances,
                                  metric.active_shard_axes)
    if reason is not None:
        raise Uncapturable(reason)


class _GroupKeys:
    """The process groups a compute engine's steps sync over, by the key the
    step's signature carries (``id`` of the group; None: no sync)."""

    def __init__(self) -> None:
        self._groups: Dict[Optional[int], Any] = {None: None}

    def key(self, group: Any) -> Optional[int]:
        if group is None:
            return None
        self._groups[id(group)] = group
        return id(group)

    def __getitem__(self, key: Optional[int]) -> Any:
        return self._groups[key]


def _compute_group(metric: Any) -> Any:
    """The group ``metric.compute()`` syncs over now, or None; a placed
    metric always syncs over its placement, whatever ``sync_on_compute`` and
    ``dist_sync_on_step`` say (its blocks are not the value)."""
    if metric._sharded or (metric._to_sync and _sync.distributed_available()):
        return metric._sync_group()
    return None


class CompiledComputeEngine(_EngineBase):
    """Per-metric cache of captured ``sync_compute_state`` steps, keyed on the
    state signature and the group the compute syncs over (none: no sync), so
    a synced compute replays its collectives inside the graph. Host offload,
    a custom ``dist_sync_fn`` and an already synced state run the facade's
    eager path."""

    _kind = "compute"
    _target = "compute_state"
    _opt_out = "compiled_compute=False"
    _result_is_state = False

    def __init__(self, metric: Any) -> None:
        super().__init__(donate=False)
        self.metric = metric
        self._has_children = bool(metric._child_metrics())
        self._groups = _GroupKeys()

    def _on_cuda(self) -> bool:
        return self.metric.device.type == "cuda"

    def _step_fn(self) -> Callable:
        metric, groups = self.metric, self._groups

        def step(state, args, kwargs):
            group = groups[args[0]]
            if group is not None:
                _refuse_host_read_sync(metric, state, group)
            return metric.sync_compute_state(state, group)

        return step

    def dispatch(self) -> Tuple[bool, Any]:
        m = self.metric
        if self._broken is not None or self._has_children or not m.supports_compiled_compute:
            return False, None
        # escape hatches stay eager: host offload, a custom sync, and state
        # that a sync already replaced
        if m.compute_on_cpu or m.dist_sync_fn is not None or m._is_synced:
            return False, None
        if _capturing():
            return False, None
        state = m.get_state()
        if not _leaves_compilable(state):
            return False, None
        group_key = self._groups.key(_compute_group(m))
        # a synced compute keys on the tuner's epoch too: a decision captures anew
        args = (group_key,) if group_key is None else (group_key, _autotune_token())
        return self._dispatch(state, args, {}, frozenset())


class CollectionComputeEngine(_EngineBase):
    """One captured compute over a subset of a collection's compute groups:
    ``{leader: state}`` to every member's raw value."""

    _kind = "compute"
    _target = "compute_state"
    _opt_out = "compiled_compute=False"
    _result_is_state = False

    def __init__(self, collection: Any, group_names: Optional[Tuple[str, ...]] = None) -> None:
        super().__init__(donate=False)
        self.collection = collection
        if group_names is None:
            group_names = tuple(g[0] for g in collection._groups)
        self._group_names = tuple(group_names)
        subset = frozenset(self._group_names)
        self._subset_groups = tuple(tuple(g) for g in collection._groups if g[0] in subset)
        self._groups = _GroupKeys()
        self._sync_key: Optional[int] = None

    def _on_cuda(self) -> bool:
        coll = self.collection
        return any(coll._metrics[g[0]].device.type == "cuda" for g in self._subset_groups)

    def _step_fn(self) -> Callable:
        coll, groups, keys = self.collection, self._subset_groups, self._groups

        def step(states, args, kwargs):
            group = keys[args[0]]
            if group is not None:
                for g in groups:
                    _refuse_host_read_sync(coll._metrics[g[0]], states[g[0]], group)
                states = {g[0]: coll._metrics[g[0]].sync_states(states[g[0]], group) for g in groups}
            return {name: coll._metrics[name].compute_state(states[g[0]]) for g in groups for name in g}

        return step

    def eligible(self) -> bool:
        """Per-call escapes: leaders that sync over different groups, a
        synced member, or a member never updated (the eager loop keeps its
        warning) run the eager loop."""
        if self._broken is not None or _capturing():
            return False
        coll = self.collection
        sync_groups = set()
        for group in self._subset_groups:
            sync_groups.add(self._groups.key(_compute_group(coll._metrics[group[0]])))
            for name in group:
                m = coll._metrics[name]
                if m._is_synced or m._update_count == 0:
                    return False
        if len(sync_groups) > 1:
            return False
        self._sync_key = sync_groups.pop()
        return True

    @property
    def sync_group(self) -> Any:
        """The group the last eligible call syncs over (None: no sync)."""
        return self._groups[self._sync_key]

    def dispatch(self) -> Tuple[bool, Any]:
        coll = self.collection
        states = {g[0]: coll._metrics[g[0]].get_state() for g in self._subset_groups}
        if not _leaves_compilable(states):
            return False, None
        return self._dispatch(states, (self._sync_key,), {}, frozenset())


class CompiledIncrementalStep(_EngineBase):
    """Captured ``update_state_incremental`` steps of a metric or a
    collection, synced over ``group``: the counterpart of jitting the JAX
    package's incremental step inside its ``shard_map``.

    ``step(carry, *args, **kwargs)`` takes and returns what the owner's
    ``update_state_incremental`` does (a carry; a collection's
    ``{leader: carry}``). The carries' ``state``, ``acc`` and ``last`` dicts
    are the step's state. Whether the call emits is part of its signature
    (with the gate's decisions, where a covered leaf is quantized and its
    bound compounds), so a cadence of K captures at most two graphs per input
    signature, one that emits and one that does not; ``pending`` and
    ``emissions`` stay on the host. As in the update engine, the first call
    of a signature runs eager, the second is probed and captured, every later
    one replays; on the CPU the step runs with the checks off. Results are
    fresh tensors: the carry handed in stays valid.
    """

    _kind = "incremental"
    _target = "update_state_incremental"
    _opt_out = "an eager update_state_incremental"

    def __init__(self, owner: Any, group: Any = None) -> None:
        super().__init__(donate=False)
        self._is_collection = hasattr(owner, "_groups")
        if self._is_collection:
            self.collection = owner
        else:
            self.metric = owner
        self.owner = owner
        self.group = group
        self._host: Dict[str, Tuple[int, int, int, bool]] = {}

    def _leaders(self) -> List[Tuple[str, Any]]:
        if self._is_collection:
            return [(g[0], self.owner._metrics[g[0]]) for g in self.owner._groups]
        return [("", self.owner)]

    def _on_cuda(self) -> bool:
        return any(m.device.type == "cuda" for _, m in self._leaders())

    def _carries(self, carry: Any) -> Dict[str, Any]:
        return dict(carry) if self._is_collection else {"": carry}

    def _step_fn(self) -> Callable:
        owner, group, host = self.owner, self.group, self._host
        is_collection = self._is_collection

        def step(tree, args, kwargs):
            carries = {
                name: _sync.IncrementalCarry(parts["state"], parts["acc"], parts["last"], *host[name])
                for name, parts in tree.items()
            }
            new = owner.update_state_incremental(carries if is_collection else carries[""], *args[1:], group=group,
                                                 **kwargs)
            new = new if is_collection else {"": new}
            return {name: {"state": c.state, "acc": c.acc, "last": c.last} for name, c in new.items()}

        return step

    def _emission_key(self, carries: Dict[str, Any]) -> Tuple[Tuple, Dict[str, Tuple[int, int]]]:
        """The signature part of this call's emissions, and each carry's next
        ``(pending, emissions)``."""
        world = dist.get_world_size(self.group) if self.group is not None else None
        key, nxt = [], {}
        for name, metric in self._leaders():
            carry = carries[name]
            emits, pending, emissions = _sync._advanced(carry, self.group)
            gates = ()
            if emits:
                gates = tuple(
                    _sync.TRANSPORTS.index(t) for _, t in _sync.emission_transports(
                        carry, metric._reductions, world, modes=metric._sync_modes,
                        transports=metric._sync_transports, tolerances=metric._sync_tolerances,
                    )
                )
            key.append((emits, gates))
            nxt[name] = (pending, emissions)
        if any(emits for emits, _ in key):
            key.append(_autotune_token())  # the tuner's epoch: a decision captures anew
        return tuple(key), nxt

    def __call__(self, carry: Any, *args: Any, **kwargs: Any) -> Any:
        carries = self._carries(carry)
        tree = {name: {"state": c.state, "acc": c.acc, "last": c.last} for name, c in carries.items()}
        if self._broken is not None or _capturing() or not _leaves_compilable(tree):
            return self.owner.update_state_incremental(carry, *args, group=self.group, **kwargs)
        key, nxt = self._emission_key(carries)
        self._host.clear()
        self._host.update({n: (c.sync_every, c.pending, c.emissions, c.track_emissions) for n, c in carries.items()})
        handled, out = self._dispatch(tree, (key, *args), kwargs, frozenset(), verify_args=_flat_leaves_compilable)
        if not handled:
            return self.owner.update_state_incremental(carry, *args, group=self.group, **kwargs)
        new = {
            name: _sync.IncrementalCarry(out[name]["state"], out[name]["acc"], out[name]["last"], c.sync_every,
                                         *nxt[name], c.track_emissions)
            for name, c in carries.items()
        }
        return new if self._is_collection else new[""]


# --------------------------------------------------------------------------- #
# the partition-aware dispatcher
# --------------------------------------------------------------------------- #
@dataclass
class PartitionStats:
    """Partition lifecycle counters for one dispatcher (all monotonic)."""

    builds: int = 0
    repartitions: int = 0
    migrations: int = 0
    stable_hits: int = 0
    probations: int = 0
    repromotions: int = 0


@dataclass(frozen=True)
class CollectionPartition:
    """One cached classification of a collection's compute groups."""

    key: Tuple
    update_fused: Tuple[str, ...]
    update_bucketed: Tuple[str, ...]
    update_eager: Tuple[str, ...]
    compute_fused: Tuple[str, ...]
    compute_eager: Tuple[str, ...]
    update_members: Dict[str, Dict[str, str]]
    compute_members: Dict[str, Dict[str, str]]
    incremental_members: Dict[str, Dict[str, str]] = field(default_factory=dict)
    update_rest: Tuple[Tuple[str, ...], ...] = ()
    compute_rest: Tuple[Tuple[str, ...], ...] = ()
    # the tenant-stacked class (only for a dispatcher built with a tenant
    # context, a TenantSet): leaders whose groups stack, the per-tenant
    # eager ones, and each member's path and reason
    tenant_stacked: Tuple[str, ...] = ()
    tenant_eager: Tuple[str, ...] = ()
    tenant_members: Dict[str, Dict[str, str]] = field(default_factory=dict)


class CollectionDispatcher:
    """Partition-aware dispatch for ``MetricCollection.update()/compute()``.

    The compute groups are classified into fused, bucketed and eager sets
    (re-classified whenever the members' cheap eligibility flags change). The
    fused set runs as one captured step, bucketed leaders through their own
    pow2-bucketed engines in the eager loop, and the rest eagerly. A member
    whose step turns out not to be capturable migrates to the eager set
    alone; the fused step is rebuilt over the remainder.

    ``tenant_context`` is the :class:`~metrics_tpu_torch.tenancy.TenantSet`
    hosting this dispatcher, if any: its partitions then carry the
    tenant-stacked class too, and the view a ``tenant`` section (the set
    owns the stacked state and its captured steps).
    """

    def __init__(self, collection: Any, tenant_context: Any = None) -> None:
        self.collection = collection
        self.tenant_context = tenant_context
        self.stats = PartitionStats()
        self._partition: Optional[CollectionPartition] = None
        self._update_engine: Optional[CollectionUpdateEngine] = None
        self._compute_engine: Optional[CollectionComputeEngine] = None
        self._migrated_update: Dict[str, str] = {}
        self._migrated_compute: Dict[str, str] = {}
        self._retired_reasons: Dict[str, str] = {}
        self._probation: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._reprobing: Dict[str, set] = {"update": set(), "compute": set()}
        self._dispatch_count = 0
        self._last_fallback_exception: Optional[str] = None
        # the partition counters show up in snapshots as
        # metrics_tpu_partition_*{owner}
        _instruments.register_dispatcher(self)

    def __deepcopy__(self, memo: Dict) -> None:
        return None

    # ------------------------------------------------------------------ #
    # partition lifecycle
    # ------------------------------------------------------------------ #
    def _partition_key(self) -> Tuple:
        coll = self.collection
        parts: List[Any] = [
            ("sync_mode", _sync.sync_mode_default()),
            # the autotune decision epoch: a tuner decision repartitions (and
            # recaptures) once; a committed tuner adds no rebuild
            ("autotune", _autotune_token()),
        ]
        for group in coll._groups:
            leader = coll._metrics[group[0]]
            parts.append((
                tuple(group),
                getattr(leader, "_compiled_update", None) is False,
                bool(getattr(leader, "_batch_buckets", False)),
                tuple(sorted(getattr(leader, "_sync_modes", {}).items())),
                leader._state_sharding is not None,
                group[0] in self._migrated_update,
                group[0] in self._migrated_compute,
                tuple(
                    (
                        getattr(coll._metrics[name], "_compiled_compute", None) is False,
                        bool(coll._metrics[name].compute_on_cpu),
                        coll._metrics[name].dist_sync_fn is not None,
                    )
                    for name in group
                ),
            ))
        return tuple(parts)

    def _ensure_partition(self) -> CollectionPartition:
        key = self._partition_key()
        part = self._partition
        if part is not None and key == part.key:
            self.stats.stable_hits += 1
            return part
        return self._build_partition(key)

    def _build_partition(self, key: Optional[Tuple] = None) -> CollectionPartition:
        coll = self.collection
        if key is None:
            key = self._partition_key()
        rebuild = self._partition is not None
        # members must be whole before the fused subset changes
        coll._realias_members()
        u_fused, u_bucketed, u_eager, u_members = _classify_update_groups(coll, self._migrated_update)
        c_fused, c_eager, c_members = _classify_compute_groups(coll, self._migrated_compute)
        t_stacked: Tuple[str, ...] = ()
        t_eager: Tuple[str, ...] = ()
        t_members: Dict[str, Dict[str, str]] = {}
        if self.tenant_context is not None:
            t_stacked, t_eager, t_members = _classify_tenant_groups(coll)
        u_set, c_set = frozenset(u_fused), frozenset(c_fused)
        part = CollectionPartition(
            key=key,
            update_fused=u_fused, update_bucketed=u_bucketed, update_eager=u_eager,
            compute_fused=c_fused, compute_eager=c_eager,
            update_members=u_members, compute_members=c_members,
            incremental_members=_classify_incremental_groups(coll),
            update_rest=tuple(tuple(g) for g in coll._groups if g[0] not in u_set),
            compute_rest=tuple(tuple(g) for g in coll._groups if g[0] not in c_set),
            tenant_stacked=t_stacked, tenant_eager=t_eager, tenant_members=t_members,
        )
        self._partition = part
        self._update_engine = None
        self._compute_engine = None
        coll._update_engine = None
        coll._compute_engine = None
        self.stats.builds += 1
        if rebuild:
            self.stats.repartitions += 1
        if _otrace.active:
            _otrace.emit_instant(
                "partition/rebuild" if rebuild else "partition/build", "partition",
                owner=type(coll).__name__,
                fused=len(u_fused), bucketed=len(u_bucketed), eager=len(u_eager),
                compute_fused=len(c_fused), compute_eager=len(c_eager),
            )
        return part

    def _ensure_update_engine(self, part: CollectionPartition) -> Optional[CollectionUpdateEngine]:
        if self._update_engine is None and part.update_fused:
            self._update_engine = CollectionUpdateEngine(self.collection, part.update_fused)
            self.collection._update_engine = self._update_engine
        return self._update_engine

    def _ensure_compute_engine(self, part: CollectionPartition) -> Optional[CollectionComputeEngine]:
        if self._compute_engine is None and part.compute_fused:
            self._compute_engine = CollectionComputeEngine(self.collection, part.compute_fused)
            self.collection._compute_engine = self._compute_engine
        return self._compute_engine

    # ------------------------------------------------------------------ #
    # runtime migration
    # ------------------------------------------------------------------ #
    def _migrate(self, kind: str, culprits: Dict[str, str], engine: Any, transient: bool) -> CollectionPartition:
        migrated = self._migrated_update if kind == "update" else self._migrated_compute
        migrated.update(culprits)
        self.stats.migrations += len(culprits)
        for owner, why in engine.stats.fallback_reasons.items():
            self._retired_reasons.setdefault(f"{kind}:{owner}", why)
        if engine.stats.last_fallback_exception is not None:
            self._last_fallback_exception = engine.stats.last_fallback_exception
        cooldown = probation_cooldown()
        for lname, why in culprits.items():
            self._reprobing[kind].discard(lname)
            entry = self._probation.setdefault((kind, lname), {"failures": 0, "next_retry": None, "reason": why})
            entry["failures"] += 1
            entry["reason"] = why
            if transient and cooldown > 0 and entry["failures"] <= _MAX_PROBATION_TRIALS:
                entry["next_retry"] = self._dispatch_count + cooldown * (2 ** (entry["failures"] - 1))
                self.stats.probations += 1
            else:
                # the probe named the culprit: it cannot be captured, so a
                # re-probe would fail the same way
                entry["next_retry"] = None
        if _otrace.active:
            _otrace.emit_instant(
                "partition/migrate", "partition", owner=type(self.collection).__name__, kind=kind,
                members=sorted(culprits), reason=next(iter(culprits.values()))[:200],
            )
        return self._build_partition()

    def _migrate_update(self, engine: CollectionUpdateEngine, args: Tuple, kwargs: Dict) -> CollectionPartition:
        """The fused update's probe failed: probe each fused leader alone and
        move only the culprits to the eager set; with none attributable, the
        whole fused set demotes. The probes' results are dropped."""
        coll = self.collection
        culprits: Dict[str, str] = {}
        for lname in self._partition.update_fused:
            leader = coll._metrics[lname]
            try:
                with _probe():
                    leader.update_state(leader.get_state(), *args, **leader._filter_kwargs(**kwargs))
            except Uncapturable as err:
                culprits[lname] = _first_line(err)
        if culprits:
            return self._migrate("update", culprits, engine, transient=False)
        broken = (engine.broken or "capture failure").splitlines()[0][:200]
        return self._migrate("update", {l: broken for l in self._partition.update_fused}, engine, transient=True)

    def _migrate_compute(self, engine: CollectionComputeEngine) -> CollectionPartition:
        coll = self.collection
        culprits: Dict[str, str] = {}
        sync_group = engine.sync_group
        for lname in self._partition.compute_fused:
            group = next(g for g in coll._groups if g[0] == lname)
            leader = coll._metrics[lname]
            state = leader.get_state()
            if sync_group is not None:
                reason = _sync.sync_host_read(state, leader._reductions, sync_group, leader._sync_transports,
                                              leader._sync_tolerances, leader.active_shard_axes)
                if reason is not None:
                    culprits[lname] = f"{lname}: Uncapturable: {reason}"
                    continue
            for name in group:
                try:
                    with _probe():
                        coll._metrics[name].compute_state(state)
                except Uncapturable as err:
                    culprits[lname] = f"{name}: {_first_line(err)}"
                    break
        if culprits:
            return self._migrate("compute", culprits, engine, transient=False)
        broken = (engine.broken or "capture failure").splitlines()[0][:200]
        return self._migrate("compute", {l: broken for l in self._partition.compute_fused}, engine, transient=True)

    # ------------------------------------------------------------------ #
    # probation
    # ------------------------------------------------------------------ #
    def _tick_probation(self, kind: str) -> None:
        self._dispatch_count += 1
        if not self._probation:
            return
        migrated = self._migrated_update if kind == "update" else self._migrated_compute
        for (k, lname), entry in self._probation.items():
            if (k == kind and entry["next_retry"] is not None and self._dispatch_count >= entry["next_retry"]
                    and lname in migrated):
                del migrated[lname]  # key change: the rebuild rejoins the member
                entry["next_retry"] = None
                self._reprobing[kind].add(lname)

    def _confirm_repromotions(self, kind: str, fused: Tuple[str, ...]) -> None:
        promoted = sorted(l for l in self._reprobing[kind] if l in fused)
        if not promoted:
            return
        for lname in promoted:
            self._reprobing[kind].discard(lname)
            self._probation.pop((kind, lname), None)
        self.stats.repromotions += len(promoted)
        if _otrace.active:
            _otrace.emit_instant("partition/repromote", "partition", owner=type(self.collection).__name__,
                                 kind=kind, members=promoted)

    # ------------------------------------------------------------------ #
    # dispatch
    # ------------------------------------------------------------------ #
    def update(self, args: Tuple, kwargs: Dict) -> None:
        coll = self.collection
        self._tick_probation("update")
        part = self._ensure_partition()
        handled_fused = False
        if part.update_fused:
            engine = self._ensure_update_engine(part)
            if engine.eligible(args, kwargs):
                handled_fused = engine.dispatch(args, kwargs)
                if handled_fused:
                    if self._reprobing["update"]:
                        self._confirm_repromotions("update", part.update_fused)
                elif engine.broken is not None:
                    part = self._migrate_update(engine, args, kwargs)
        # warmup, a declined call or a fresh migration: the eager loop runs
        # every group this call (rebroadcasting detached members)
        rest = part.update_rest if handled_fused else coll._groups
        if rest:
            coll._eager_update_groups(rest, args, kwargs)
        if not handled_fused:
            coll._members_stale = False

    def compute(self) -> Dict[str, Any]:
        """Raw ``{output_name: value}`` in declaration order."""
        from metrics_tpu_torch.utils.data import _squeeze_if_scalar

        coll = self.collection
        self._tick_probation("compute")
        part = self._ensure_partition()
        values = None
        if part.compute_fused:
            engine = self._ensure_compute_engine(part)
            if engine.eligible():
                handled, vals = engine.dispatch()
                if handled:
                    values = vals
                    if self._reprobing["compute"]:
                        self._confirm_repromotions("compute", part.compute_fused)
                elif engine.broken is not None:
                    part = self._migrate_compute(engine)
        if values is not None:
            fused = frozenset(part.compute_fused)
            eager_groups = part.compute_rest
        else:
            fused = frozenset()
            eager_groups = coll._groups
        eager_res = coll._eager_compute_groups(eager_groups) if eager_groups else {}
        res: Dict[str, Any] = {}
        for group in coll._groups:
            for name in group:
                key = coll._set_name(name)
                if group[0] in fused:
                    m = coll._metrics[name]
                    m._computed = _squeeze_if_scalar(values[name])
                    res[key] = m._computed
                elif key in eager_res:
                    res[key] = eager_res[key]
        if _guard.active and not _guard.capturing():
            _guard.inspect(type(coll).__name__, "compute", res)
        return res

    # ------------------------------------------------------------------ #
    # views
    # ------------------------------------------------------------------ #
    def partition_view(self) -> Dict[str, Any]:
        """The ``engine_stats()["partition"]`` payload."""
        part = self._partition
        if part is not None:
            u_members, c_members, i_members = part.update_members, part.compute_members, part.incremental_members
            t_members = part.tenant_members
        else:
            u_members = _classify_update_groups(self.collection, self._migrated_update)[3]
            c_members = _classify_compute_groups(self.collection, self._migrated_compute)[2]
            i_members = _classify_incremental_groups(self.collection)
            t_members = {}
            if self.tenant_context is not None:
                t_members = _classify_tenant_groups(self.collection)[2]
        view = {
            "update": {name: dict(info) for name, info in u_members.items()},
            "compute": {name: dict(info) for name, info in c_members.items()},
            "incremental": {name: dict(info) for name, info in i_members.items()},
            "builds": self.stats.builds,
            "repartitions": self.stats.repartitions,
            "migrations": self.stats.migrations,
            "stable_hits": self.stats.stable_hits,
            "probations": self.stats.probations,
            "repromotions": self.stats.repromotions,
            "probation": {
                f"{kind}:{lname}": dict(entry) for (kind, lname), entry in self._probation.items()
            },
            "last_fallback_exception": self._last_fallback_exception,
        }
        if self.tenant_context is not None:
            view["tenant"] = {name: dict(info) for name, info in t_members.items()}
        return view


def collection_partition_view(coll: Any) -> Dict[str, Any]:
    """Partition view of a collection, with or without a live dispatcher."""
    dispatcher = getattr(coll, "_dispatcher", None)
    if dispatcher is not None:
        return dispatcher.partition_view()
    return {
        "update": _classify_update_groups(coll, {})[3],
        "compute": _classify_compute_groups(coll, {})[2],
        "incremental": _classify_incremental_groups(coll),
        "builds": 0, "repartitions": 0, "migrations": 0, "stable_hits": 0,
        "probations": 0, "repromotions": 0,
        "probation": {}, "last_fallback_exception": None,
    }


def metric_partition_view(metric: Any) -> Dict[str, Any]:
    """Single-metric view: the static classification, overridden by a
    recorded fallback of the metric's own engines."""
    last_exc = None
    u_path, u_reason = classify_update_member(metric)
    engine = getattr(metric, "_update_engine", None)
    if engine is not None and engine.broken is not None:
        u_path, u_reason = PATH_EAGER, f"runtime fallback: {engine.broken.splitlines()[0][:200]}"
        last_exc = engine.stats.last_fallback_exception
    c_path, c_reason = classify_compute_member(metric)
    engine = getattr(metric, "_compute_engine", None)
    if engine is not None and engine.broken is not None:
        c_path, c_reason = PATH_EAGER, f"runtime fallback: {engine.broken.splitlines()[0][:200]}"
        last_exc = engine.stats.last_fallback_exception or last_exc
    i_path, i_reason = classify_incremental_member(metric)
    return {
        "update": {"path": u_path, "reason": u_reason},
        "compute": {"path": c_path, "reason": c_reason},
        "incremental": {"path": i_path, "reason": i_reason},
        "last_fallback_exception": last_exc,
    }

