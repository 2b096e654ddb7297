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
  reach; ``tolist``, ``numpy`` and copies to the host) and operations whose
  output shape depends on values (``nonzero``, ``unique``, ``masked_select``,
  indexing with a bool tensor). A probe that raises leaves the state as it
  was and reverts the metric, or the collection member, to eager for good,
  with the reason recorded. A probe that passes commits its result: that is
  the call's update. On the card the step is then captured into a graph on
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
recorded. So :class:`CapturedStep` takes back each kernel's count delta of
the capture and adds it again at every replay (``ops.kernels.launch_counts``).

**Errors.** Only :class:`Uncapturable` and the errors torch raises for an
operation a capture refuses revert a member. A kernel build or launch error
propagates, as it does eagerly.

Not here, and queued elsewhere: tenant classification and ``PATH_TENANT``
(A19), the incremental sync groups and collectives inside a captured compute
(A17), the tracer, chaos and guard hooks and the autotune token (A20), and
``CatBuffer``'s traced part (A10).

Global switches: ``set_compiled_update``, ``set_compiled_compute`` and
``set_fused_update`` (environment variables ``METRICS_TPU_COMPILED_UPDATE``,
``METRICS_TPU_COMPILED_COMPUTE`` and ``METRICS_TPU_FUSED_UPDATE``, on unless
set to ``0``); per instance ``compiled_update=`` / ``compiled_compute=`` /
``fused_update=`` take precedence in both directions.
"""
from __future__ import annotations

import inspect
import os
import sys
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import Tensor
from torch.utils._python_dispatch import TorchDispatchMode

from metrics_tpu_torch.ops import kernels as _kernels
from metrics_tpu_torch.parallel import sync as _sync
from metrics_tpu_torch.utils.checks import _capturing, _checks_off
from metrics_tpu_torch.utils.exceptions import Uncapturable
from metrics_tpu_torch.utils.prints import rank_zero_warn

# number of eager sightings of a signature before compiling it
_WARMUP_CALLS = 1

_ENV_FLAG = "METRICS_TPU_COMPILED_UPDATE"
_ENV_FLAG_COMPUTE = "METRICS_TPU_COMPILED_COMPUTE"
_ENV_FLAG_FUSED = "METRICS_TPU_FUSED_UPDATE"

_SCALAR_TYPES = (int, float, bool, complex)


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
    # collectives of a captured step: zero and empty until sync can be
    # captured (A17)
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
# its own small flattener for dicts, lists, tuples and named tuples (leaves
# are anything else); the spec is a hashable nested tuple
# --------------------------------------------------------------------------- #
def _flatten_into(tree: Any, leaves: list) -> Any:
    kind = type(tree)
    if kind is dict:
        return ("d", tuple(tree), tuple(_flatten_into(v, leaves) for v in tree.values()))
    if kind is list:
        return ("l", tuple(_flatten_into(v, leaves) for v in tree))
    if kind is tuple:
        return ("t", tuple(_flatten_into(v, leaves) for v in tree))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return ("n", kind, tuple(_flatten_into(v, leaves) for v in tree))
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
    return node[1](*(_build(c, it) for c in node[2]))


def tree_unflatten(leaves: list, spec: Any) -> Any:
    # no closure: a recursive inner function would form a cycle that keeps
    # the leaves alive until the next garbage collection
    return _build(spec, iter(leaves))


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


def _is_bool_index(index: Any) -> bool:
    return isinstance(index, Tensor) and index.dtype in (torch.bool, torch.uint8)


class _ProbeMode(TorchDispatchMode):
    """Raise :class:`Uncapturable` on every operation a stream capture refuses."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if packet in _HOST_READS:
            raise Uncapturable(f"{func} reads a value back to the host")
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


def _refuse_host_read(*_: Any, **__: Any) -> Any:
    raise Uncapturable("Tensor.tolist/numpy reads a value back to the host")


class _probe:
    """The probe context: the dispatch mode, ``tolist``/``numpy`` refused
    (they reach no operator on the CPU), value checks off, no autograd."""

    _PATCHED = ("tolist", "numpy")

    def __enter__(self) -> "_probe":
        self._saved = {name: torch.Tensor.__dict__.get(name) for name in self._PATCHED}
        for name in self._PATCHED:
            setattr(torch.Tensor, name, _refuse_host_read)
        self._ctx = [_checks_off(), torch.no_grad(), _ProbeMode()]
        for ctx in self._ctx:
            ctx.__enter__()
        return self

    def __exit__(self, *exc: Any) -> None:
        for ctx in reversed(self._ctx):
            ctx.__exit__(*exc)
        for name, saved in self._saved.items():
            if saved is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, saved)


class _steady:
    """A steady-state step: value checks off, no autograd."""

    def __enter__(self) -> None:
        self._ctx = [_checks_off(), torch.no_grad()]
        for ctx in self._ctx:
            ctx.__enter__()

    def __exit__(self, *exc: Any) -> None:
        for ctx in reversed(self._ctx):
            ctx.__exit__(*exc)


_CAPTURE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The side stream the engines probe and capture on, one per device."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    stream = _CAPTURE_STREAMS.get(index)
    if stream is None:
        stream = _CAPTURE_STREAMS[index] = torch.cuda.Stream(device=index)
    return stream


def _sub_counts(a: Dict[str, int], b: Dict[str, int]) -> Dict[str, int]:
    return {k: a[k] - b.get(k, 0) for k in a if a[k] != b.get(k, 0)}


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
    replay.
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
            with _probe():
                out = self.fn(state, args, kwargs)
            out_leaves = self._check_out(state_leaves, out)
            self._make_statics(state_leaves, arg_leaves, out_leaves)
            return out

        current = torch.cuda.current_stream(device)
        side = _capture_stream(device)
        side.wait_stream(current)
        try:
            with torch.cuda.stream(side):
                # the probe runs where the capture will: per-stream resources
                # a kernel wrapper makes on first use exist before the capture
                with _probe():
                    out = self.fn(state, args, kwargs)
                out_leaves = self._check_out(state_leaves, out)
            with torch.cuda.stream(current):
                self._make_statics(state_leaves, arg_leaves, out_leaves)
            side.wait_stream(current)
            self._capture(side)
        finally:
            # every use of the side stream starts by waiting for the current
            # one, so the probe's results (made there) may be handed out
            current.wait_stream(side)
        return out

    def _check_out(self, state_leaves: list, out: Any) -> list:
        out_leaves, self._out_spec = tree_flatten(out)
        for x in out_leaves:
            if not isinstance(x, Tensor):
                raise Uncapturable(f"the step returns a {type(x).__name__}, which a graph would freeze")
        if self.writes_state and [(x.shape, x.dtype) for x in out_leaves] != [
            (x.shape, x.dtype) for x in state_leaves
        ]:
            raise Uncapturable("the step changes the state's shapes or dtypes")
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
        state, args, kwargs = self._static_inputs()
        out = tree_leaves(self.fn(state, args, kwargs))
        if self.writes_state:
            torch._foreach_copy_(self.state_static, out)
            return
        i = 0
        for dtype, shape, offset, count in self._out_layout:
            run, i = out[i:i + count], i + count
            dst = self.out_flat[dtype][offset:offset + count * shape.numel()]
            src = _one_block(run, shape.numel())
            dst.copy_(src if src is not None else torch.cat([x.reshape(-1) for x in run]))

    def _capture(self, side: "torch.cuda.Stream") -> None:
        graph = torch.cuda.CUDAGraph()
        before = _kernels.launch_counts()
        try:
            with _steady(), torch.cuda.graph(graph, pool=self.pool, stream=side):
                self._body()
        except RuntimeError as err:
            if "captur" not in str(err).lower():
                raise
            raise Uncapturable(f"the CUDA graph capture refused the step: {str(err).splitlines()[0][:200]}") from err
        finally:
            # a capture records launches; it makes none
            self.launch_delta = _sub_counts(_kernels.launch_counts(), before)
            _kernels.add_launches({k: -n for k, n in self.launch_delta.items()})
        self.graph = graph

    def replay(self) -> None:
        self.graph.replay()
        _kernels.add_launches(self.launch_delta)

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
        if self.graph is None:  # the CPU: run the step, no graph
            with _steady():
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

    def run_compute(self, state: Any, leaves: list) -> Any:
        """A steady-state compute; returns fresh tensors."""
        if self.graph is None:
            with _steady():
                return self.fn(state, (), {})
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
        try:
            if count == _WARMUP_CALLS or step is None:
                t0 = time.perf_counter()
                step = self._new_step()
                result = step.probe(state, args, kwargs)
                self._steps[key] = step
                self._static_ids.update(id(x) for x in step.state_static)
                self.stats.compile_seconds += time.perf_counter() - t0
                if self._result_is_state and self._donate:
                    # the next call finds the statics as its state and
                    # updates them in place
                    for dst, src in zip(step.state_static, tree_leaves(result)):
                        dst.copy_(src)
                    result = tree_unflatten(list(step.state_static), step._state_spec)
            elif self._result_is_state:
                free = self._statics_free(step, leaves, donate_ok)
                result = step.run_update(state, leaves, args, kwargs, arg_leaves, donate_ok, free)
            else:
                result = step.run_compute(state, leaves)
        except Uncapturable as err:
            self._broken = _first_line(err, 400)
            self.stats.fallback_reasons[self._owner_name()] = self._broken
            self.stats.last_fallback_step = self.stats.eager_calls + self.stats.compiled_calls + 1
            self.stats.last_fallback_exception = _first_line(err, 160)
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
            # the next call's state is this result: its signature is known
            out_leaves, out_spec = tree_flatten(result)
            out_sig = self._out_sigs.get(key)
            if out_sig is None:
                out_sig = self._out_sigs[key] = _signature_flat(out_leaves, out_spec)
            self._state_sig.seed(out_leaves, out_spec, out_sig)
        return True, result


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
                m._update(*args, **kwargs)
            return True

        # chunk decomposition: exact whenever the update treats rows independently
        offset = 0
        for chunk in _pow2_chunks(n):
            c_leaves = [leaf[offset:offset + chunk] if batch_rows(leaf) else leaf for leaf in leaves]
            c_args, c_kwargs = tree_unflatten(c_leaves, treedef)
            if not self._dispatch_compiled(c_args, c_kwargs):
                m._update(*c_args, **c_kwargs)
            offset += chunk
        return True


# --------------------------------------------------------------------------- #
# partition classification
# --------------------------------------------------------------------------- #
PATH_FUSED = "fused"
PATH_BUCKETED = "bucketed"
PATH_EAGER = "eager"


def classify_update_member(metric: Any) -> Tuple[str, str]:
    """Which update path a member belongs on (``fused``, ``bucketed`` or
    ``eager``) and why: the static checks of the JAX engine."""
    if getattr(metric, "_compiled_update", None) is False:
        return PATH_EAGER, "compiled_update=False"
    if metric._child_metrics():
        return PATH_EAGER, "has child metrics"
    if not metric.supports_compiled_update:
        return PATH_EAGER, "state unsupported by compiled update (unbounded list state)"
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
        return True


class CompiledComputeEngine(_EngineBase):
    """Per-metric cache of captured ``compute_state`` steps, keyed on the
    state signature. Sync stays eager: a compute whose state is (or is about
    to be) synced runs the facade's eager path."""

    _kind = "compute"
    _target = "compute_state"
    _opt_out = "compiled_compute=False"
    _result_is_state = False

    def __init__(self, metric: Any) -> None:
        super().__init__(donate=False)
        self.metric = metric
        self._has_children = bool(metric._child_metrics())

    def _on_cuda(self) -> bool:
        return self.metric.device.type == "cuda"

    def _step_fn(self) -> Callable:
        metric = self.metric
        return lambda state, args, kwargs: metric.compute_state(state)

    def dispatch(self) -> Tuple[bool, Any]:
        m = self.metric
        if self._broken is not None or self._has_children or not m.supports_compiled_compute:
            return False, None
        # escape hatches stay eager: host offload, a custom sync, and state
        # that is (or is about to be) replaced by a real sync
        if m.compute_on_cpu or m.dist_sync_fn is not None or m._is_synced:
            return False, None
        if m._to_sync and _sync.distributed_available():
            return False, None
        if _capturing():
            return False, None
        state = m.get_state()
        if not _leaves_compilable(state):
            return False, None
        return self._dispatch(state, (), {}, frozenset())


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

    def _on_cuda(self) -> bool:
        coll = self.collection
        return any(coll._metrics[g[0]].device.type == "cuda" for g in self._subset_groups)

    def _step_fn(self) -> Callable:
        coll = self.collection
        groups = self._subset_groups

        def step(states, args, kwargs):
            return {name: coll._metrics[name].compute_state(states[group[0]]) for group in groups for name in group}

        return step

    def eligible(self) -> bool:
        """Per-call escapes: a sync due, a synced member, or a member never
        updated (the eager loop keeps its warning) run the eager loop."""
        if self._broken is not None or _capturing():
            return False
        coll = self.collection
        for group in self._subset_groups:
            leader = coll._metrics[group[0]]
            if leader._to_sync and _sync.distributed_available():
                return False
            for name in group:
                m = coll._metrics[name]
                if m._is_synced or m._update_count == 0:
                    return False
        return True

    def dispatch(self) -> Tuple[bool, Any]:
        coll = self.collection
        states = {g[0]: coll._metrics[g[0]].get_state() for g in self._subset_groups}
        if not _leaves_compilable(states):
            return False, None
        return self._dispatch(states, (), {}, frozenset())


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
    update_rest: Tuple[Tuple[str, ...], ...] = ()
    compute_rest: Tuple[Tuple[str, ...], ...] = ()


class CollectionDispatcher:
    """Partition-aware dispatch for ``MetricCollection.update()/compute()``.

    The compute groups are classified into fused, bucketed and eager sets
    (re-classified whenever the members' cheap eligibility flags change). The
    fused set runs as one captured step, bucketed leaders through their own
    pow2-bucketed engines in the eager loop, and the rest eagerly. A member
    whose step turns out not to be capturable migrates to the eager set
    alone; the fused step is rebuilt over the remainder.
    """

    def __init__(self, collection: Any) -> None:
        self.collection = collection
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

    def __deepcopy__(self, memo: Dict) -> None:
        return None

    # ------------------------------------------------------------------ #
    # partition lifecycle
    # ------------------------------------------------------------------ #
    def _partition_key(self) -> Tuple:
        coll = self.collection
        parts = []
        for group in coll._groups:
            leader = coll._metrics[group[0]]
            parts.append((
                tuple(group),
                getattr(leader, "_compiled_update", None) is False,
                bool(getattr(leader, "_batch_buckets", False)),
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
        u_set, c_set = frozenset(u_fused), frozenset(c_fused)
        part = CollectionPartition(
            key=key,
            update_fused=u_fused, update_bucketed=u_bucketed, update_eager=u_eager,
            compute_fused=c_fused, compute_eager=c_eager,
            update_members=u_members, compute_members=c_members,
            update_rest=tuple(tuple(g) for g in coll._groups if g[0] not in u_set),
            compute_rest=tuple(tuple(g) for g in coll._groups if g[0] not in c_set),
        )
        self._partition = part
        self._update_engine = None
        self._compute_engine = None
        coll._update_engine = None
        coll._compute_engine = None
        self.stats.builds += 1
        if rebuild:
            self.stats.repartitions += 1
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
        for lname in self._partition.compute_fused:
            group = next(g for g in coll._groups if g[0] == lname)
            state = coll._metrics[lname].get_state()
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
        for lname in promoted:
            self._reprobing[kind].discard(lname)
            self._probation.pop((kind, lname), None)
        self.stats.repromotions += len(promoted)

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
        return res

    # ------------------------------------------------------------------ #
    # views
    # ------------------------------------------------------------------ #
    def partition_view(self) -> Dict[str, Any]:
        """The ``engine_stats()["partition"]`` payload."""
        part = self._partition
        if part is not None:
            u_members, c_members = part.update_members, part.compute_members
        else:
            u_members = _classify_update_groups(self.collection, self._migrated_update)[3]
            c_members = _classify_compute_groups(self.collection, self._migrated_compute)[2]
        return {
            "update": {name: dict(info) for name, info in u_members.items()},
            "compute": {name: dict(info) for name, info in c_members.items()},
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


def collection_partition_view(coll: Any) -> Dict[str, Any]:
    """Partition view of a collection, with or without a live dispatcher."""
    dispatcher = getattr(coll, "_dispatcher", None)
    if dispatcher is not None:
        return dispatcher.partition_view()
    return {
        "update": _classify_update_groups(coll, {})[3],
        "compute": _classify_compute_groups(coll, {})[2],
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
    return {
        "update": {"path": u_path, "reason": u_reason},
        "compute": {"path": c_path, "reason": c_reason},
        "last_fallback_exception": last_exc,
    }


def engine_stats_view(update_engine: Any, compute_engine: Any) -> Dict[str, Any]:
    """``{"update": EngineStats|None, "compute": EngineStats|None,
    "fallback_reasons": {"<kind>:<Owner>": why}}``."""
    stats: Dict[str, Any] = {
        "update": update_engine.stats if update_engine is not None else None,
        "compute": compute_engine.stats if compute_engine is not None else None,
    }
    reasons: Dict[str, str] = {}
    for kind, s in stats.items():
        if s is not None:
            for owner, why in s.fallback_reasons.items():
                reasons[f"{kind}:{owner}"] = why
    stats["fallback_reasons"] = reasons
    return stats
