"""The Metric base: a pure state protocol behind a stateful facade.

Counterpart of ``metrics_tpu/core/metric.py``: ``add_state`` with the sum,
mean, max, min and cat reduction tags, the pure ``init_state`` /
``update_state`` / ``compute_state`` / ``merge_states`` protocol, the
``update`` / ``compute`` / ``forward`` / ``reset`` facade, ``state_dict`` and
``CompositionalMetric``, the sync facade: ``sync`` / ``unsync`` /
``sync_context`` over a ``torch.distributed`` process group, which
``compute()`` runs in, with each state's declared sync transport, tolerance
and mode (``add_state(sync_transport=, sync_tolerance=, sync_mode=)``), the
incremental sync protocol (``init_incremental`` /
``update_state_incremental`` / ``finalize_incremental``), and the compiled
engines (``core/engine.py``): from the second call of each input signature,
``update()`` and ``compute()``, synced or not, replay a captured CUDA graph
(on the CPU, the same step with the value checks off). Sketch states
(``dist_reduce_fx="sketch"``, ``metrics_tpu_torch.sketches``) are one leaf of
their components everywhere: reset, moves, ``state_dict``, merges, sync and
the engines. Sharded state (``add_state(shard_axis=)``, ``shard_state`` /
``unshard_state``): each rank holds one disjoint block of a declared leaf,
every update merges the rank's dense delta into the owners' blocks with one
``reduce_scatter`` per bucket, and ``compute()`` runs the metric's
``compute_sharded_state`` on the blocks or reshards them. The observability
and resilience hooks of the JAX package sit at its sites: ``shard/place`` and
``shard/unshard`` tracer spans, the ``buffer/overflow`` event with the
``metrics_tpu_catbuffer_overflows_total`` counter, and the opt-in non-finite
guard (``resilience.guard``) after ``update()`` (quarantine rolls the state
back), after ``sync()`` and on the ``compute()`` result.

State lives on one explicit device. ``device=None`` means CUDA; without a
card the constructor raises instead of quietly running on the CPU, so CPU
callers (the tests) pass ``device="cpu"``. Inputs on another device than the
state raise.

A metric's own ``update`` rebinds its state attributes to new tensors
(``self.tp = self.tp + tp``) and never writes in place. The compiled update
engine does write in place: from its third call of a signature the state
tensors are the engine's static buffers, which each replay updates. It does so
only where the JAX engine would donate the state: never into a tensor that a
caller, a snapshot or another member of a collection compute group still
holds, and never into a registered default, so sharing a group leader's
tensors with its members by reference stays safe.
"""
from __future__ import annotations

import functools
import inspect
import weakref
from contextlib import contextmanager
from copy import deepcopy
from typing import Any, Callable, Dict, Generator, List, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch import Tensor

from metrics_tpu_torch.core.buffers import CatBuffer, ShardedCatBuffer, in_place_writes
from metrics_tpu_torch.observability import instruments as _instruments
from metrics_tpu_torch.observability import tracer as _otrace
from metrics_tpu_torch.parallel import mesh as _meshlib
from metrics_tpu_torch.parallel import sync as _sync
from metrics_tpu_torch.resilience import guard as _guard
from metrics_tpu_torch.sketches.base import MergeableSketch
from metrics_tpu_torch.sketches.base import is_sketch as _is_sketch
from metrics_tpu_torch.utils.data import _flatten, _squeeze_if_scalar
from metrics_tpu_torch.utils.exceptions import MetricsUserError
from metrics_tpu_torch.utils.prints import rank_zero_warn

StateValue = Union[Tensor, List[Tensor], CatBuffer, MergeableSketch]
StateDict = Dict[str, StateValue]
ShardAxis = Union[int, Tuple[int, ...]]

_PROTECTED_PROPERTIES = ("is_differentiable", "higher_is_better", "full_state_update")
_REDUCTIONS = ("sum", "mean", "cat", "max", "min", "sketch", None)


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """The device metric state lives on: CUDA unless the caller names another.

    Raises when CUDA is asked for (explicitly or by default) and no card is
    present, so a metric never falls back to the CPU unasked.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "metric state defaults to CUDA, but no CUDA device is available; "
                "pass device='cpu' to keep the state on the CPU"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def _copy_state_value(value: StateValue) -> StateValue:
    """A fresh leaf: tensors, buffers and sketches are cloned (so no caller
    can write into a default), lists are re-wrapped."""
    if isinstance(value, list):
        return list(value)
    if isinstance(value, CatBuffer):
        return value.copy()
    return value.clone()


def _tensors_in(value: Any):
    """Every tensor in ``value``, walking lists, tuples, dicts and buffers."""
    if isinstance(value, Tensor):
        yield value
    elif isinstance(value, CatBuffer):
        yield from (t for t in (value.data, value.count, value.overflowed) if t is not None)
    elif _is_sketch(value):
        yield from value.components().values()
    elif isinstance(value, (list, tuple)):
        for item in value:
            yield from _tensors_in(item)
    elif isinstance(value, dict):
        for item in value.values():
            yield from _tensors_in(item)


def _write_rows(block: ShardedCatBuffer, rows: Optional[Tensor], n_added: int, over_added: bool) -> ShardedCatBuffer:
    """``block`` after the global buffer appended ``rows`` (every rank's, in
    the global order) at its count: the rows this block owns are written,
    at the count clamped into the capacity as a captured append clamps it
    (the buffer never grows), and the count and sticky flag advance.
    ``n_added`` may exceed ``len(rows)`` when a placed buffer had overflowed."""
    cap, width = block.capacity, block.width
    n = block._n + n_added
    over = block._over or over_added or n > cap
    data = None if block.data is None else block.data.clone()
    if rows is not None and rows.shape[0]:
        per = cap // width
        if data is None:
            data = torch.zeros((per, *rows.shape[1:]), dtype=rows.dtype, device=rows.device)
        rows = rows[:cap]
        m = rows.shape[0]
        start = min(max(block._n, 0), cap - m)
        lo = block.index * per
        a, b = max(start, lo), min(start + m, lo + per)
        if a < b:
            data[a - lo : b - lo] = rows[a - start : b - start].to(data.dtype)
    count = block.count + n_added
    flag = block.overflowed | torch.full((), over, dtype=torch.bool, device=block.count.device)
    return ShardedCatBuffer.block(data, count, flag, n, over, block.index, width, None if data is not None else cap)


class Metric:
    """Base class for all metrics.

    Args:
        device: where the state lives. ``None`` (default) is the current CUDA
            device and raises when there is none; pass ``"cpu"`` to run on
            the CPU.
        buffer_capacity: when set, every state registered with ``default=[]``
            and ``dist_reduce_fx="cat"`` becomes a :class:`CatBuffer` of this
            many rows instead of a list; metrics with buffer states of their
            own take it as their row capacity.
        compute_on_cpu: move list and buffer states to the CPU after each
            update.
        dist_sync_on_step: sync the batch value that ``forward`` returns.
        process_group: the ``torch.distributed`` group to sync over; by
            default the group of :func:`~metrics_tpu_torch.parallel.sync_axes`,
            else the default group when it has more than one rank.
        dist_sync_fn: ``fn(state, reductions, group) -> state`` in place of
            :func:`~metrics_tpu_torch.parallel.sync_state`.
        sync_on_compute: sync the state in ``compute()`` (default True).
            A metric placed by :meth:`shard_state` syncs over its placement
            in ``compute()`` and ``forward`` whatever this and
            ``dist_sync_on_step`` say: its blocks are not its value.
        compiled_update: dispatch ``update()`` through the compiled-update
            engine (a captured step per input signature; see
            :mod:`metrics_tpu_torch.core.engine`). ``None`` (default) follows
            :func:`~metrics_tpu_torch.set_compiled_update`.
        compiled_compute: the same for ``compute()`` (``None`` follows
            :func:`~metrics_tpu_torch.set_compiled_compute`).
        donate_state: let the compiled update write the state in place
            (default True); ``False`` hands out fresh state tensors every call.
        batch_buckets: pad ragged batches to a power of two with a
            ``sample_mask`` (metrics whose update takes one), else split them
            into power-of-two chunks, so at most log2(N) steps are captured.

    Example (a custom metric):
        >>> import torch
        >>> from metrics_tpu_torch import Metric
        >>> class SumOfInputs(Metric):
        ...     full_state_update = False
        ...     def __init__(self, **kwargs):
        ...         super().__init__(**kwargs)
        ...         self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")
        ...     def update(self, x):
        ...         self.total = self.total + x.sum()
        ...     def compute(self):
        ...         return self.total
        >>> metric = SumOfInputs(device="cpu")
        >>> metric.update(torch.tensor([1.0, 2.0]))
        >>> float(metric.compute())
        3.0
    """

    is_differentiable: Optional[bool] = None
    higher_is_better: Optional[bool] = None
    # update-determined Python config (``Accuracy.mode``, ``ROC.num_classes``)
    # that a checkpoint carries beside the state (``checkpoint.format.metric_aux``)
    _ckpt_aux_attrs: Tuple[str, ...] = ()
    full_state_update: Optional[bool] = True

    def __init__(
        self,
        device: Optional[Union[str, torch.device]] = None,
        buffer_capacity: Optional[int] = None,
        compute_on_cpu: bool = False,
        dist_sync_on_step: bool = False,
        process_group: Optional[dist.ProcessGroup] = None,
        dist_sync_fn: Optional[Callable] = None,
        sync_on_compute: bool = True,
        compiled_update: Optional[bool] = None,
        compiled_compute: Optional[bool] = None,
        donate_state: bool = True,
        batch_buckets: bool = False,
        **kwargs: Any,
    ) -> None:
        if kwargs:
            raise ValueError(f"Unexpected keyword arguments: {list(kwargs)}")
        if compiled_update is not None and not isinstance(compiled_update, bool):
            raise ValueError(f"Expected keyword argument `compiled_update` to be a `bool` or None but got {compiled_update}")
        if compiled_compute is not None and not isinstance(compiled_compute, bool):
            raise ValueError(f"Expected keyword argument `compiled_compute` to be a `bool` or None but got {compiled_compute}")
        if not isinstance(donate_state, bool):
            raise ValueError(f"Expected keyword argument `donate_state` to be a `bool` but got {donate_state}")
        if not isinstance(batch_buckets, bool):
            raise ValueError(f"Expected keyword argument `batch_buckets` to be a `bool` but got {batch_buckets}")
        if buffer_capacity is not None and (not isinstance(buffer_capacity, int) or buffer_capacity <= 0):
            raise ValueError(f"Expected keyword argument `buffer_capacity` to be a positive int but got {buffer_capacity}")
        if not isinstance(compute_on_cpu, bool):
            raise ValueError(f"Expected keyword argument `compute_on_cpu` to be a `bool` but got {compute_on_cpu}")
        if not isinstance(dist_sync_on_step, bool):
            raise ValueError(f"Expected keyword argument `dist_sync_on_step` to be a `bool` but got {dist_sync_on_step}")
        if dist_sync_fn is not None and not callable(dist_sync_fn):
            raise ValueError(f"Expected keyword argument `dist_sync_fn` to be callable or None but got {dist_sync_fn}")
        self.buffer_capacity = buffer_capacity
        self.compute_on_cpu = compute_on_cpu
        self.dist_sync_on_step = dist_sync_on_step
        self.process_group = process_group
        self.dist_sync_fn = dist_sync_fn
        self.sync_on_compute = sync_on_compute
        self._compiled_update = compiled_update
        self._compiled_compute = compiled_compute
        self._donate_state = donate_state
        self._batch_buckets = batch_buckets
        self._update_engine: Any = None  # lazily built CompiledUpdateEngine
        self._compute_engine: Any = None  # lazily built CompiledComputeEngine
        self._shared_state_ids: frozenset = frozenset()  # tensors shared across a collection group
        self._states_detached = False  # a fused collection streak removed the state attributes
        self._default_refs: Tuple = ()  # the default copies reset() handed out (weakly)
        self._buffer_states: Tuple[str, ...] = ()  # the CatBuffer states, whose overflow is surfaced
        self._overflow_reported: set = set()
        self._device = resolve_device(device)
        self._defaults: Dict[str, StateValue] = {}
        self._persistent: Dict[str, bool] = {}
        self._reductions: Dict[str, Optional[Union[str, Callable]]] = {}
        # declared sync transports, tolerances and modes: configuration, not
        # state (they change how and when sync bytes cross, not the values)
        self._sync_transports: Dict[str, str] = {}
        self._sync_tolerances: Dict[str, float] = {}
        self._sync_modes: Dict[str, str] = {}
        # declared shard axes, and the placement shard_state() made: the
        # (mesh, axis names), the group a sync over it runs on, and each
        # sharded leaf's unsharded default (dense: shape, dtype and the tensor
        # where a zero fill would not restore it)
        self._shard_axes: Dict[str, ShardAxis] = {}
        self._state_sharding: Optional[Tuple[Any, Union[str, Tuple[str, ...]]]] = None
        self._sync_placement: Any = None
        self._shard_templates: Dict[str, Any] = {}
        self._update_count = 0
        self._forward_cache: Any = None
        self._computed: Any = None
        self._to_sync = sync_on_compute
        self._should_unsync = True
        self._is_synced = False
        self._cache: Optional[StateDict] = None

        # wrap the subclass update/compute with bookkeeping
        self.update: Callable = self._wrap_update(self.update)  # type: ignore[method-assign]
        self.compute: Callable = self._wrap_compute(self.compute)  # type: ignore[method-assign]

    # ------------------------------------------------------------------ #
    # state registry
    # ------------------------------------------------------------------ #
    def add_state(
        self,
        name: str,
        default: StateValue,
        dist_reduce_fx: Optional[Union[str, Callable]] = None,
        persistent: bool = False,
        bufferable: Optional[bool] = None,
        shard_axis: Optional[ShardAxis] = None,
        sync_transport: Optional[str] = None,
        sync_tolerance: Optional[float] = None,
        sync_mode: Optional[str] = None,
    ) -> None:
        """Register a state variable.

        ``default`` is a tensor (fixed-shape state, moved to the metric's
        device), an empty list (a ``cat`` list), a :class:`CatBuffer` (a
        ``cat`` buffer of fixed item shape) or a
        :class:`~metrics_tpu_torch.sketches.MergeableSketch`.
        ``dist_reduce_fx`` is one of ``"sum"|"mean"|"max"|"min"|"cat"``, a
        callable applied to the stacked values, None (keep every value), or
        ``"sketch"``, which a sketch default requires and which requires one
        (the sketch's own merge is the reduction). With ``buffer_capacity``
        set, an empty-list state that is *bufferable* becomes a buffer of that
        capacity: one consumed as a flat dim-0 concatenation. ``bufferable``
        defaults to ``dist_reduce_fx == "cat"``; flat ``None``-reduce lists
        (retrieval's) pass ``bufferable=True``.

        ``sync_transport`` declares how the state's sync bucket crosses the
        wire: ``"exact"`` (the default), ``"bf16"``, ``"int8"`` or
        ``"sparse_count"`` (:mod:`metrics_tpu_torch.parallel.sync`). It wins
        over :func:`~metrics_tpu_torch.set_sync_transport` but never over the
        error-budget gate, which falls back to exact when the predicted
        error exceeds ``sync_tolerance``, the state's relative budget (unset:
        the transport's default; the tightest in a bucket wins).
        ``sync_mode`` is ``"deferred"`` (sync at ``compute()``) or
        ``"incremental"`` (emissions during the streak, through the
        incremental protocol); it wins over
        :func:`~metrics_tpu_torch.set_sync_mode` in both directions, and only
        dense elementwise states can take emissions. All three are
        configuration, not state.

        ``shard_axis`` declares the state shardable along that dimension (the
        class axis of a confusion matrix, the sample axis of a
        :class:`CatBuffer`, which may only declare ``0``), or along a tuple of
        distinct dimensions (a grid). The declaration is inert until
        :meth:`shard_state` places the leaf as one block per rank.
        """
        if (
            not isinstance(default, (Tensor, CatBuffer))
            and not _is_sketch(default)
            and not (isinstance(default, list) and default == [])
        ):
            raise ValueError("state variable must be a tensor, an empty list, a CatBuffer or a MergeableSketch")
        if dist_reduce_fx not in _REDUCTIONS and not callable(dist_reduce_fx):
            raise ValueError(
                "`dist_reduce_fx` must be callable or one of ['mean', 'sum', 'cat', 'min', 'max', 'sketch', None]"
            )
        if _is_sketch(default) != (dist_reduce_fx == "sketch"):
            raise ValueError(
                f"state {name!r}: MergeableSketch defaults require dist_reduce_fx='sketch' "
                "and vice versa (the sketch's own merge is the reduction)"
            )
        if isinstance(default, CatBuffer) and dist_reduce_fx != "cat":
            raise ValueError(f"state {name!r}: a CatBuffer default needs dist_reduce_fx='cat'")
        if isinstance(default, list) and self.buffer_capacity is not None:
            if not (dist_reduce_fx == "cat" if bufferable is None else bufferable):
                raise MetricsUserError(
                    f"{type(self).__name__} does not support `buffer_capacity`: state {name!r} is "
                    "a list of per-element entries (not a flat dim-0 concatenation), so it cannot "
                    "be stored in a fixed-capacity CatBuffer. Remove the `buffer_capacity` argument."
                )
            default = CatBuffer.empty(self.buffer_capacity)
        if isinstance(default, (Tensor, CatBuffer)) or _is_sketch(default):
            default = default.to(self._device)
        if shard_axis is not None:
            self._shard_axes[name] = self._checked_shard_axis(name, default, shard_axis)
        if sync_transport is not None:
            if sync_transport not in _sync.TRANSPORTS:
                raise ValueError(
                    f"state {name!r}: unknown sync_transport {sync_transport!r}; expected one of {_sync.TRANSPORTS}"
                )
            self._sync_transports[name] = sync_transport
        if sync_tolerance is not None:
            sync_tolerance = float(sync_tolerance)
            if sync_tolerance < 0.0:
                raise ValueError(f"state {name!r}: sync_tolerance must be >= 0, got {sync_tolerance}")
            self._sync_tolerances[name] = sync_tolerance
        if sync_mode is not None:
            if sync_mode not in _sync.SYNC_MODES:
                raise ValueError(f"state {name!r}: unknown sync_mode {sync_mode!r}; expected one of {_sync.SYNC_MODES}")
            self._sync_modes[name] = sync_mode
        if isinstance(default, CatBuffer) and name not in self._buffer_states:
            self._buffer_states = self._buffer_states + (name,)
        self._defaults[name] = _copy_state_value(default)
        self._persistent[name] = persistent
        self._reductions[name] = dist_reduce_fx
        setattr(self, name, _copy_state_value(default))
        self._mark_default_copies()

    @staticmethod
    def _checked_shard_axis(name: str, default: StateValue, shard_axis: Any) -> ShardAxis:
        """``shard_axis`` validated against the default, as the JAX package
        validates it."""
        if _is_sketch(default):
            raise ValueError(f"state {name!r}: sketch states are fixed-size and stay replicated; "
                             "`shard_axis` is not supported")
        if isinstance(shard_axis, (tuple, list)):
            shard_axis = tuple(shard_axis)
            if not shard_axis or not all(isinstance(a, int) for a in shard_axis):
                raise ValueError(f"`shard_axis` tuple must be non-empty ints but got {shard_axis!r}")
        elif not isinstance(shard_axis, int):
            raise ValueError(f"`shard_axis` must be an int, a tuple of ints, or None but got {shard_axis!r}")
        if isinstance(default, list):
            raise ValueError(
                f"state {name!r}: unbounded list states cannot declare `shard_axis` "
                "(construct the metric with `buffer_capacity=N` for a shardable CatBuffer)"
            )
        if isinstance(default, CatBuffer) and shard_axis != 0:
            raise ValueError(
                f"state {name!r}: CatBuffer states shard along the sample axis only (shard_axis=0), got {shard_axis}"
            )
        if isinstance(default, Tensor):
            if default.ndim == 0:
                raise ValueError(f"state {name!r}: scalar states cannot declare `shard_axis`")
            axes = shard_axis if isinstance(shard_axis, tuple) else (shard_axis,)
            for a in axes:
                if not -default.ndim <= a < default.ndim:
                    raise ValueError(f"state {name!r}: shard_axis {a} out of range for default of rank {default.ndim}")
            if len({a % default.ndim for a in axes}) != len(axes):
                raise ValueError(f"state {name!r}: shard_axis tuple {shard_axis!r} names the same array axis twice")
        return shard_axis

    @property
    def metric_state(self) -> StateDict:
        """Current state values keyed by registered name."""
        return {attr: getattr(self, attr) for attr in self._defaults}

    # ------------------------------------------------------------------ #
    # sharded state: placement over a mesh of ranks
    # ------------------------------------------------------------------ #
    @property
    def shard_axes(self) -> Dict[str, ShardAxis]:
        """Declared shardable state axes (name -> axis or axes), active or not."""
        return dict(self._shard_axes)

    @property
    def active_shard_axes(self) -> Dict[str, ShardAxis]:
        """The shard axes in effect: empty until :meth:`shard_state`. A
        declaration alone changes nothing: an unplaced leaf holds the rank's
        partial value, which a sync sums; a placed one holds a disjoint block
        of the global value, which a sync gathers."""
        return dict(self._shard_axes) if self._state_sharding is not None else {}

    @property
    def state_sharding(self) -> Optional[Tuple[Any, Union[str, Tuple[str, ...]]]]:
        """The ``(mesh, axis_name)`` placement of :meth:`shard_state`, or None."""
        return self._state_sharding

    @property
    def _sharded(self) -> bool:
        return self._state_sharding is not None and bool(self._shard_axes)

    def _leaf_sharding(self, name: str, val: Any, placement: Optional[Tuple[Any, Any]] = None) -> "_meshlib.NamedSharding":
        """The placement spec of one sharded leaf (under ``placement``,
        default: the active one)."""
        mesh, axis_name = placement or self._state_sharding  # type: ignore[misc]
        if isinstance(val, CatBuffer):
            first = axis_name[0] if isinstance(axis_name, tuple) else axis_name
            return _meshlib.sample_sharded(mesh, first)
        return _meshlib.shard_spec(mesh, self._shard_axes[name], val.ndim, axis_name)

    def _leaf_splits(self, name: str, ndim: int, placement: Optional[Tuple[Any, Any]] = None) -> List[Tuple[int, str]]:
        """``(array axis, mesh axis name)`` of each split of a sharded leaf."""
        spec = self._leaf_sharding(name, torch.empty((0,) * ndim), placement).spec
        return [(axis, mesh_axis) for axis, mesh_axis in enumerate(spec) if mesh_axis is not None]

    def _own_block(self, name: str, full: Tensor) -> Tensor:
        """This rank's block of a whole leaf."""
        mesh = self._state_sharding[0]  # type: ignore[index]
        for axis, mesh_axis in self._leaf_splits(name, full.ndim):
            size = full.shape[axis] // mesh.axis_size(mesh_axis)
            full = full.narrow(axis, mesh.axis_index(mesh_axis) * size, size)
        return full.clone()

    def shard_state(self, mesh: Any = None, axis_name: Union[str, Tuple[str, ...]] = "data") -> "Metric":
        """Place every ``shard_axis``-declared leaf as one block per rank of ``mesh``.

        Each rank's leaf (its partial value) becomes its disjoint block of
        the global value, the ranks' sum (one ``reduce_scatter`` per bucket;
        ``max``/``min`` leaves reduce by that op); the defaults become blocks
        too, so ``reset()`` keeps the placement. From then on every update
        merges the rank's delta into the owners' blocks, and ``compute()``
        syncs over the placement's group, through :meth:`compute_sharded_state`
        or a reshard. Every rank must update the same number of times.

        ``mesh=None`` is a 1-D mesh named ``axis_name`` over the default
        group. A tuple ``axis_name`` pairs the axes of a tuple ``shard_axis``
        with mesh axes positionally (an int ``shard_axis`` splits over the
        first); it names every axis of the mesh, in its order. A dimension
        the mesh axis does not divide raises ``ValueError`` (no padding: the JAX
        package's ``device_put`` refuses it too), and a sharded dense leaf
        whose reduction is not ``sum``, ``max`` or ``min`` raises
        ``NotImplementedError``. The engines are dropped. Returns ``self``.
        """
        names = axis_name if isinstance(axis_name, tuple) else (axis_name,)
        if not names or not all(isinstance(n, str) for n in names):
            raise ValueError(f"`axis_name` must be a mesh-axis name or non-empty tuple of names, got {axis_name!r}")
        if mesh is None:
            if len(names) != 1:
                raise ValueError("shard_state: a multi-axis placement needs an explicit mesh (see make_mesh)")
            mesh = _meshlib.data_parallel_mesh(axis_name=names[0])
        for n in names:
            if n not in mesh.axis_names:
                raise ValueError(f"axis {n!r} is not an axis of the mesh {mesh.axis_names}")
        max_rank = max((len(a) for a in self._shard_axes.values() if isinstance(a, tuple)), default=1)
        if max_rank > len(names):
            raise ValueError(
                f"a state declares {max_rank} shard axes but shard_state received only {len(names)} mesh axis "
                f"name(s) {names!r}"
            )
        if names != mesh.axis_names:
            raise ValueError(
                f"shard_state: the axis names {names!r} must name every axis of the mesh {mesh.axis_names} once, in "
                "its order (the ranks along a left-out axis would hold partial copies of each block)"
            )
        if not self._shard_axes:
            rank_zero_warn(
                f"{type(self).__name__}.shard_state: no state declares a `shard_axis`; state stays fully replicated.",
                UserWarning,
            )
        if self._state_sharding is not None:
            self.unshard_state()
        t0_us = _otrace._now_us() if _otrace.active else 0
        placement = (mesh, axis_name)
        for name in self._shard_axes:
            default, red = self._defaults[name], self._reductions[name]
            if isinstance(default, CatBuffer):
                splits, dims = [(0, names[0])], [default.capacity]
            elif red not in ("sum", "max", "min"):
                raise NotImplementedError(
                    f"state {name!r}: a sharded leaf merges its updates by sum, max or min; its reduction is {red!r}"
                )
            else:
                splits = self._leaf_splits(name, default.ndim, placement)
                dims = [default.shape[a] for a, _ in splits]
            for (axis, mesh_axis), dim in zip(splits, dims):
                if dim % mesh.axis_size(mesh_axis):
                    raise ValueError(
                        f"state {name!r}: dimension {axis} of size {dim} does not divide over the "
                        f"{mesh.axis_size(mesh_axis)} ranks of mesh axis {mesh_axis!r}"
                    )
        self._state_sharding = placement
        self._sync_placement = mesh.group(names[0]) if len(names) == 1 else mesh
        state = self.get_state()
        for name in self._shard_axes:
            default, red = self._defaults[name], self._reductions[name]
            if isinstance(default, CatBuffer):
                self._shard_templates[name] = default.copy()
                self._defaults[name] = self._empty_block(default)
                continue
            keep = red != "sum" or bool(default.any())
            self._shard_templates[name] = (tuple(default.shape), default.dtype, default.clone() if keep else None)
            self._defaults[name] = self._own_block(name, default)
        self._place_partials(state)
        self._after_placement()
        if _otrace.active:
            _otrace.emit_complete("shard/place", "shard", t0_us, _otrace._now_us() - t0_us,
                                  owner=type(self).__name__, leaves=len(self._shard_axes), axis=axis_name)
        return self

    def unshard_state(self) -> "Metric":
        """Undo :meth:`shard_state`: every rank gathers each sharded leaf's
        blocks (one ``"reshard"`` tick per leaf, billed at the whole leaf's
        bytes). The whole leaf is then the global value, which rank 0 of
        the placement keeps as its partial while the others keep the
        identity (zeros; ``max``/``min`` leaves keep it on every rank, and
        buffers their global overflow flag), so a later synced ``compute()``
        returns what it returned before."""
        if self._state_sharding is None:
            return self
        t0_us = _otrace._now_us() if _otrace.active else 0
        for name, partial in self._unsharded_partials().items():
            setattr(self, name, partial)
            self._defaults[name] = self._unplaced_default(name)
        self._state_sharding = None
        self._sync_placement = None
        self._shard_templates = {}
        self._after_placement()
        if _otrace.active:
            _otrace.emit_complete("shard/unshard", "shard", t0_us, _otrace._now_us() - t0_us,
                                  owner=type(self).__name__, leaves=len(self._shard_axes))
        return self

    def _unplaced_default(self, name: str) -> StateValue:
        """The registered default of a placed leaf before its placement."""
        template = self._shard_templates[name]
        if isinstance(template, CatBuffer):
            return template
        shape, dtype, tensor = template
        return tensor if tensor is not None else torch.zeros(shape, dtype=dtype, device=self._device)

    def _unplaced_init_state(self) -> StateDict:
        """``init_state`` of the unplaced metric: a placed leaf at its whole
        default (what a rank that restores no shard starts from)."""
        state = self.init_state()
        for name in self._shard_templates:
            state[name] = _copy_state_value(self._unplaced_default(name))
        return state

    def _unsharded_partials(self) -> Dict[str, Any]:
        """Each sharded leaf as this rank's partial of the unplaced state: the
        gathered global value on the placement's rank 0, the identity on the
        others (``max``/``min`` leaves keep the global value everywhere;
        buffers their global overflow flag). A collective of every rank of
        the placement; what :meth:`unshard_state` leaves and a checkpoint
        saves."""
        whole = _sync._axis_groups(self._sync_placement)[0]
        keeper = dist.get_rank(whole) == 0
        out: Dict[str, Any] = {}
        for name in self._shard_axes:
            val, red = getattr(self, name), self._reductions[name]
            full = self._gather_block(name, val)
            if isinstance(val, ShardedCatBuffer):
                if not keeper and full.materialized:
                    full = CatBuffer._from_parts(torch.zeros_like(full.data), torch.zeros_like(full.count),
                                                 full.overflowed, 0, full._over)
            elif not keeper and red == "sum":
                full = torch.zeros_like(full)
            out[name] = full
        return out

    def _place_partials(self, partials: StateDict) -> None:
        """Set each sharded leaf to this rank's block of the ranks' partials
        (their sum, or ``max``/``min``; buffers' rows in rank order): one
        ``reduce_scatter`` per dense bucket, a gather per buffer. A
        collective of every rank; :meth:`shard_state` and a checkpoint
        restore place through it."""
        dense = []
        for name, axis in self._shard_axes.items():
            default, red = self._defaults[name], self._reductions[name]
            if isinstance(default, CatBuffer):
                setattr(self, name, self._place_rows(default, partials[name]))
                continue
            identity = default if red != "sum" else torch.zeros_like(default)
            dense.append((name, identity, partials[name], axis, red))
        if dense:
            for name, block in _sync.reduce_scatter_merge(dense, self._sync_placement).items():
                setattr(self, name, block)

    def _after_placement(self) -> None:
        """A placement change: the engines' steps bind the old shapes."""
        self._update_engine = None
        self._compute_engine = None
        self._computed = None
        self._mark_default_copies()
        self._invalidate_dispatch()

    def _gather_block(self, name: str, val: Any) -> Any:
        """The whole leaf of a sharded block, gathered untallied, with one
        ``"reshard"`` tick at the whole leaf's bytes."""
        mesh = self._state_sharding[0]  # type: ignore[index]
        if isinstance(val, ShardedCatBuffer):
            if not val.materialized:
                return CatBuffer(None, 0, val.capacity, self._device)
            with _sync._muted():
                full = val.gather(mesh.group(self._leaf_sharding(name, val).spec[0]))
            _sync._tick("reshard", full.data.numel() * full.data.element_size())
            return full
        with _sync._muted():
            for axis, mesh_axis in self._leaf_splits(name, val.ndim):
                val = torch.cat(_sync._all_gather(val, mesh.group(mesh_axis)), dim=axis)
        _sync._tick("reshard", val.numel() * val.element_size())
        return val

    def _empty_block(self, buf: CatBuffer) -> ShardedCatBuffer:
        """An empty block of a buffer's placement (materialized when the
        buffer is)."""
        mesh, axis_name = self._state_sharding  # type: ignore[misc]
        first = axis_name[0] if isinstance(axis_name, tuple) else axis_name
        width, index = mesh.axis_size(first), mesh.axis_index(first)
        count = torch.zeros((), dtype=torch.int32, device=self._device)
        over = torch.zeros((), dtype=torch.bool, device=self._device)
        data = None
        if buf.materialized:
            data = torch.zeros((buf.capacity // width, *buf.data.shape[1:]), dtype=buf.data.dtype, device=self._device)
        return ShardedCatBuffer.block(data, count, over, 0, False, index, width, None if data is not None else buf.capacity)

    def _place_rows(self, block: ShardedCatBuffer, buf: CatBuffer) -> ShardedCatBuffer:
        """``block`` with the rows of every rank's ``buf`` appended (rank
        major); the counts and overflow flags add and or across ranks."""
        whole = _sync._axis_groups(self._sync_placement)[0]
        meta = torch.tensor([len(buf), int(buf.overflow_seen), int(buf.materialized)], device=self._device)
        n_all, over_all, materialized = torch.stack(_sync._all_gather(meta, whole)).sum(dim=0).tolist()
        if not n_all:
            return _write_rows(block, None, 0, bool(over_all))
        if materialized < dist.get_world_size(whole):
            raise MetricsUserError(
                "shard_state: a buffer that some ranks have appended to and others have not cannot be placed "
                "(its item shape is unknown on the others); place it before the first update"
            )
        rows = buf.data[: min(len(buf), buf.capacity)]
        return _write_rows(block, _sync._gather_ragged([rows], whole, ["buffer"])[0], n_all, bool(over_all))

    def _append_sharded_rows(self, name: str, block: ShardedCatBuffer, delta: CatBuffer) -> ShardedCatBuffer:
        """One update's rows of a sample-sharded buffer: every rank's rows,
        gathered in rank order (a shape exchange, then one ``all_gather``),
        appended at the global count; this rank keeps the rows it owns."""
        whole = _sync._axis_groups(self._sync_placement)[0]
        if delta.materialized:
            rows = delta.data[: len(delta)]
        elif block.materialized:
            rows = block.data[:0]
        else:
            raise MetricsUserError(
                f"state {name!r}: the first sharded update appended no rows on this rank, so the buffer's item shape "
                "is unknown here; give every rank rows in the first update"
            )
        gathered = _sync._gather_ragged([rows], whole, [name])[0]
        return _write_rows(block, gathered, gathered.shape[0], False)

    def _delta_base(self, name: str, block: Tensor) -> Tensor:
        """The whole-leaf identity the delta of an update starts from: zeros
        for a sum, the unsharded default for ``max``/``min``."""
        shape, dtype, tensor = self._shard_templates[name]
        if self._reductions[name] != "sum":
            return tensor.clone()
        return torch.zeros(shape, dtype=dtype, device=block.device)

    def _sharded_update_state(self, state: StateDict, args: Tuple, kwargs: Dict) -> StateDict:
        """One update of a placed metric: the metric's own update on an
        identity copy of each sharded leaf (a whole-size delta; an empty
        buffer for a sample-sharded one) beside the replicated leaves as they
        are, then the deltas merged into this rank's blocks
        (:func:`~metrics_tpu_torch.parallel.sync.reduce_scatter_merge`)."""
        active = self.active_shard_axes
        work = dict(state)
        for name in active:
            val = state[name]
            if isinstance(val, ShardedCatBuffer):
                work[name] = CatBuffer(None, 0, val.capacity, self._device)
            else:
                work[name] = self._delta_base(name, val)
        new = self._local_update_state(work, args, kwargs)
        dense = [(name, state[name], new[name], axis, self._reductions[name])
                 for name, axis in active.items() if not isinstance(state[name], CatBuffer)]
        if dense:
            new.update(_sync.reduce_scatter_merge(dense, self._sync_placement))
        for name in active:
            if isinstance(state[name], ShardedCatBuffer):
                new[name] = self._append_sharded_rows(name, state[name], new[name])
        return new

    def _sharded_update_host_read(self) -> Optional[str]:
        """Why an update of this placement cannot be captured, or None."""
        for name in self.active_shard_axes:
            if isinstance(self._defaults[name], CatBuffer):
                return (f"the sample-sharded update of CatBuffer state {name!r} exchanges the ranks' row counts "
                        "through the host")
        return None

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def sync_transports(self) -> Dict[str, str]:
        """Declared per-state sync transports (name -> transport)."""
        return dict(self._sync_transports)

    @property
    def sync_tolerances(self) -> Dict[str, float]:
        """Declared per-state sync error tolerances (name -> relative budget)."""
        return dict(self._sync_tolerances)

    @property
    def sync_modes(self) -> Dict[str, str]:
        """Declared per-state sync modes (name -> mode); undeclared states
        follow :func:`~metrics_tpu_torch.parallel.sync_mode_default`."""
        return dict(self._sync_modes)

    # ------------------------------------------------------------------ #
    # pure functional protocol
    # ------------------------------------------------------------------ #
    def init_state(self) -> StateDict:
        """Fresh state from the registered defaults."""
        return {k: _copy_state_value(v) for k, v in self._defaults.items()}

    def reset_state(self, state: StateDict, mask: Optional[Tensor] = None) -> StateDict:
        """Pure reset: ``state`` restored to the registered defaults.

        With ``mask=None`` this is ``init_state`` over the incoming state's
        structure: a materialized :class:`CatBuffer` comes back as zeros of
        its own shape and capacity, empty, with its overflow flag clear.
        With a 1-D bool ``mask`` of length N the state is tenant-stacked
        along a leading axis of N rows and only the rows where ``mask`` is
        True are restored: a ``torch.where`` per leaf (per component of a
        sketch), so one captured step serves every occupancy and the other
        rows keep their bits (:mod:`metrics_tpu_torch.tenancy`). The masked
        form needs dense fixed-shape leaves.
        """
        if mask is not None:
            return self._masked_reset_state(state, mask)
        out: StateDict = {}
        for attr, default in self._defaults.items():
            cur = state.get(attr)
            if isinstance(cur, ShardedCatBuffer) and cur.materialized:
                out[attr] = cur._like(torch.zeros_like(cur.data), torch.zeros_like(cur.count),
                                      torch.zeros_like(cur.overflowed))
                out[attr]._n, out[attr]._over = 0, False
            elif isinstance(cur, CatBuffer) and cur.materialized:
                out[attr] = CatBuffer(torch.zeros_like(cur.data), 0)
            elif isinstance(cur, list):
                out[attr] = []
            else:
                out[attr] = _copy_state_value(default)
        return out

    def _masked_reset_state(self, state: StateDict, mask: Tensor) -> StateDict:
        if not isinstance(mask, Tensor) or mask.dtype != torch.bool or mask.ndim != 1:
            raise MetricsUserError(
                f"{type(self).__name__}.reset_state: mask must be a 1-D boolean tensor over the leading (tenant)"
                f" axis, got {getattr(mask, 'shape', None)} {getattr(mask, 'dtype', type(mask).__name__)}."
            )

        def restore(arr: Tensor, default: Tensor) -> Tensor:
            sel = mask.reshape((-1,) + (1,) * (arr.ndim - 1))
            return torch.where(sel, default.to(device=arr.device, dtype=arr.dtype), arr)

        out: StateDict = {}
        for attr, default in self._defaults.items():
            cur = state[attr]
            if isinstance(cur, (CatBuffer, list, tuple)):
                raise MetricsUserError(
                    f"{type(self).__name__}.reset_state: state {attr!r} is a {type(cur).__name__} — masked"
                    " (tenant-stacked) reset needs dense fixed-shape array leaves; this metric is not"
                    " tenant-stackable."
                )
            if _is_sketch(cur):
                out[attr] = cur.replace(**{
                    f: restore(getattr(cur, f), d) for f, d in default.components().items()
                })
            else:
                out[attr] = restore(cur, default)
        return out

    def get_state(self) -> StateDict:
        return {k: getattr(self, k) for k in self._defaults}

    def set_state(self, state: StateDict) -> None:
        for k, v in state.items():
            setattr(self, k, list(v) if isinstance(v, list) else v)
        if self._states_detached and all(k in self.__dict__ for k in self._defaults):
            self._states_detached = False

    def _mark_default_copies(self) -> None:
        """Remember the state tensors that stand for the registered defaults
        (what ``reset()`` and ``add_state`` hand out): the compiled update
        never writes them in place, as the JAX engine never donates a default."""
        self._default_refs = tuple(weakref.ref(t) for k in self._defaults for t in _tensors_in(self.__dict__.get(k)))

    def _reset_leaf_ids(self) -> set:
        return {id(t) for t in (ref() for ref in self._default_refs) if t is not None}

    def _detach_states(self) -> None:
        """Remove the state attributes while this metric is a non-leader
        member of a collection compute group in a fused update streak (only
        its leader advances); a read then raises instead of returning stale
        state. ``set_state`` and ``reset`` attach them again."""
        for key in self._defaults:
            self.__dict__.pop(key, None)
        self._states_detached = True

    def __getattr__(self, name: str) -> Any:
        # reached only when normal lookup fails: a detached state attribute
        d = object.__getattribute__(self, "__dict__")
        if d.get("_states_detached") and name in d.get("_defaults", ()):
            raise MetricsUserError(
                f"{type(self).__name__}.{name} was read while its state is detached: this metric is a non-leader"
                " member of a MetricCollection compute group in a fused update streak, so its state is attached"
                " again at the collection's next compute()/items()/values()/[]. Read results through the collection."
            )
        raise AttributeError(f"{type(self).__name__!r} object has no attribute {name!r}")

    def _child_metrics(self) -> List["Metric"]:
        """Metric instances held as attributes (a CompositionalMetric's
        operands): their state lives outside ``_defaults``."""
        out: List[Metric] = []
        for val in vars(self).values():
            if isinstance(val, Metric):
                out.append(val)
            elif isinstance(val, (list, tuple)):
                out.extend(v for v in val if isinstance(v, Metric))
        return out

    @property
    def supports_compiled_update(self) -> bool:
        """True when no state is an unbounded list, so ``update_state`` may be
        captured (the JAX engine's static gate)."""
        return not any(isinstance(v, list) for v in self._defaults.values())

    @property
    def supports_compiled_compute(self) -> bool:
        """True when no state is an unbounded list; a compute that turns out
        not to be capturable is found by the engine's probe."""
        return not any(isinstance(v, list) for v in self._defaults.values())

    def update_state(self, state: StateDict, *args: Any, **kwargs: Any) -> StateDict:
        """Pure: return ``state`` advanced by one batch. The stateful
        ``update`` and this function share one implementation. Buffers are
        copied first, since appends write into them in place; in the body of
        a captured step they are the step's own static buffers and are
        appended to as they are (``buffers.writes_in_place``). Under an
        active placement the sharded leaves are blocks and the update merges
        into them over the placement's group (:meth:`shard_state`): a
        collective that every rank must run."""
        if self._sharded:
            return self._sharded_update_state(state, args, kwargs)
        return self._local_update_state(state, args, kwargs)

    def _local_update_state(self, state: StateDict, args: Tuple, kwargs: Dict) -> StateDict:
        prev = self.get_state()
        in_place = in_place_writes()
        try:
            self.set_state({
                k: (v._alias() if in_place else v.copy()) if isinstance(v, CatBuffer) else v for k, v in state.items()
            })
            self._check_input_devices(args, kwargs)
            self._update(*args, **kwargs)
            return self.get_state()
        finally:
            self.set_state(prev)

    def compute_state(self, state: StateDict) -> Any:
        """Pure: metric value from a state (no cache)."""
        prev = self.get_state()
        try:
            self.set_state(state)
            return self._compute()
        finally:
            self.set_state(prev)

    def merge_states(self, state: StateDict, incoming: StateDict, update_counts: Tuple[int, int] = (1, 1)) -> StateDict:
        """Pure cross-batch merge by reduction tag."""
        n_a, n_b = update_counts
        out: StateDict = {}
        for attr in self._defaults:
            a, b = state[attr], incoming[attr]
            reduce_fn = self._reductions[attr]
            if reduce_fn == "sum":
                out[attr] = a + b
            elif reduce_fn == "mean":
                out[attr] = (n_a * a + n_b * b) / max(n_a + n_b, 1)
            elif reduce_fn == "max":
                out[attr] = torch.maximum(a, b)
            elif reduce_fn == "min":
                out[attr] = torch.minimum(a, b)
            elif reduce_fn == "sketch":
                out[attr] = a.merge(b)
            elif isinstance(a, CatBuffer):
                out[attr] = a.merge(b)
            elif reduce_fn == "cat":
                out[attr] = list(a) + list(b) if isinstance(a, list) else torch.cat([torch.atleast_1d(a), torch.atleast_1d(b)])
            elif reduce_fn is None and isinstance(a, list):
                out[attr] = _flatten([list(a), list(b)])
            elif reduce_fn is None:
                out[attr] = torch.stack([a, b])
            else:
                out[attr] = reduce_fn(torch.stack([a, b]))
        return out

    def sync_states(self, state: StateDict, group: Any, keep_sharded: bool = False) -> StateDict:
        """Pure: ``state`` synced over ``group`` by reduction tag (bucketed
        by ``(reduction, dtype, transport)`` unless
        :func:`~metrics_tpu_torch.parallel.set_bucketed_sync` turned it
        off), each state through its declared transport behind the
        error-budget gate; ``group=None`` returns it unchanged. Under an
        active placement the sharded leaves reshard (one tiled ``all_gather``
        per bucket), or stay blocks with ``keep_sharded=True``."""
        return _sync.sync_state(
            state, self._reductions, group, transports=self._sync_transports, tolerances=self._sync_tolerances,
            shard_axes=self.active_shard_axes, keep_sharded=keep_sharded,
        )

    def sync_compute_state(self, state: StateDict, group: Any = None) -> Any:
        """Pure sync, then compute: the unit the compiled compute engine
        captures, collectives included. ``group=None`` skips the sync.

        An active placement whose sync runs over one process group (not a
        mesh of several axes) takes the sharded-compute protocol when the
        class supports it: the sharded leaves stay blocks and
        :meth:`compute_sharded_state` combines only the result, so nothing
        reshards."""
        if group is not None:
            if isinstance(group, dist.ProcessGroup) and self.active_shard_axes and self.supports_sharded_compute:
                return self.compute_sharded_state(self.sync_states(state, group, keep_sharded=True), group)
            state = self.sync_states(state, group)
        return self.compute_state(state)

    def compute_sharded_state(self, state: StateDict, group: dist.ProcessGroup) -> Any:
        """Pure: the metric value from a *still-sharded* state: the sharded
        leaves are this rank's blocks, the replicated ones already synced.
        Classes whose finalize is a per-block reduction and a small combine
        override this, combining only the result with
        :func:`~metrics_tpu_torch.parallel.psum_result` and
        :func:`~metrics_tpu_torch.parallel.gather_result`."""
        raise NotImplementedError

    @property
    def supports_sharded_compute(self) -> bool:
        """True when this class ships a ``compute_sharded_state`` matching
        its ``compute``: the class defining the former sits at the same or a
        more derived place in the MRO than the class defining the latter, so
        a subclass that redefines ``compute`` alone reshards instead of
        finalizing its parent's metric."""
        cls = type(self)
        csc_owner = next((c for c in cls.__mro__ if "compute_sharded_state" in c.__dict__), None)
        if csc_owner is None or csc_owner is Metric:
            return False
        compute_owner = next((c for c in cls.__mro__ if "compute" in c.__dict__), None)
        if compute_owner is None:
            return False
        return cls.__mro__.index(csc_owner) <= cls.__mro__.index(compute_owner)

    # ------------------------------------------------------------------ #
    # incremental sync protocol: in-streak emissions
    # ------------------------------------------------------------------ #
    def incremental_plan(self, state: Optional[StateDict] = None) -> Dict[str, Dict[str, Any]]:
        """Pure: each state's incremental routing under the resolved mode
        (:func:`~metrics_tpu_torch.parallel.incremental_plan`)."""
        return _sync.incremental_plan(self.metric_state if state is None else state, self._reductions,
                                      modes=self._sync_modes, shard_axes=self.active_shard_axes)

    def init_incremental(self, state: StateDict, *, sync_every: Optional[int] = None) -> "_sync.IncrementalCarry":
        """Pure: a streak's starting ``state`` (usually :meth:`init_state`)
        in an :class:`~metrics_tpu_torch.parallel.IncrementalCarry` that
        emits every ``sync_every``-th update (default
        :func:`~metrics_tpu_torch.parallel.sync_cadence_default`)."""
        return _sync.init_incremental(state, self._reductions, modes=self._sync_modes, sync_every=sync_every,
                                      transports=self._sync_transports, shard_axes=self.active_shard_axes)

    def update_state_incremental(
        self, carry: "_sync.IncrementalCarry", *args: Any, group: Optional[dist.ProcessGroup] = None, **kwargs: Any
    ) -> "_sync.IncrementalCarry":
        """Pure: one streak step, :meth:`update_state` then, with ``group``
        given and the cadence due, the covered buckets' collectives folded
        into the carry's accumulator. ``group=None`` never emits, so the
        carry is a plain deferred state holder.
        ``core.engine.CompiledIncrementalStep`` captures this step."""
        state = self.update_state(carry.state, *args, **kwargs)
        return _sync.advance_incremental(
            carry, state, self._reductions, group, modes=self._sync_modes, transports=self._sync_transports,
            tolerances=self._sync_tolerances, shard_axes=self.active_shard_axes,
        )

    def finalize_incremental(
        self, carry: "_sync.IncrementalCarry", group: Any = None, keep_sharded: bool = False
    ) -> StateDict:
        """Pure: the synced state at the end of a streak. Covered buckets
        cost nothing; cadence tails and residue (sharded leaves among it)
        sync through the deferred path, bitwise equal to :meth:`sync_states`
        of the final state under exact transports."""
        return _sync.finalize_incremental_state(
            carry, self._reductions, group, modes=self._sync_modes, transports=self._sync_transports,
            tolerances=self._sync_tolerances, shard_axes=self.active_shard_axes, keep_sharded=keep_sharded,
        )

    def sync_compute_incremental(self, carry: "_sync.IncrementalCarry", group: Any = None) -> Any:
        """Pure finalize, then compute: the incremental counterpart of
        :meth:`sync_compute_state`, with its sharded-compute routing."""
        if isinstance(group, dist.ProcessGroup) and self.active_shard_axes and self.supports_sharded_compute:
            return self.compute_sharded_state(self.finalize_incremental(carry, group, keep_sharded=True), group)
        return self.compute_state(self.finalize_incremental(carry, group))

    # ------------------------------------------------------------------ #
    # stateful facade: forward / update / compute
    # ------------------------------------------------------------------ #
    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.forward(*args, **kwargs)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Compute the metric on the batch AND accumulate into the global state."""
        if self._is_synced:
            raise MetricsUserError(
                "The Metric shouldn't be synced when performing ``forward``. HINT: Did you forget to call ``unsync`` ?."
            )
        if self.full_state_update or self.full_state_update is None or self.dist_sync_on_step:
            self._forward_cache = self._forward_full_state_update(*args, **kwargs)
        else:
            self._forward_cache = self._forward_reduce_state_update(*args, **kwargs)
        return self._forward_cache

    @contextmanager
    def _batch_compute_mode(self) -> Generator:
        """The batch value of ``forward``: synced only under
        ``dist_sync_on_step``, left synced, state kept on its device; then
        back to the compute-time settings."""
        compute_on_cpu = self.compute_on_cpu
        self._to_sync, self._should_unsync, self.compute_on_cpu = self.dist_sync_on_step, False, False
        try:
            yield
        finally:
            self._is_synced, self._cache = False, None
            self._to_sync, self._should_unsync, self.compute_on_cpu = self.sync_on_compute, True, compute_on_cpu

    def _forward_full_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """Two updates: one into the global state, one on a fresh state for
        the batch value. The global states of the metrics this one holds (a
        wrapper's base metric) are kept and restored too, since ``reset()``
        resets them."""
        self.update(*args, **kwargs)
        snapshot = self._deep_snapshot()
        with self._batch_compute_mode():
            self.reset()
            self.update(*args, **kwargs)
            batch_val = self.compute()
        self._deep_restore(snapshot)
        return batch_val

    def _deep_snapshot(self) -> List[Tuple["Metric", StateDict, int]]:
        """This metric's state and update count, then its child metrics'."""
        snapshot: List[Tuple[Metric, StateDict, int]] = [(self, self.get_state(), self._update_count)]
        for child in self._child_metrics():
            snapshot.extend(child._deep_snapshot())
        return snapshot

    @staticmethod
    def _deep_restore(snapshot: List[Tuple["Metric", StateDict, int]]) -> None:
        for metric, state, count in snapshot:
            metric.set_state(state)
            metric._update_count = count
            metric._computed = None
            metric._is_synced = False

    def _forward_reduce_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """One update on a fresh state, then a merge into the global state."""
        global_state = self.get_state()
        update_count = self._update_count
        self.reset()
        with self._batch_compute_mode():
            self.update(*args, **kwargs)
            batch_val = self.compute()
        self._update_count = update_count + 1
        # global state first: cat states keep their accumulation order
        self.set_state(self.merge_states(global_state, self.get_state(), (update_count, 1)))
        self._computed = None
        return batch_val

    def _check_input_devices(self, args: Tuple, kwargs: Dict) -> None:
        for value in _tensors_in((args, kwargs)):
            if value.device != self._device:
                raise ValueError(
                    f"{type(self).__name__} keeps its state on {self._device}, "
                    f"but an input lies on {value.device}"
                )

    def _maybe_engine(self) -> Optional[Any]:
        """The compiled-update engine, or None when disabled (the instance's
        flag first, then the global switch)."""
        from metrics_tpu_torch.core import engine as _engine

        enabled = self._compiled_update
        if enabled is None:
            enabled = _engine.compiled_update_enabled()
        if not enabled:
            return None
        if self._update_engine is None:
            self._update_engine = _engine.CompiledUpdateEngine(self)
        return self._update_engine

    def _maybe_compute_engine(self) -> Optional[Any]:
        """The compiled-compute engine, or None when disabled."""
        from metrics_tpu_torch.core import engine as _engine

        enabled = self._compiled_compute
        if enabled is None:
            enabled = _engine.compiled_compute_enabled()
        if not enabled:
            return None
        if self._compute_engine is None:
            self._compute_engine = _engine.CompiledComputeEngine(self)
        return self._compute_engine

    def engine_stats(self) -> Dict[str, Any]:
        """Dispatch counters and fallback reasons of this metric's engines.

        ``update``/``compute`` are the engines' ``EngineStats`` (None until
        built), ``fallback_reasons`` maps ``"<kind>:<MetricClass>"`` to why an
        engine reverted to eager, and ``partition`` gives the path (``fused``,
        ``bucketed``, ``eager``) a collection would assign each kind, with the
        reason.
        """
        stats = _instruments.engine_stats_view(self._update_engine, self._compute_engine)
        stats["partition"] = _instruments.metric_partition_view(self)
        return stats

    def _wrap_update(self, update: Callable) -> Callable:
        @functools.wraps(update)
        def wrapped_func(*args: Any, **kwargs: Any) -> None:
            self._check_input_devices(args, kwargs)
            self._computed = None
            self._update_count += 1
            # the opt-in guard's snapshot holds the state's tensors, so the
            # engine's alias guard refuses the in-place update: the cost of
            # arming it; off, this is the one flag read
            guard_on = _guard.active and not _guard.capturing()
            prev = self.get_state() if guard_on else None
            engine = self._maybe_engine()
            if engine is None or not engine.dispatch(args, kwargs):
                self._eager_update(*args, **kwargs)
            if guard_on and _guard.inspect(type(self).__name__, "update", self.get_state()):
                # quarantine: drop the poisoned batch wholesale
                self.set_state(prev)
                self._update_count -= 1
            if self._buffer_states:
                self._surface_buffer_overflows()
            if self.compute_on_cpu:
                self._move_list_states_to_cpu()

        self._update = update  # unwrapped, used by the pure protocol
        return wrapped_func

    def _eager_update(self, *args: Any, **kwargs: Any) -> None:
        """One update outside the engines: the metric's own ``update``, or
        under an active placement the sharded update of :meth:`update_state`."""
        if self._sharded:
            self.set_state(self.update_state(self.get_state(), *args, **kwargs))
        else:
            self._update(*args, **kwargs)

    def _wrap_compute(self, compute: Callable) -> Callable:
        @functools.wraps(compute)
        def wrapped_func(*args: Any, **kwargs: Any) -> Any:
            if self._update_count == 0:
                rank_zero_warn(
                    f"The ``compute`` method of metric {self.__class__.__name__}"
                    " was called before the ``update`` method which may lead to errors,"
                    " as metric states have not yet been updated.",
                    UserWarning,
                )
            if self._computed is not None:
                return self._computed
            if not args and not kwargs:
                # one captured compute per state signature (warmup and escape
                # hatches in the engine)
                engine = self._maybe_compute_engine()
                if engine is not None:
                    handled, value = engine.dispatch()
                    if handled:
                        self._computed = _squeeze_if_scalar(value)
                        if _guard.active:
                            self._guard_compute()
                        return self._computed
                if self._sharded and self.dist_sync_fn is None and not self._is_synced:
                    # the blocks are not the value: the protocol, or a reshard,
                    # whatever ``sync_on_compute``/``dist_sync_on_step`` say
                    value = self.sync_compute_state(self.get_state(), self._sync_group())
                    self._computed = _squeeze_if_scalar(value)
                    if _guard.active:
                        self._guard_compute()
                    return self._computed
            should_sync = self._to_sync or (self._sharded and not self._is_synced)
            with self.sync_context(
                dist_sync_fn=self.dist_sync_fn, should_sync=should_sync, should_unsync=self._should_unsync
            ):
                self._computed = _squeeze_if_scalar(compute(*args, **kwargs))
            if _guard.active:
                self._guard_compute()
            return self._computed

        self._compute = compute  # unwrapped, used by the pure protocol
        return wrapped_func

    def _guard_compute(self) -> None:
        """The armed guard's check of the compute result (callers gate on
        ``_guard.active``)."""
        if not _guard.capturing():
            _guard.inspect(type(self).__name__, "compute", self._computed)

    def _surface_buffer_overflows(self) -> None:
        """Once per buffer state, at the update whose captured append went
        past its capacity: bump ``metrics_tpu_catbuffer_overflows_total{owner}``,
        warn, and record a ``buffer/overflow`` tracer instant. Reads the host
        mirror of the sticky flag, so it costs no read from the device."""
        for name in self._buffer_states:
            if name in self._overflow_reported:
                continue
            buf = self.__dict__.get(name)
            if not isinstance(buf, CatBuffer) or not buf.overflow_seen:
                continue
            self._overflow_reported.add(name)
            owner = f"{type(self).__name__}.{name}"
            _instruments.get_registry().counter(
                "catbuffer_overflows_total",
                help="CatBuffer states whose sticky overflow flag flipped "
                "(compiled appends beyond capacity overwrote the buffer tail)",
                owner=owner,
            ).inc()
            rank_zero_warn(
                f"CatBuffer state `{owner}` overflowed its capacity of "
                f"{buf.capacity} inside a compiled program: the overflowing appends overwrote the "
                "buffer tail and compute() will raise. Raise `buffer_capacity` to at least the "
                "per-device sample count.",
                UserWarning,
            )
            if _otrace.active:
                _otrace.emit_instant("buffer/overflow", "buffer", owner=owner, capacity=buf.capacity)

    def _move_list_states_to_cpu(self) -> None:
        """Host offload of the list and buffer states (``compute_on_cpu``)."""
        cpu = torch.device("cpu")
        for key in self._defaults:
            val = getattr(self, key)
            if isinstance(val, list):
                setattr(self, key, [v.to(cpu) for v in val])
            elif isinstance(val, CatBuffer) and val.materialized:
                setattr(self, key, val.to(cpu))

    # ------------------------------------------------------------------ #
    # distributed sync
    # ------------------------------------------------------------------ #
    def _sync_group(self, process_group: Optional[dist.ProcessGroup] = None) -> Optional[dist.ProcessGroup]:
        """The group a sync runs over: the active placement's (a process
        group, or its mesh for a tuple of axes), else the argument, the
        metric's own group, :func:`~metrics_tpu_torch.parallel.sync_axes`'
        group, else the default group when it has more than one rank."""
        if self._sharded:
            return self._sync_placement
        return next(
            (g for g in (process_group, self.process_group, _sync.current_sync_axes()) if g is not None),
            _sync._default_group(),
        )

    def _sync_dist(self, dist_sync_fn: Optional[Callable] = None, process_group: Optional[dist.ProcessGroup] = None) -> None:
        group = self._sync_group(process_group)
        state = self.get_state()
        if dist_sync_fn is not None:
            self.set_state(dist_sync_fn(state, self._reductions, group))
        else:
            self.set_state(self.sync_states(state, group))

    def sync(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[dist.ProcessGroup] = None,
        should_sync: bool = True,
        distributed_available: Optional[Callable] = _sync.distributed_available,
    ) -> None:
        """Replace the local state with the synced state, keeping the local
        one to restore in :meth:`unsync`."""
        if self._is_synced and should_sync:
            raise MetricsUserError("The Metric has already been synced.")
        is_distributed = distributed_available() if callable(distributed_available) else None
        # sharded blocks are not the value: a placed metric syncs even in a world of one
        if not should_sync or not (is_distributed or self._sharded):
            return
        self._cache = self.get_state()
        self._sync_dist(dist_sync_fn or self.dist_sync_fn, process_group=process_group)
        if _guard.active and not _guard.capturing():
            _guard.inspect(type(self).__name__, "sync", self.get_state())
        self._is_synced = True

    def unsync(self, should_unsync: bool = True) -> None:
        """Restore the local state from before :meth:`sync`."""
        if not should_unsync:
            return
        if not self._is_synced:
            raise MetricsUserError("The Metric has already been un-synced.")
        if self._cache is None:
            raise MetricsUserError("The internal cache should exist to unsync the Metric.")
        self.set_state(self._cache)
        self._is_synced = False
        self._cache = None

    @contextmanager
    def sync_context(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[dist.ProcessGroup] = None,
        should_sync: bool = True,
        should_unsync: bool = True,
        distributed_available: Optional[Callable] = _sync.distributed_available,
    ) -> Generator:
        """Sync for the duration of the block, then restore the local state."""
        self.sync(
            dist_sync_fn=dist_sync_fn,
            process_group=process_group,
            should_sync=should_sync,
            distributed_available=distributed_available,
        )
        yield
        self.unsync(should_unsync=self._is_synced and should_unsync)

    def update(self, *args: Any, **kwargs: Any) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def compute(self) -> Any:  # pragma: no cover - abstract
        raise NotImplementedError

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def reset(self) -> None:
        """Restore registered states to their defaults.

        The engines stay: the defaults have the running state's shapes and
        dtypes, so the captured steps stay valid and a reset-update cycle
        captures nothing new. The next compiled call copies the defaults'
        copies into its static buffers and never writes them.
        """
        self._update_count = 0
        self._forward_cache = None
        self._computed = None
        self._cache = None
        self._is_synced = False
        self._states_detached = False
        self._overflow_reported.clear()  # re-arm the one-shot overflow warning
        for attr, default in self._defaults.items():
            setattr(self, attr, _copy_state_value(default))
        self._mark_default_copies()

    def clone(self) -> "Metric":
        return deepcopy(self)

    def __setattr__(self, name: str, value: Any) -> None:
        if name in _PROTECTED_PROPERTIES and hasattr(self, "_defaults"):
            raise RuntimeError(f"Can't change const `{name}`.")
        object.__setattr__(self, name, value)

    def __getstate__(self) -> Dict[str, Any]:
        """Drop the wrapped bound methods for pickling and deep copies, and the
        engines: their graphs bind device addresses and their steps close over
        this instance. Copies rebuild them lazily."""
        dropped = ("update", "compute", "_update", "_compute", "_update_engine", "_compute_engine", "_default_refs")
        return {k: v for k, v in self.__dict__.items() if k not in dropped}

    def __deepcopy__(self, memo: Dict[int, Any]) -> "Metric":
        """A copy that shares the process group: a group cannot be copied."""
        for shared in (self.process_group, self._sync_placement, (self._state_sharding or (None,))[0]):
            if shared is not None:  # process groups cannot be copied
                memo.setdefault(id(shared), shared)
        new = type(self).__new__(type(self))
        memo[id(self)] = new
        new.__setstate__(deepcopy(self.__getstate__(), memo))
        return new

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)
        self._update_engine = None
        self._compute_engine = None
        self._default_refs = ()
        self.update = self._wrap_update(type(self).update.__get__(self))  # type: ignore[method-assign]
        self.compute = self._wrap_compute(type(self).compute.__get__(self))  # type: ignore[method-assign]

    def to(self, device: Union[str, torch.device]) -> "Metric":
        """Move all states (and defaults) to ``device``, then the tensors and
        modules the metric holds outside its states (:meth:`_move_attributes`)."""
        self._device = resolve_device(device)

        def move(val: StateValue) -> StateValue:
            return [v.to(self._device) for v in val] if isinstance(val, list) else val.to(self._device)

        for attr in self._defaults:
            setattr(self, attr, move(getattr(self, attr)))
        self._defaults = {k: move(d) for k, d in self._defaults.items()}
        self._shard_templates = {
            k: move(t) if isinstance(t, CatBuffer) else (t[0], t[1], None if t[2] is None else move(t[2]))
            for k, t in self._shard_templates.items()
        }
        self._move_attributes(self._device)
        self._computed = None
        # the graphs bind the old device's addresses
        self._update_engine = None
        self._compute_engine = None
        return self

    def astype(self, dtype: torch.dtype) -> "Metric":
        """Cast the floating-point states and their defaults to ``dtype``, so
        the cast outlives ``reset()``; integer and bool states keep theirs.
        Sketch states keep their dtypes, as in the JAX package. The engines
        are dropped, as by :meth:`to`: their steps were captured for the old
        dtypes."""

        def cast(x: Tensor) -> Tensor:
            return x.to(dtype) if x.is_floating_point() else x

        def apply(val: StateValue) -> StateValue:
            if isinstance(val, list):
                return [cast(v) for v in val]
            if isinstance(val, CatBuffer):
                if not val.materialized:
                    return val
                out = val._alias()
                out.data = cast(val.data)
                return out
            if _is_sketch(val):
                return val
            return cast(val)

        for attr in self._defaults:
            setattr(self, attr, apply(getattr(self, attr)))
        self._defaults = {k: apply(d) for k, d in self._defaults.items()}
        self._mark_default_copies()
        self._computed = None
        self._update_engine = None
        self._compute_engine = None
        return self

    def _move_attributes(self, device: torch.device) -> None:
        """Hook of :meth:`to`: move the device-bound attributes that are not
        registered states (a threshold grid, a model the metric loaded)."""

    # ------------------------------------------------------------------ #
    # serialization
    # ------------------------------------------------------------------ #
    def persistent(self, mode: bool = False) -> None:
        for key in self._persistent:
            self._persistent[key] = mode

    def state_dict(self, prefix: str = "") -> Dict[str, Any]:
        """Snapshot of the persistent states (detached clones)."""
        out: Dict[str, Any] = {}
        for key in self._defaults:
            if self._persistent[key]:
                current = getattr(self, key)
                if isinstance(current, list):
                    out[prefix + key] = [v.detach().clone() for v in current]
                elif _is_sketch(current):
                    # a dict of components, as the JAX package checkpoints it
                    out[prefix + key] = {f: v.detach().clone() for f, v in current.components().items()}
                elif isinstance(current, ShardedCatBuffer):
                    # this rank's block beside the global count and flag
                    out[prefix + key] = {
                        "block": current.data.detach().clone() if current.materialized else None,
                        "count": current.count.detach().clone(), "overflowed": current.overflowed.detach().clone(),
                    }
                elif isinstance(current, CatBuffer):
                    # the compact valid prefix, as the JAX package checkpoints it
                    out[prefix + key] = (
                        current.to_array().detach().clone() if current else torch.zeros((0,), dtype=torch.float32)
                    )
                else:
                    out[prefix + key] = current.detach().clone()
        return out

    def load_state_dict(self, state_dict: Dict[str, Any], prefix: str = "", strict: bool = True) -> None:
        """Load the persistent states. Under an active placement a sharded
        leaf takes either this rank's block (what :meth:`state_dict` holds
        here) or the whole global leaf, of which it keeps its block."""
        for key in self._defaults:
            name = prefix + key
            if name in state_dict:
                val = state_dict[name]
                default = self._defaults[key]
                if isinstance(default, ShardedCatBuffer):
                    if not isinstance(val, dict):
                        raise MetricsUserError(f"state {key!r}: a sample-sharded buffer loads from its state_dict block")
                    data = None if val["block"] is None else torch.as_tensor(val["block"], device=self._device)
                    count = torch.as_tensor(val["count"], device=self._device)
                    over = torch.as_tensor(val["overflowed"], device=self._device)
                    setattr(self, key, ShardedCatBuffer.block(
                        data, count, over, int(count), bool(over), default.index, default.width,
                        None if data is not None else default.capacity,
                    ))
                elif isinstance(default, CatBuffer):
                    if isinstance(val, list):
                        val = torch.cat([torch.atleast_1d(torch.as_tensor(v)) for v in val]) if val else torch.zeros(0)
                    arr = torch.as_tensor(val, device=self._device)
                    setattr(self, key, default.copy() if arr.shape[0] == 0 else CatBuffer.from_array(arr, capacity=default.capacity))
                elif _is_sketch(default):
                    if not isinstance(val, dict):
                        raise MetricsUserError(
                            f"state {key!r}: sketch states load from a dict of components, got {type(val).__name__}"
                        )
                    setattr(self, key, default.replace(**{
                        f: torch.as_tensor(v, device=self._device) for f, v in val.items()
                    }))
                elif isinstance(val, list):
                    setattr(self, key, [torch.as_tensor(v, device=self._device) for v in val])
                else:
                    val = torch.as_tensor(val, device=self._device)
                    if key in self.active_shard_axes and val.shape != default.shape:
                        val = self._own_block(key, val)
                    setattr(self, key, val)
            elif strict and self._persistent[key]:
                raise KeyError(f"Missing key {name!r} in state_dict")
        self._invalidate_dispatch()

    def _invalidate_dispatch(self) -> None:
        """Forget what derives from the previous state's identity after an
        out-of-band replacement: the memoized value and the engines' id-keyed
        memos (their captured steps stay)."""
        self._computed = None
        self._forward_cache = None
        for engine in (self._update_engine, self._compute_engine):
            if engine is not None:
                engine.reset_signature_memos()

    # ------------------------------------------------------------------ #
    # misc
    # ------------------------------------------------------------------ #
    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        """Keep only kwargs the (unwrapped) update accepts."""
        params = inspect.signature(self._update).parameters
        if any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values()):
            return kwargs
        return {
            k: v
            for k, v in kwargs.items()
            if k in params and params[k].kind is not inspect.Parameter.VAR_POSITIONAL
        }

    def _update_signature(self) -> Optional[Tuple]:
        """Static compute-group key: metrics returning equal keys share identical
        state trajectories, so a MetricCollection updates one of them and
        shares its state. None = never grouped."""
        return None

    def __hash__(self) -> int:
        return hash((self.__class__.__name__, id(self)))

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}()"

    # ------------------------------------------------------------------ #
    # operator overloads -> CompositionalMetric
    # ------------------------------------------------------------------ #
    def __add__(self, other): return CompositionalMetric(torch.add, self, other)
    def __radd__(self, other): return CompositionalMetric(torch.add, other, self)
    def __sub__(self, other): return CompositionalMetric(torch.sub, self, other)
    def __rsub__(self, other): return CompositionalMetric(torch.sub, other, self)
    def __mul__(self, other): return CompositionalMetric(torch.mul, self, other)
    def __rmul__(self, other): return CompositionalMetric(torch.mul, other, self)
    def __truediv__(self, other): return CompositionalMetric(torch.true_divide, self, other)
    def __rtruediv__(self, other): return CompositionalMetric(torch.true_divide, other, self)
    def __floordiv__(self, other): return CompositionalMetric(torch.floor_divide, self, other)
    def __rfloordiv__(self, other): return CompositionalMetric(torch.floor_divide, other, self)
    def __mod__(self, other): return CompositionalMetric(torch.remainder, self, other)
    def __rmod__(self, other): return CompositionalMetric(torch.remainder, other, self)
    def __pow__(self, other): return CompositionalMetric(torch.pow, self, other)
    def __rpow__(self, other): return CompositionalMetric(torch.pow, other, self)
    def __matmul__(self, other): return CompositionalMetric(torch.matmul, self, other)
    def __rmatmul__(self, other): return CompositionalMetric(torch.matmul, other, self)
    def __and__(self, other): return CompositionalMetric(torch.bitwise_and, self, other)
    def __rand__(self, other): return CompositionalMetric(torch.bitwise_and, other, self)
    def __or__(self, other): return CompositionalMetric(torch.bitwise_or, self, other)
    def __ror__(self, other): return CompositionalMetric(torch.bitwise_or, other, self)
    def __xor__(self, other): return CompositionalMetric(torch.bitwise_xor, self, other)
    def __rxor__(self, other): return CompositionalMetric(torch.bitwise_xor, other, self)
    def __eq__(self, other): return CompositionalMetric(torch.eq, self, other)  # type: ignore[override]
    def __ne__(self, other): return CompositionalMetric(torch.ne, self, other)  # type: ignore[override]
    def __lt__(self, other): return CompositionalMetric(torch.lt, self, other)
    def __le__(self, other): return CompositionalMetric(torch.le, self, other)
    def __gt__(self, other): return CompositionalMetric(torch.gt, self, other)
    def __ge__(self, other): return CompositionalMetric(torch.ge, self, other)
    def __abs__(self): return CompositionalMetric(torch.abs, self, None)
    def __neg__(self): return CompositionalMetric(_neg, self, None)
    def __pos__(self): return CompositionalMetric(torch.abs, self, None)
    def __invert__(self): return CompositionalMetric(torch.logical_not, self, None)
    def __getitem__(self, idx): return CompositionalMetric(lambda x: x[idx], self, None)


def _neg(x: Tensor) -> Tensor:
    return -torch.abs(x)


class CompositionalMetric(Metric):
    """Lazy arithmetic composition of metrics.

    Built by applying python operators to metrics; ``compute`` evaluates the
    operands first, then the operator. Lives on the device of its first
    metric operand; constant operands are moved there.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy
        >>> first = Accuracy(device="cpu")
        >>> combined = 1 - first
        >>> type(combined).__name__
        'CompositionalMetric'
        >>> combined.update(torch.tensor([0, 1, 1, 0]), torch.tensor([0, 1, 0, 0]))
        >>> float(combined.compute())
        0.25
    """

    full_state_update = True

    def __init__(
        self,
        operator: Callable,
        metric_a: Union[Metric, float, int, Tensor, None],
        metric_b: Union[Metric, float, int, Tensor, None],
    ) -> None:
        operand = metric_a if isinstance(metric_a, Metric) else metric_b
        super().__init__(device=operand.device)
        self.op = operator
        self.metric_a = self._as_operand(metric_a)
        self.metric_b = self._as_operand(metric_b)

    def _as_operand(self, value: Union[Metric, float, int, Tensor, None]) -> Union[Metric, Tensor, None]:
        if value is None or isinstance(value, Metric):
            return value
        return torch.as_tensor(value, device=self.device)

    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        return kwargs

    def _wrap_compute(self, compute: Callable) -> Callable:
        # caching and the compute-before-update warning belong to the operands
        return compute

    def update(self, *args: Any, **kwargs: Any) -> None:  # type: ignore[override]
        if isinstance(self.metric_a, Metric):
            self.metric_a.update(*args, **self.metric_a._filter_kwargs(**kwargs))
        if isinstance(self.metric_b, Metric):
            self.metric_b.update(*args, **self.metric_b._filter_kwargs(**kwargs))

    def compute(self) -> Any:  # type: ignore[override]
        val_a = self.metric_a.compute() if isinstance(self.metric_a, Metric) else self.metric_a
        val_b = self.metric_b.compute() if isinstance(self.metric_b, Metric) else self.metric_b
        if val_b is None:
            return self.op(val_a)
        return self.op(val_a, val_b)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        val_a = self.metric_a(*args, **self.metric_a._filter_kwargs(**kwargs)) if isinstance(self.metric_a, Metric) else self.metric_a
        val_b = self.metric_b(*args, **self.metric_b._filter_kwargs(**kwargs)) if isinstance(self.metric_b, Metric) else self.metric_b
        if val_a is None:
            self._forward_cache = None
        elif val_b is None:
            self._forward_cache = self.op(val_a) if not isinstance(self.metric_b, Metric) else None
        else:
            self._forward_cache = self.op(val_a, val_b)
        return self._forward_cache

    def reset(self) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.reset()
        if isinstance(self.metric_b, Metric):
            self.metric_b.reset()
        self._update_count = 0
        self._forward_cache = None
        self._computed = None

    def persistent(self, mode: bool = False) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.persistent(mode=mode)
        if isinstance(self.metric_b, Metric):
            self.metric_b.persistent(mode=mode)

    def __repr__(self) -> str:
        op_name = self.op.__name__ if hasattr(self.op, "__name__") else "op"
        return f"{self.__class__.__name__}(\n  {op_name}(\n    {self.metric_a!r},\n    {self.metric_b!r}\n  )\n)"

    def __hash__(self) -> int:
        return hash((self.__class__.__name__, id(self)))
