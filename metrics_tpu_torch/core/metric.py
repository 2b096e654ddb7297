"""The Metric base: a pure state protocol behind a stateful facade.

Counterpart of ``metrics_tpu/core/metric.py``: ``add_state`` with the sum,
mean, max, min and cat reduction tags, the pure ``init_state`` /
``update_state`` / ``compute_state`` / ``merge_states`` protocol, the
``update`` / ``compute`` / ``forward`` / ``reset`` facade, ``state_dict`` and
``CompositionalMetric``, the sync facade: ``sync`` / ``unsync`` /
``sync_context`` over a ``torch.distributed`` process group, which
``compute()`` runs in, and the compiled engines (``core/engine.py``): from
the second call of each input signature, ``update()`` and ``compute()``
replay a captured CUDA graph (on the CPU, the same step with the value checks
off). The JAX package's sharding, sketches, incremental sync, tracer and
resilience guard have no counterpart here.

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

from metrics_tpu_torch.core.buffers import CatBuffer
from metrics_tpu_torch.parallel import sync as _sync
from metrics_tpu_torch.utils.data import _flatten, _squeeze_if_scalar
from metrics_tpu_torch.utils.exceptions import MetricsUserError
from metrics_tpu_torch.utils.prints import rank_zero_warn

StateValue = Union[Tensor, List[Tensor], CatBuffer]
StateDict = Dict[str, StateValue]

_PROTECTED_PROPERTIES = ("is_differentiable", "higher_is_better", "full_state_update")
_REDUCTIONS = ("sum", "mean", "cat", "max", "min", None)


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
    """A fresh leaf: tensors and buffers are cloned (so no caller can write
    into a default), lists are re-wrapped."""
    if isinstance(value, list):
        return list(value)
    if isinstance(value, CatBuffer):
        return value.copy()
    return value.clone()


def _tensors_in(value: Any):
    """Every tensor in ``value``, walking lists, tuples and dicts."""
    if isinstance(value, Tensor):
        yield value
    elif isinstance(value, (list, tuple)):
        for item in value:
            yield from _tensors_in(item)
    elif isinstance(value, dict):
        for item in value.values():
            yield from _tensors_in(item)


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
        self._device = resolve_device(device)
        self._defaults: Dict[str, StateValue] = {}
        self._persistent: Dict[str, bool] = {}
        self._reductions: Dict[str, Optional[Union[str, Callable]]] = {}
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
    ) -> None:
        """Register a state variable.

        ``default`` is a tensor (fixed-shape state, moved to the metric's
        device), an empty list (a ``cat`` list), or a :class:`CatBuffer`
        (a ``cat`` buffer of fixed item shape). ``dist_reduce_fx`` is one of
        ``"sum"|"mean"|"max"|"min"|"cat"``, a callable applied to the
        stacked values, or None (keep every value). With ``buffer_capacity``
        set, an empty-list ``cat`` state becomes a buffer of that capacity.
        """
        if not isinstance(default, (Tensor, CatBuffer)) and not (isinstance(default, list) and default == []):
            raise ValueError("state variable must be a tensor, an empty list or a CatBuffer")
        if dist_reduce_fx not in _REDUCTIONS and not callable(dist_reduce_fx):
            raise ValueError("`dist_reduce_fx` must be callable or one of ['mean', 'sum', 'cat', 'min', 'max', None]")
        if isinstance(default, CatBuffer) and dist_reduce_fx != "cat":
            raise ValueError(f"state {name!r}: a CatBuffer default needs dist_reduce_fx='cat'")
        if isinstance(default, list) and self.buffer_capacity is not None:
            if dist_reduce_fx != "cat":
                raise MetricsUserError(
                    f"{type(self).__name__} does not support `buffer_capacity`: state {name!r} is "
                    "a list of per-element entries (not a flat dim-0 concatenation), so it cannot "
                    "be stored in a fixed-capacity CatBuffer. Remove the `buffer_capacity` argument."
                )
            default = CatBuffer.empty(self.buffer_capacity)
        if isinstance(default, (Tensor, CatBuffer)):
            default = default.to(self._device)
        self._defaults[name] = _copy_state_value(default)
        self._persistent[name] = persistent
        self._reductions[name] = dist_reduce_fx
        setattr(self, name, _copy_state_value(default))
        self._mark_default_copies()

    @property
    def metric_state(self) -> StateDict:
        """Current state values keyed by registered name."""
        return {attr: getattr(self, attr) for attr in self._defaults}

    @property
    def device(self) -> torch.device:
        return self._device

    # ------------------------------------------------------------------ #
    # pure functional protocol
    # ------------------------------------------------------------------ #
    def init_state(self) -> StateDict:
        """Fresh state from the registered defaults."""
        return {k: _copy_state_value(v) for k, v in self._defaults.items()}

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
        copied first, since appends write into them in place."""
        prev = self.get_state()
        try:
            self.set_state({k: v.copy() if isinstance(v, CatBuffer) else v for k, v in state.items()})
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

    def sync_states(self, state: StateDict, group: Optional[dist.ProcessGroup]) -> StateDict:
        """Pure: ``state`` synced over ``group`` by reduction tag (bucketed
        by ``(reduction, dtype)`` unless
        :func:`~metrics_tpu_torch.parallel.set_bucketed_sync` turned it
        off); ``group=None`` returns it unchanged."""
        return _sync.sync_state(state, self._reductions, group)

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
        the batch value."""
        self.update(*args, **kwargs)
        update_count = self._update_count
        global_state = self.get_state()
        with self._batch_compute_mode():
            self.reset()
            self.update(*args, **kwargs)
            batch_val = self.compute()
        self.set_state(global_state)
        self._update_count = update_count
        self._computed = None
        return batch_val

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
        from metrics_tpu_torch.core import engine as _engine

        stats = _engine.engine_stats_view(self._update_engine, self._compute_engine)
        stats["partition"] = _engine.metric_partition_view(self)
        return stats

    def _wrap_update(self, update: Callable) -> Callable:
        @functools.wraps(update)
        def wrapped_func(*args: Any, **kwargs: Any) -> None:
            self._check_input_devices(args, kwargs)
            self._computed = None
            self._update_count += 1
            engine = self._maybe_engine()
            if engine is None or not engine.dispatch(args, kwargs):
                update(*args, **kwargs)
            if self.compute_on_cpu:
                self._move_list_states_to_cpu()

        self._update = update  # unwrapped, used by the pure protocol
        return wrapped_func

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
                        return self._computed
            with self.sync_context(
                dist_sync_fn=self.dist_sync_fn, should_sync=self._to_sync, should_unsync=self._should_unsync
            ):
                self._computed = _squeeze_if_scalar(compute(*args, **kwargs))
            return self._computed

        self._compute = compute  # unwrapped, used by the pure protocol
        return wrapped_func

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
    def _sync_dist(self, dist_sync_fn: Optional[Callable] = None, process_group: Optional[dist.ProcessGroup] = None) -> None:
        group = next(
            (g for g in (process_group, self.process_group, _sync.current_sync_axes()) if g is not None),
            _sync._default_group(),
        )
        state = self.get_state()
        if dist_sync_fn is not None:
            self.set_state(dist_sync_fn(state, self._reductions, group))
        else:
            self.set_state(_sync.sync_state(state, self._reductions, group))

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
        if not should_sync or not is_distributed:
            return
        self._cache = self.get_state()
        self._sync_dist(dist_sync_fn or self.dist_sync_fn, process_group=process_group)
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
        if self.process_group is not None:
            memo.setdefault(id(self.process_group), self.process_group)
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
        self._move_attributes(self._device)
        self._computed = None
        # the graphs bind the old device's addresses
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
                elif isinstance(current, CatBuffer):
                    # the compact valid prefix, as the JAX package checkpoints it
                    out[prefix + key] = (
                        current.to_array().detach().clone() if current else torch.zeros((0,), dtype=torch.float32)
                    )
                else:
                    out[prefix + key] = current.detach().clone()
        return out

    def load_state_dict(self, state_dict: Dict[str, Any], prefix: str = "", strict: bool = True) -> None:
        for key in self._defaults:
            name = prefix + key
            if name in state_dict:
                val = state_dict[name]
                default = self._defaults[key]
                if isinstance(default, CatBuffer):
                    if isinstance(val, list):
                        val = torch.cat([torch.atleast_1d(torch.as_tensor(v)) for v in val]) if val else torch.zeros(0)
                    arr = torch.as_tensor(val, device=self._device)
                    setattr(self, key, default.copy() if arr.shape[0] == 0 else CatBuffer.from_array(arr, capacity=default.capacity))
                elif isinstance(val, list):
                    setattr(self, key, [torch.as_tensor(v, device=self._device) for v in val])
                else:
                    setattr(self, key, torch.as_tensor(val, device=self._device))
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
