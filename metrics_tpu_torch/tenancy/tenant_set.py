"""TenantSet: N collections' states as one leading-axis state.

Counterpart of ``metrics_tpu/tenancy/tenant_set.py``.

The stacking model
------------------
A :class:`TenantSet` owns ``capacity`` slots. Each admitted tenant maps to
one slot; a slot's state is row ``slot`` of every stacked leaf. The template
collection is classified once by the partition dispatcher
(:func:`metrics_tpu_torch.core.engine.classify_tenant_member`): groups whose
update and compute capture, whose states are dense fixed-shape tensors and
whose reductions are elementwise go **tenant_stacked**, their states living
as ``(capacity + 1, *shape)`` tensors; the rest go **tenant_eager**:
per-tenant state dicts driven through the pure protocol one tenant at a time.

Where the JAX package runs a ``jax.vmap`` of the members' ``update_state``
under one ``jax.jit`` per (kind, bucket width), the port runs one
``torch.func.vmap`` of the same pure protocol: on the card captured once per
bucket width into a CUDA graph (a :class:`~metrics_tpu_torch.core.engine.CapturedStep`
whose inputs are the slot indices and the padded rows, and which writes the
stacked tensors in place, so the graphs of every width share them); on the
CPU the same function runs eagerly. A stacked member stays stacked: a vmap
or a capture that refuses it raises, it never turns into a loop over the
tenants. The dry run's ``BinnedAveragePrecision`` reaches B1 through its
``vmap`` rule, so a stacked update makes one batched B1 launch for every
tenant (``ops/classification/binned_counts.py``).

Ragged arrival
--------------
A dispatch of k tenants runs the ``next_pow2(k)``-wide bucket: the update
arguments' rows are padded to the bucket width and the slot index vector with
the scratch row ``capacity``, which no tenant owns. The rows are gathered by
index, updated, and written back with ``index_copy_``: padding rows land in
the scratch row (torch has no drop mode, which the JAX package's scatter
uses), so a masked or inactive tenant's row keeps its bits. Occupancy
changes (37 active of 1,024, then 38, then 5) reuse one captured step per
bucket width.

Lifecycle
---------
``admit`` is host bookkeeping (slot rows are at the registered defaults by
construction and by ``evict``'s masked reset), ``reset``/``evict`` run a
captured masked reset (:meth:`metrics_tpu_torch.Metric.reset_state`), and
``export_tenant``/``import_tenant`` move one tenant's rows without touching
the rest. The stacked tensors are made once and only ever written in place
(updates, resets, imports, restores), so every captured step stays valid.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.checkpoint.format import FORMAT_VERSION, metric_aux, object_fingerprint
from metrics_tpu_torch.core import engine as _engine
from metrics_tpu_torch.core.collections import MetricCollection, _flatten_results
from metrics_tpu_torch.core.metric import Metric, StateDict, _copy_state_value
from metrics_tpu_torch.observability import instruments as _instruments
from metrics_tpu_torch.observability import tracer as _otrace
from metrics_tpu_torch.parallel import sync as _sync
from metrics_tpu_torch.resilience import chaos as _chaos
from metrics_tpu_torch.sketches.base import is_sketch
from metrics_tpu_torch.utils.data import _squeeze_if_scalar
from metrics_tpu_torch.utils.exceptions import MetricsUserError, Uncapturable

TenantId = Any  # str or int (checkpointable); validated at admit


@dataclass
class TenantStats:
    """Lifecycle counters for one TenantSet (all monotonic except last_bucket)."""

    dispatches: int = 0  # stacked update dispatches served
    compiles: int = 0  # distinct steps built (update/compute/reset/import)
    cache_hits: int = 0  # dispatches/computes/resets served by a built step
    admits: int = 0
    evicts: int = 0
    resets: int = 0  # per-tenant resets (evictions' slot-scrubs not included)
    last_bucket: int = 0  # pow2 tenant bucket width of the most recent dispatch
    eager_tenant_updates: int = 0  # per-tenant eager-path updates (unstackable groups)


def _is_array(x: Any) -> bool:
    return isinstance(x, (Tensor, np.ndarray))


def _state_on(value: Any, device: Any) -> Any:
    """A fresh copy of one state value (a tensor, a list of tensors, a
    buffer or a sketch; numpy arrays from a decoded snapshot too) on
    ``device``."""
    if isinstance(value, list):
        return [_state_on(x, device) for x in value]
    if isinstance(value, np.ndarray):
        return torch.from_numpy(np.array(value)).to(device)
    if isinstance(value, Tensor):
        return value.detach().to(device, copy=True)
    return _copy_state_value(value).to(device)


class TenantSet:
    """N structurally identical collections behind one captured step a bucket.

    Args:
        template: the per-tenant ``MetricCollection`` (a bare ``Metric`` is
            wrapped). It is used for classification and as the pure
            update/compute/reset implementation; its own state is never
            advanced by tenant dispatches. The stacked state lives on its
            device.
        capacity: number of tenant slots (the stacked leading-axis size).
        name: label for the ``metrics_tpu_tenant_*`` observability series.
    """

    # duck-type marker for the checkpoint format's dispatch
    _is_tenant_set = True

    def __init__(self, template: Any, capacity: int = 1024, name: Optional[str] = None) -> None:
        if isinstance(template, Metric):
            template = MetricCollection(template)
        if not isinstance(template, MetricCollection):
            raise MetricsUserError(
                f"TenantSet template must be a Metric or MetricCollection, got {type(template).__name__}"
            )
        if capacity < 1:
            raise MetricsUserError(f"TenantSet capacity must be >= 1, got {capacity}")
        self.template = template
        self.capacity = int(capacity)
        self.name = name or f"TenantSet[{type(template).__name__}]"
        self.stats = TenantStats()
        self._device = next(iter(template._metrics.values())).device
        # the template's partition dispatcher carries the tenant_stacked
        # class; dispatches bump its stable_hits, so the partition counters
        # pin "nothing rebuilt" for tenancy too
        self._dispatcher = _engine.CollectionDispatcher(template, tenant_context=self)
        part = self._dispatcher._ensure_partition()
        stacked_set = frozenset(part.tenant_stacked)
        self._stacked_groups: Tuple[Tuple[str, ...], ...] = tuple(
            tuple(g) for g in template._groups if g[0] in stacked_set
        )
        self._eager_groups: Tuple[Tuple[str, ...], ...] = tuple(
            tuple(g) for g in template._groups if g[0] not in stacked_set
        )
        # stacked state, flattened once: {leader: (leaves, spec)}, each leaf
        # (capacity + 1, *shape); the last row is the scratch row that
        # padding rows write. Made here, written only in place.
        self._flat: Dict[str, Tuple[List[Tensor], Any]] = {}
        for group in self._stacked_groups:
            leaves, spec = _engine.tree_flatten(template._metrics[group[0]].init_state())
            self._flat[group[0]] = (
                [leaf.unsqueeze(0).expand(self.capacity + 1, *leaf.shape).clone() for leaf in leaves], spec,
            )
        # eager (unstackable) groups: one state dict per occupied slot
        self._eager_states: Dict[str, Dict[int, StateDict]] = {g[0]: {} for g in self._eager_groups}
        # slot table
        self._slot_of: Dict[TenantId, int] = {}
        self._tenant_at: List[Optional[TenantId]] = [None] * self.capacity
        self._free: List[int] = list(range(self.capacity - 1, -1, -1))  # pop() -> 0 first
        self._update_counts = np.zeros((self.capacity,), dtype=np.int64)
        # built steps; keys are ("update", B, spec, roles, shapes, bshapes) /
        # ("compute", B) / ("reset", B) / ("import",)
        self._steps: Dict[Tuple, _engine.CapturedStep] = {}
        self._pool: Any = None
        _instruments.register_tenant_set(self)

    # ------------------------------------------------------------------ #
    # introspection
    # ------------------------------------------------------------------ #
    @property
    def active_count(self) -> int:
        return len(self._slot_of)

    def tenant_ids(self) -> List[TenantId]:
        """Active tenant ids in slot order (stable across dispatches)."""
        return [t for t in self._tenant_at if t is not None]

    def tenant_update_counts(self) -> Dict[TenantId, int]:
        return {t: int(self._update_counts[s]) for t, s in sorted(self._slot_of.items(), key=lambda kv: kv[1])}

    def partition_view(self) -> Dict[str, Any]:
        """The dispatcher's partition view (includes the ``tenant`` section)."""
        return self._dispatcher.partition_view()

    @property
    def stacked_states(self) -> Dict[str, StateDict]:
        """The live stacked state, ``{leader: {state: (capacity, ...)}}``
        views without the scratch row (read-only by convention)."""
        return {
            lname: _engine.tree_unflatten([leaf[: self.capacity] for leaf in leaves], spec)
            for lname, (leaves, spec) in self._flat.items()
        }

    def _slots_for(self, tenant_ids: Sequence[TenantId]) -> List[int]:
        seen: set = set()
        slots: List[int] = []
        for tid in tenant_ids:
            if tid in seen:
                raise MetricsUserError(
                    f"TenantSet: duplicate tenant id {tid!r} in one dispatch — the write-back would be "
                    "undefined; coalesce the tenant's rows first."
                )
            seen.add(tid)
            slot = self._slot_of.get(tid)
            if slot is None:
                raise MetricsUserError(
                    f"TenantSet: tenant {tid!r} is not admitted (active: {self.active_count}/{self.capacity}); "
                    "call admit() first."
                )
            slots.append(slot)
        return slots

    def _bucket(self, k: int) -> int:
        return _engine._next_pow2(max(k, 1))

    def _padded_idx(self, slots: Sequence[int], width: int) -> Tensor:
        # padding rows carry the scratch row `capacity`, which no tenant owns
        idx = np.full((width,), self.capacity, dtype=np.int64)
        idx[: len(slots)] = slots
        return torch.from_numpy(idx).to(self._device)

    # ------------------------------------------------------------------ #
    # the built steps
    # ------------------------------------------------------------------ #
    def _run(self, key: Tuple, make: Callable[[], Callable], inputs: Tuple) -> Any:
        """Run the step of ``key`` on ``inputs`` (built at its first call:
        probed, and on the card captured). A stacked step that cannot be
        captured raises: nothing goes eager."""
        step = self._steps.get(key)
        if step is not None:
            self.stats.cache_hits += 1
            return step.run_compute(inputs, _engine.tree_leaves(inputs))
        if self._pool is None and self._device.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()
        step = _engine.CapturedStep(make(), writes_state=False, pool=self._pool)
        try:
            out = step.probe(inputs, (), {})
        except (Uncapturable, RuntimeError) as err:  # the probe's refusal, or vmap's
            raise MetricsUserError(
                f"{self.name}: the tenant-stacked {key[0]} step cannot be vmapped or captured"
                f" ({type(err).__name__}: {str(err).splitlines()[0][:200]}); a stacked member does not fall back to"
                " a per-tenant loop"
            ) from err
        self._steps[key] = step
        self.stats.compiles += 1
        return out

    def _gathered(self, idx: Tensor) -> List[List[Tensor]]:
        return [[leaf.index_select(0, idx) for leaf in leaves] for leaves, _ in self._flat.values()]

    def _write_rows(self, idx: Tensor, rows: List[List[Tensor]]) -> None:
        for (leaves, _), new in zip(self._flat.values(), rows):
            for leaf, n in zip(leaves, new):
                leaf.index_copy_(0, idx, n.to(leaf.dtype))

    # ------------------------------------------------------------------ #
    # lifecycle: admit / evict / reset
    # ------------------------------------------------------------------ #
    def admit(self, tenant_id: TenantId) -> int:
        """Bind a tenant to a free slot; returns the slot. Host bookkeeping
        only (slot rows are already at the registered defaults)."""
        if not isinstance(tenant_id, (str, int)) or isinstance(tenant_id, bool):
            raise MetricsUserError(
                f"TenantSet tenant ids must be str or int (checkpointable), got {type(tenant_id).__name__}"
            )
        if _chaos.active:
            _chaos.maybe_fail("tenancy/admit", tenant=str(tenant_id), active=self.active_count)
        if tenant_id in self._slot_of:
            raise MetricsUserError(f"TenantSet: tenant {tenant_id!r} is already admitted")
        if not self._free:
            raise MetricsUserError(
                f"TenantSet at capacity ({self.capacity}): evict a tenant before admitting {tenant_id!r}"
            )
        slot = self._free.pop()
        self._slot_of[tenant_id] = slot
        self._tenant_at[slot] = tenant_id
        for group in self._eager_groups:
            self._eager_states[group[0]][slot] = self.template._metrics[group[0]].init_state()
        self.stats.admits += 1
        if _otrace.active:
            _otrace.emit_instant("tenancy/admit", "tenancy", owner=self.name, tenant=str(tenant_id), slot=slot,
                                 active=self.active_count)
        return slot

    def evict(self, tenant_id: TenantId) -> None:
        """Release a tenant's slot. Its stacked rows go back to the defaults
        through the captured masked reset (so the next ``admit`` is
        bookkeeping only)."""
        if _chaos.active:
            _chaos.maybe_fail("tenancy/evict", tenant=str(tenant_id), active=self.active_count)
        slot = self._slot_of.get(tenant_id)
        if slot is None:
            raise MetricsUserError(f"TenantSet: tenant {tenant_id!r} is not admitted")
        self._reset_slots([slot])
        del self._slot_of[tenant_id]
        self._tenant_at[slot] = None
        self._free.append(slot)
        for group in self._eager_groups:
            self._eager_states[group[0]].pop(slot, None)
        self.stats.evicts += 1
        if _otrace.active:
            _otrace.emit_instant("tenancy/evict", "tenancy", owner=self.name, tenant=str(tenant_id), slot=slot,
                                 active=self.active_count)

    def reset(self, tenant_ids: Optional[Sequence[TenantId]] = None) -> None:
        """Reset the named tenants (default: all active) to the registered
        defaults without touching any other tenant's rows, through the
        captured masked reset of the ids' pow2 bucket."""
        ids = list(tenant_ids) if tenant_ids is not None else self.tenant_ids()
        if not ids:
            return
        slots = self._slots_for(ids)
        self._reset_slots(slots)
        for group in self._eager_groups:
            leader = self.template._metrics[group[0]]
            for slot in slots:
                self._eager_states[group[0]][slot] = leader.init_state()
        self.stats.resets += len(ids)
        if _otrace.active:
            _otrace.emit_instant("tenancy/reset", "tenancy", owner=self.name, tenants=[str(t) for t in ids[:32]],
                                 count=len(ids))

    def _reset_slots(self, slots: Sequence[int]) -> None:
        self._update_counts[list(slots)] = 0
        if not self._flat:
            return
        width = self._bucket(len(slots))
        coll = self.template

        def make() -> Callable:
            def reset(inputs: Tuple, _args: Tuple, _kwargs: Dict) -> Tuple:
                (idx,) = inputs
                mask = torch.zeros(self.capacity + 1, dtype=torch.bool, device=idx.device).index_fill(0, idx, True)
                for lname, (leaves, spec) in self._flat.items():
                    new = coll._metrics[lname].reset_state(_engine.tree_unflatten(leaves, spec), mask)
                    torch._foreach_copy_(leaves, _engine.tree_leaves(new))
                return ()

            return reset

        self._run(("reset", width), make, (self._padded_idx(slots, width),))
        self._dispatcher._ensure_partition()  # stable-partition heartbeat

    # ------------------------------------------------------------------ #
    # the stacked update dispatch
    # ------------------------------------------------------------------ #
    def update(self, tenant_ids: Sequence[TenantId], *args: Any, **kwargs: Any) -> None:
        """Advance every named tenant by its row of the update arguments.

        Tensor arguments whose leading dimension equals ``len(tenant_ids)``
        are per-tenant rows (vmapped); other tensors broadcast to every
        tenant; non-tensor Python values are static config. One captured step
        per (pow2 bucket width, argument structure) serves every occupancy:
        37 of 1,024 tenants run the 64-wide bucket, whose padding rows land
        in the scratch row, and the other rows are never touched.
        """
        if _chaos.active:
            _chaos.maybe_fail("tenancy/dispatch", tenants=len(tenant_ids), active=self.active_count)
        k = len(tenant_ids)
        if k == 0:
            return
        # host rows (the ingest dispatcher's numpy) go to the set's device
        args = tuple(self._on_device(a) for a in args)
        kwargs = {kk: self._on_device(v) for kk, v in kwargs.items()}
        slots = self._slots_for(tenant_ids)
        width = self._bucket(k)
        if self._flat:
            self._dispatch_stacked(slots, width, k, args, kwargs)
        if self._eager_groups:
            self._dispatch_eager(slots, k, args, kwargs)
        self._update_counts[slots] += 1
        self.stats.dispatches += 1
        self.stats.last_bucket = width
        self._dispatcher._ensure_partition()  # stable-partition heartbeat

    def apply_batch(
        self, tenant_ids: Sequence[TenantId], *args: Any, auto_admit: bool = False, **kwargs: Any
    ) -> Dict[TenantId, int]:
        """One ingestion dispatch: optionally admit, then :meth:`update`.

        With ``auto_admit=True`` tenants seen for the first time are admitted
        first (bookkeeping only). Returns each tenant's update count after
        the dispatch. Raises
        :class:`~metrics_tpu_torch.utils.exceptions.MetricsUserError` at
        capacity, as :meth:`admit` does.
        """
        if auto_admit:
            for tid in tenant_ids:
                if tid not in self._slot_of:
                    self.admit(tid)
        self.update(tenant_ids, *args, **kwargs)
        return {tid: int(self._update_counts[self._slot_of[tid]]) for tid in tenant_ids}

    def _on_device(self, leaf: Any) -> Any:
        if isinstance(leaf, np.ndarray):
            return torch.as_tensor(leaf, device=self._device)
        if isinstance(leaf, Tensor) and leaf.device != self._device:
            return leaf.to(self._device)
        return leaf

    def _split_leaves(self, k: int, width: int, args: Tuple, kwargs: Dict) -> Tuple[Any, List[Tensor], List[Tensor], Tuple]:
        """Update-argument leaves by role: batched (padded to the bucket
        width), broadcast (unbatched tensors) and static."""
        leaves, spec = _engine.tree_flatten((args, kwargs))
        roles: List[Any] = []
        batched: List[Tensor] = []
        bcast: List[Tensor] = []
        for leaf in leaves:
            if _is_array(leaf) and leaf.ndim >= 1 and leaf.shape[0] == k:
                arr = torch.as_tensor(leaf)
                if width > k:
                    arr = torch.cat([arr, arr.new_zeros((width - k, *arr.shape[1:]))])
                roles.append("b")
                batched.append(arr.contiguous())
            elif _is_array(leaf):
                roles.append("c")
                bcast.append(torch.as_tensor(leaf))
            else:
                try:
                    hash(leaf)
                except TypeError:
                    raise MetricsUserError(
                        f"TenantSet.update: argument leaf {leaf!r} is neither an array nor hashable static config; "
                        "pass tensors (leading tenant axis for per-tenant rows) or hashable scalars."
                    ) from None
                roles.append(("s", leaf))
        return spec, batched, bcast, tuple(roles)

    def _dispatch_stacked(self, slots: List[int], width: int, k: int, args: Tuple, kwargs: Dict) -> None:
        spec, batched, bcast, roles = self._split_leaves(k, width, args, kwargs)
        shapes = tuple((tuple(a.shape[1:]), a.dtype) for a in batched)
        bshapes = tuple((tuple(a.shape), a.dtype) for a in bcast)
        t0_us = _otrace._now_us() if _otrace.active else 0
        coll = self.template
        groups = self._stacked_groups

        def make() -> Callable:
            def stacked_update(inputs: Tuple, _args: Tuple, _kwargs: Dict) -> Tuple:
                idx, batched_in, bcast_in = inputs

                def one(rows: List[List[Tensor]], brow: List[Tensor]) -> List[List[Tensor]]:
                    it_b, it_c = iter(brow), iter(bcast_in)
                    flat = [next(it_b) if r == "b" else next(it_c) if r == "c" else r[1] for r in roles]
                    a, kw = _engine.tree_unflatten(flat, spec)
                    out = []
                    for group, lrows in zip(groups, rows):
                        leader = coll._metrics[group[0]]
                        state = _engine.tree_unflatten(lrows, self._flat[group[0]][1])
                        out.append(_engine.tree_leaves(leader.update_state(state, *a, **leader._filter_kwargs(**kw))))
                    return out

                self._write_rows(idx, torch.func.vmap(one)(self._gathered(idx), list(batched_in)))
                return ()

            return stacked_update

        key = ("update", width, spec, roles, shapes, bshapes)
        self._run(key, make, (self._padded_idx(slots, width), batched, bcast))
        if _otrace.active:
            _otrace.emit_complete("tenancy/dispatch", "tenancy", t0_us, _otrace._now_us() - t0_us,
                                  owner=self.name, tenants=k, bucket=width, active=self.active_count)

    def _dispatch_eager(self, slots: List[int], k: int, args: Tuple, kwargs: Dict) -> None:
        """Unstackable groups: one pure update_state per tenant per group."""
        for i, slot in enumerate(slots):
            row_args = tuple(self._row(a, i, k) for a in args)
            row_kwargs = {kk: self._row(v, i, k) for kk, v in kwargs.items()}
            for group in self._eager_groups:
                leader = self.template._metrics[group[0]]
                state = self._eager_states[group[0]][slot]
                self._eager_states[group[0]][slot] = leader.update_state(
                    state, *row_args, **leader._filter_kwargs(**row_kwargs)
                )
                self.stats.eager_tenant_updates += 1

    @staticmethod
    def _row(leaf: Any, i: int, k: int) -> Any:
        if _is_array(leaf) and leaf.ndim >= 1 and leaf.shape[0] == k:
            return leaf[i]
        return leaf

    # ------------------------------------------------------------------ #
    # compute
    # ------------------------------------------------------------------ #
    def compute(self, tenant_ids: Optional[Sequence[TenantId]] = None) -> Dict[TenantId, Dict[str, Any]]:
        """Per-tenant metric values, ``{tenant_id: {output_name: value}}``.

        Stacked groups compute through one vmapped step over the ids' pow2
        bucket; unstackable groups compute per tenant through the pure
        protocol.
        """
        ids = list(tenant_ids) if tenant_ids is not None else self.tenant_ids()
        if not ids:
            return {}
        slots = self._slots_for(ids)
        k = len(ids)
        stacked_rows: Optional[Dict[str, Any]] = None
        t0_us = _otrace._now_us() if _otrace.active else 0
        if self._flat:
            width = self._bucket(k)
            coll = self.template
            groups = self._stacked_groups

            def make() -> Callable:
                def stacked_compute(inputs: Tuple, _args: Tuple, _kwargs: Dict) -> Dict[str, Any]:
                    (idx,) = inputs

                    def one(rows: List[List[Tensor]]) -> Dict[str, Any]:
                        res: Dict[str, Any] = {}
                        for group, lrows in zip(groups, rows):
                            state = _engine.tree_unflatten(lrows, self._flat[group[0]][1])
                            for name in group:
                                res[coll._set_name(name)] = coll._metrics[name].compute_state(state)
                        return res

                    return torch.func.vmap(one)(self._gathered(idx))

                return stacked_compute

            stacked_rows = self._run(("compute", width), make, (self._padded_idx(slots, width),))
        out: Dict[TenantId, Dict[str, Any]] = {}
        for i, (tid, slot) in enumerate(zip(ids, slots)):
            res: Dict[str, Any] = {}
            for group in self.template._groups:
                if group[0] in self._eager_states:
                    state = self._eager_states[group[0]][slot]
                    for name in group:
                        res[self.template._set_name(name)] = self._eager_compute(self.template._metrics[name], state)
                elif stacked_rows is not None:
                    for name in group:
                        key_name = self.template._set_name(name)
                        leaves, spec = _engine.tree_flatten(stacked_rows[key_name])
                        res[key_name] = _engine.tree_unflatten([v[i] for v in leaves], spec)
            out[tid] = {kk: _squeeze_if_scalar(vv) for kk, vv in _flatten_results(res).items()}
        if _otrace.active:
            _otrace.emit_complete("tenancy/compute", "tenancy", t0_us, _otrace._now_us() - t0_us,
                                  owner=self.name, tenants=k, active=self.active_count)
        return out

    @staticmethod
    def _eager_compute(metric: Metric, state: StateDict) -> Any:
        """One tenant's value of an unstackable member. A placed member's
        state holds this rank's blocks: its value syncs over the placement,
        as its ``compute()`` does (the JAX package's global arrays need no
        sync)."""
        if metric.state_sharding is not None:
            return metric.sync_compute_state(state, metric._sync_placement)
        return metric.compute_state(state)

    def read_quantiles(self, tenant_id: TenantId, qs: Sequence[float]) -> Dict[str, List[float]]:
        """Arbitrary quantiles from one tenant's ``QuantileSketch`` states.

        Any quantile evaluates from the same fixed-size state, not only the
        ``q`` the template was built with. Metrics without a
        ``QuantileSketch`` state are skipped. Keys are the collection output
        name, suffixed with ``/<state>`` when a metric holds several.
        """
        from metrics_tpu_torch.sketches import QuantileSketch

        slot = self._slot_of.get(tenant_id)
        if slot is None:
            raise MetricsUserError(f"TenantSet: tenant {tenant_id!r} is not admitted")
        qs = [float(q) for q in qs]
        if not qs or not all(0.0 <= q <= 1.0 for q in qs):
            raise MetricsUserError(f"quantiles must be in [0, 1], got {qs!r}")
        qs_t = torch.tensor(qs, dtype=torch.float32, device=self._device)
        out: Dict[str, List[float]] = {}
        stacked = self.stacked_states
        for group in self.template._groups:
            leader = group[0]
            metric = self.template._metrics[leader]
            sketch_states = [k for k, d in metric._defaults.items() if isinstance(d, QuantileSketch)]
            if not sketch_states:
                continue
            eager = self._eager_states.get(leader)
            for k in sketch_states:
                if eager is not None:
                    sk = eager[slot][k]
                else:
                    leaves, spec = _engine.tree_flatten(stacked[leader][k])
                    sk = _engine.tree_unflatten([c[slot] for c in leaves], spec)
                name = self.template._set_name(leader)
                key = name if len(sketch_states) == 1 else f"{name}/{k}"
                out[key] = sk.quantile(qs_t).tolist()
        return out

    # ------------------------------------------------------------------ #
    # tenant-batched sync (pure)
    # ------------------------------------------------------------------ #
    def _stacked_sync_config(self) -> Tuple[Dict, Dict, Dict]:
        leaders = [group[0] for group in self._stacked_groups]
        return (
            {n: dict(self.template._metrics[n]._reductions) for n in leaders},
            {n: dict(self.template._metrics[n]._sync_transports) for n in leaders},
            {n: dict(self.template._metrics[n]._sync_tolerances) for n in leaders},
        )

    def sync_states(self, stacked: Dict[str, StateDict], group: Any) -> Dict[str, StateDict]:
        """Cross-rank sync of a stacked state tree: the tenant axis folds into
        the flat ``(reduction, dtype, transport)`` buckets, so the collective
        count of a sync depends on neither N nor the number of stacked
        groups (:func:`metrics_tpu_torch.parallel.sync.sync_stacked_states`).
        The leaders' declared transports and tolerances apply."""
        reductions, transports, tolerances = self._stacked_sync_config()
        return _sync.sync_stacked_states(stacked, reductions, group, transports, tolerances)

    def init_incremental_sync(self, stacked: Dict[str, StateDict], *, sync_every: Optional[int] = None) -> Any:
        """Incremental carry over a stacked state tree (pure); every stacked
        leaf is elementwise, so all take emissions, with the collective count
        of :meth:`sync_states`."""
        reductions, transports, tolerances = self._stacked_sync_config()
        return _sync.init_incremental_stacked(stacked, reductions, sync_every=sync_every, transports=transports,
                                              tolerances=tolerances)

    def advance_incremental_sync(self, carry: Any, stacked: Dict[str, StateDict], group: Any) -> Any:
        """One streak step of the stacked incremental protocol (pure): fold
        the stacked states into the carry, emitting on cadence."""
        reductions, transports, tolerances = self._stacked_sync_config()
        return _sync.advance_incremental_stacked(carry, stacked, reductions, group, transports=transports,
                                                 tolerances=tolerances)

    def finalize_incremental_sync(self, carry: Any, group: Any) -> Dict[str, StateDict]:
        """Finish a stacked incremental streak (pure): the nested synced
        ``{leader: {state: leaf}}`` tree, bitwise :meth:`sync_states` of the
        same final states for exact transports."""
        reductions, transports, tolerances = self._stacked_sync_config()
        return _sync.finalize_incremental_stacked(carry, reductions, group, transports=transports,
                                                  tolerances=tolerances)

    # ------------------------------------------------------------------ #
    # single-tenant export / import
    # ------------------------------------------------------------------ #
    def _template_aux(self) -> Dict[str, Dict[str, Any]]:
        """Update-determined Python config (``Accuracy.mode``, ...) per
        member. Stacked tenants are structurally identical streams, so it
        lives on the template, not per tenant."""
        return {name: metric_aux(m) for name, m in self.template._metrics.items()}

    def _apply_template_aux(self, aux: Dict[str, Dict[str, Any]]) -> None:
        for name, attrs in (aux or {}).items():
            m = self.template._metrics.get(name)
            if m is None:
                continue
            for aname, aval in attrs.items():
                if aval is not None:
                    setattr(m, aname, aval)

    def export_tenant(self, tenant_id: TenantId) -> Dict[str, Any]:
        """One tenant's state on the host: ``{"states", "eager_states",
        "update_count", "aux"}``. Reads only; no other tenant's rows move."""
        slot = self._slot_of.get(tenant_id)
        if slot is None:
            raise MetricsUserError(f"TenantSet: tenant {tenant_id!r} is not admitted")
        states = {
            lname: _engine.tree_unflatten([leaf[slot].cpu().clone() for leaf in leaves], spec)
            for lname, (leaves, spec) in self._flat.items()
        }
        eager = {
            lname: {k: _state_on(v, "cpu") for k, v in self._eager_states[lname][slot].items()}
            for lname in self._eager_states
        }
        return {
            "states": states,
            "eager_states": eager,
            "update_count": int(self._update_counts[slot]),
            "aux": self._template_aux(),
        }

    def import_tenant(self, tenant_id: TenantId, snapshot: Dict[str, Any]) -> int:
        """Admit (if absent) and load one tenant's exported state through a
        captured single-row write: the other rows are untouched."""
        slot = self._slot_of.get(tenant_id)
        if slot is None:
            slot = self.admit(tenant_id)
        if self._flat:
            # leaves in the set's own state order: a decoded wire snapshot
            # holds each member's states sorted by name
            rows = []
            for lname, (leaves, spec) in self._flat.items():
                st = snapshot["states"][lname]
                ordered = {k: st[k] for k in _engine.tree_unflatten(leaves, spec)}
                rows.append([torch.as_tensor(x).to(self._device) for x in _engine.tree_leaves(ordered)])

            def make() -> Callable:
                def import_rows(inputs: Tuple, _args: Tuple, _kwargs: Dict) -> Tuple:
                    idx, rows_in = inputs
                    self._write_rows(idx, [[r.unsqueeze(0) for r in lrows] for lrows in rows_in])
                    return ()

                return import_rows

            self._run(("import",), make, (torch.tensor([slot], device=self._device), rows))
        for lname, st in (snapshot.get("eager_states") or {}).items():
            if lname in self._eager_states:
                self._eager_states[lname][slot] = {k: _state_on(v, self._device) for k, v in st.items()}
        self._apply_template_aux(snapshot.get("aux") or {})
        self._update_counts[slot] = int(snapshot.get("update_count", 0))
        return slot

    # ------------------------------------------------------------------ #
    # checkpoint integration (metrics_tpu_torch.checkpoint calls these)
    # ------------------------------------------------------------------ #
    def fingerprint(self) -> Dict[str, Any]:
        """Static identity for restore gating: capacity and template fingerprint."""
        return {
            "format_version": FORMAT_VERSION,
            "kind": "tenant_set",
            "capacity": self.capacity,
            "template": object_fingerprint(self.template),
        }

    def _payload_keys(self) -> List[Tuple[str, Tensor]]:
        """``(npz key, stacked leaf)`` of every stacked leaf:
        ``tenant/{leader}.{state}``, with ``.{field}`` per sketch component."""
        out: List[Tuple[str, Tensor]] = []
        for lname, (leaves, spec) in self._flat.items():
            it = iter(leaves)
            for k, v in _engine.tree_unflatten(leaves, spec).items():
                if is_sketch(v):
                    out.extend((f"tenant/{lname}.{k}.{fname}", next(it)) for fname, _ in v.component_reductions())
                else:
                    out.append((f"tenant/{lname}.{k}", next(it)))
        return out

    def _ckpt_payload(self) -> Tuple[Dict[str, Tensor], Dict[str, Any]]:
        """``(payload, shard_meta)`` for :func:`metrics_tpu_torch.checkpoint.format.build_shard`.

        The whole stacked state lands as ``tenant/{leader}.{state}`` arrays
        (without the scratch row): one snapshot restores every tenant. A set
        with eager groups refuses to snapshot rather than drop them.
        """
        if self._eager_groups:
            eager = ", ".join(g[0] for g in self._eager_groups)
            raise MetricsUserError(
                f"TenantSet checkpointing requires a fully stackable template; groups [{eager}] are tenant_eager "
                "(see partition_view()['tenant'] for the reasons and analysis rule E110)."
            )
        payload = {key: leaf[: self.capacity] for key, leaf in self._payload_keys()}
        shard_meta = {
            "kind": "tenant_set",
            "members": {
                "__tenants__": {
                    "capacity": self.capacity,
                    "slots": [[tid, slot] for tid, slot in sorted(self._slot_of.items(), key=lambda kv: kv[1])],
                    "update_counts": [int(c) for c in self._update_counts],
                    "aux": self._template_aux(),
                }
            },
            "fingerprint": self.fingerprint(),
        }
        return payload, shard_meta

    def _apply_snapshot(self, payload: Dict[str, np.ndarray], members_meta: Dict[str, Any]) -> None:
        """Replace every tenant's state from a loaded shard (restore pass 2),
        written into the stacked tensors in place: shapes and dtypes are
        fingerprint-gated equal, so the built steps stay valid and the next
        dispatch replays."""
        info = members_meta["__tenants__"]
        for key, leaf in self._payload_keys():
            leaf[: self.capacity].copy_(torch.from_numpy(np.require(payload[key], requirements="C")))
        self._slot_of = {tid: int(slot) for tid, slot in info["slots"]}
        self._tenant_at = [None] * self.capacity
        for tid, slot in self._slot_of.items():
            self._tenant_at[slot] = tid
        self._free = [s for s in range(self.capacity - 1, -1, -1) if self._tenant_at[s] is None]
        self._update_counts = np.asarray(info["update_counts"], dtype=np.int64).copy()
        self._apply_template_aux(info.get("aux") or {})
