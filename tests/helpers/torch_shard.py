"""The bodies the gloo ranks run for the port's sharded-state tests.

JAX-free (the spawned ranks import it, beside ``tests/helpers/torch_dist.py``,
whose :class:`~tests.helpers.torch_dist.GlooWorld` runs them). Metrics are
named by class and keyword arguments, inputs cross as numpy arrays, and every
body returns numpy trees: blocks, values and the collectives each step
ticked (``count_collectives`` boxes, kinds and bytes).
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

import metrics_tpu_torch as mt
from metrics_tpu_torch.core.buffers import CatBuffer, ShardedCatBuffer
from metrics_tpu_torch.core.engine import CapturedStep, _carry_mirrors
from metrics_tpu_torch.parallel import count_collectives, make_mesh
from metrics_tpu_torch.parallel.mesh import Mesh

_MESHES: Dict[Tuple, Mesh] = {}


def mesh(sizes: Sequence[int] = (4,), names: Sequence[str] = ("data",)) -> Mesh:
    """One mesh per layout and process (a mesh makes its groups collectively)."""
    key = (tuple(sizes), tuple(names))
    if key not in _MESHES:
        _MESHES[key] = make_mesh(list(sizes), list(names))
    return _MESHES[key]


class GridMetric(mt.Metric):
    """An integer class x threshold grid sharded along both axes."""

    full_state_update = False

    def __init__(self, shape: Tuple[int, int] = (16, 8), **kw: Any) -> None:
        super().__init__(**kw)
        self.add_state("grid", default=torch.zeros(shape, dtype=torch.int32), dist_reduce_fx="sum", shard_axis=(0, 1))

    def update(self, x: torch.Tensor) -> None:
        self.grid = self.grid + x

    def compute(self) -> torch.Tensor:
        return self.grid.sum(dim=1, dtype=torch.int32)


class GridWithProtocol(GridMetric):
    def compute(self) -> torch.Tensor:
        return self.grid.sum(dim=1, dtype=torch.int32)

    def compute_sharded_state(self, state: Dict[str, Any], group: Any) -> Any:
        raise AssertionError("a placement over a mesh of several axes must not take the protocol")


class MaxGrid(mt.Metric):
    """A sharded ``max`` leaf (and one of ``mean``, which cannot be placed)."""

    def __init__(self, reduction: str = "max", **kw: Any) -> None:
        super().__init__(**kw)
        self.add_state("peak", default=torch.full((8, 3), -1.0), dist_reduce_fx=reduction, shard_axis=0)

    def update(self, x: torch.Tensor) -> None:
        self.peak = torch.maximum(self.peak, x)

    def compute(self) -> torch.Tensor:
        return self.peak


CLASSES = {"GridMetric": GridMetric, "GridWithProtocol": GridWithProtocol, "MaxGrid": MaxGrid}


def build(spec: Tuple[str, Dict[str, Any]]) -> Any:
    cls, kwargs = spec
    return (CLASSES.get(cls) or getattr(mt, cls))(device="cpu", **kwargs)


def to_numpy(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, CatBuffer):
        return None if tree.data is None else tree.data.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree


def _box(box: Dict[str, Any]) -> Dict[str, Any]:
    return {"by_kind": dict(box["by_kind"]), "bytes_by_kind": dict(box["bytes_by_kind"]), "count": box["count"]}


def _batches(batches: Sequence[Sequence[np.ndarray]]) -> List[List[torch.Tensor]]:
    return [[torch.from_numpy(np.ascontiguousarray(x)) for x in batch] for batch in batches]


def _mesh_of(layout: Optional[Tuple[Sequence[int], Sequence[str]]]) -> Mesh:
    return mesh(*layout) if layout is not None else mesh()


def _blocks(metric: Any) -> Dict[str, Any]:
    return {name: to_numpy(getattr(metric, name)) for name in metric.shard_axes}


def _nbytes(leaf: Any) -> int:
    data = leaf.data if isinstance(leaf, CatBuffer) else leaf
    return 0 if data is None else data.numel() * data.element_size()


# --------------------------------------------------------------------------- #
# bodies
# --------------------------------------------------------------------------- #
def stream(spec, batches, shard: bool = True, layout=None, axis_name: Any = "data",
           compute: bool = True, compiled: Optional[bool] = None) -> Dict[str, Any]:
    """Build, place (``shard``), update with this rank's batches, compute:
    the blocks, their bytes, the per-update and compute collectives, the
    engines' counters and the value."""
    metric = build(spec)
    if compiled is not None:
        metric._compiled_update = compiled
    if shard:
        metric.shard_state(_mesh_of(layout), axis_name)
    updates = []
    for batch in _batches(batches):
        with count_collectives() as box:
            metric.update(*batch)
        updates.append(_box(box))
    out = {
        "blocks": _blocks(metric), "block_nbytes": {n: _nbytes(getattr(metric, n)) for n in metric.shard_axes},
        "updates": updates, "active": metric.active_shard_axes,
    }
    stats = metric.engine_stats()
    u = stats["update"]
    out["engine"] = None if u is None else {
        "compiled_calls": u.compiled_calls, "donated_calls": u.donated_calls, "collective_counts": dict(u.collective_counts),
    }
    out["fallback_reasons"] = dict(stats["fallback_reasons"])
    if compute:
        with count_collectives() as box:
            out["value"] = to_numpy(metric.compute())
        out["compute"] = _box(box)
    return out


def protocol(spec, batches, local: bool = False) -> Dict[str, Any]:
    """The pure protocol of a placed metric: ``sync_compute_state`` over the
    placement's group, then ``sync_states`` of the same blocks (a reshard),
    and with ``local``, ``sync_compute_state`` with no group (no sync)."""
    metric = build(spec).shard_state(mesh())
    for batch in _batches(batches):
        metric.update(*batch)
    state, group = metric.get_state(), metric._sync_group()
    with count_collectives() as box:
        value = metric.sync_compute_state(state, group)
    out = {"value": to_numpy(value), "protocol": _box(box), "supports": metric.supports_sharded_compute}
    with count_collectives() as box:
        metric.sync_states(state, group)
    out["reshard"] = _box(box)
    if local:
        with count_collectives() as box:
            value = metric.sync_compute_state(state, None)
        out["local"] = {"box": _box(box), "shape": tuple(np.shape(to_numpy(value)))}
    return out


def sync_counts(spec, shard: bool, layout=None, axis_name: Any = "data", init: bool = True,
                via_compute: bool = False) -> Dict[str, Any]:
    """The collectives of one ``sync_states`` (or ``sync_compute_state``) of
    the metric's initial state over its sync group."""
    metric = build(spec)
    mesh_ = _mesh_of(layout)
    if shard:
        metric.shard_state(mesh_, axis_name)
    group = metric._sync_group() if shard else mesh_.group(mesh_.axis_names)
    state = metric.init_state() if init else metric.get_state()
    with count_collectives() as box:
        if via_compute:
            metric.sync_compute_state(state, group)
        else:
            metric.sync_states(state, group)
    return {"box": _box(box), "active": metric.active_shard_axes, "shard_axes": metric.shard_axes,
            "supports": metric.supports_sharded_compute}


def placement_errors(layout=None) -> Dict[str, str]:
    """What shard_state raises, by case."""
    out = {}
    cases = {
        "unknown_axis": (("ConfusionMatrix", {"num_classes": 64}), None, "model"),
        "uneven": (("ConfusionMatrix", {"num_classes": 10}), None, "data"),
        "mean_leaf": (("MaxGrid", {"reduction": "mean"}), None, "data"),
    }
    if layout is not None:
        cases = {
            "no_mesh": (("GridMetric", {}), "none", ("cls", "thr")),
            "unknown_axis": (("GridMetric", {}), None, ("cls", "model")),
            "too_few_names": (("GridMetric", {}), None, ("cls",)),
        }
    for key, (spec, where, axis_name) in cases.items():
        metric = build(spec)
        try:
            metric.shard_state(None if where == "none" else _mesh_of(layout), axis_name)
            out[key] = "no error"
        except Exception as err:  # noqa: BLE001 - the test reads the type and message
            out[key] = f"{type(err).__name__}: {err}"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        build(("Accuracy", {"num_classes": 4, "average": "micro"})).shard_state(mesh())
    out["warned"] = [str(w.message) for w in caught]
    return out


def lifecycle(spec, batch, layout=None, axis_name: Any = "data") -> Dict[str, Any]:
    """reset keeps the placement; a state_dict round trip keeps it and the
    value; unshard_state ticks one reshard per leaf at the whole leaf's
    bytes and keeps the value."""
    mesh_ = _mesh_of(layout)
    batch = _batches([batch])[0]
    src = build(spec)
    src.persistent(True)
    src.shard_state(mesh_, axis_name)
    src.update(*batch)
    block_shapes = {n: tuple(getattr(src, n).shape) for n in src.shard_axes}
    before = to_numpy(src.compute())
    sd = src.state_dict()
    dst = build(spec)
    dst.persistent(True)
    dst.shard_state(mesh_, axis_name)
    dst.load_state_dict(sd)
    out = {"before": before, "loaded": to_numpy(dst.compute()),
           "loaded_shapes": {n: tuple(getattr(dst, n).shape) for n in dst.shard_axes}, "block_shapes": block_shapes}
    src.reset()
    out["reset_shapes"] = {n: tuple(getattr(src, n).shape) for n in src.shard_axes}
    out["reset_sums"] = {n: float(getattr(src, n).sum()) for n in src.shard_axes}
    out["reset_active"] = src.active_shard_axes
    dst.update(*batch)  # a second update on the loaded copy: its value doubles
    with count_collectives() as box:
        out["twice"] = to_numpy(dst.compute())
        dst.unshard_state()
    out["compute_unshard"] = _box(box)
    out["unsharded_active"] = dst.active_shard_axes
    out["unsharded_shapes"] = {n: tuple(getattr(dst, n).shape) for n in dst.shard_axes}
    out["after_unshard"] = to_numpy(dst.compute())
    return out


def catbuffer_cases(rows_per_rank: int, capacity: int) -> Dict[str, Any]:
    """A sample-sharded CatMetric: its unshard tally, and the sticky overflow
    flag through the placement, a captured step (the engines' flattener and
    statics) and unshard_state."""
    rank = dist.get_rank()
    c = build(("CatMetric", {"buffer_capacity": capacity})).shard_state(mesh())
    c.update(torch.arange(rank * rows_per_rank, (rank + 1) * rows_per_rank, dtype=torch.float32))
    with count_collectives() as box:
        c.unshard_state()
    out = {"unshard": _box(box), "value": to_numpy(c.compute())}
    over = build(("CatMetric", {"buffer_capacity": capacity}))
    over.value = CatBuffer(torch.zeros(capacity, dtype=torch.float32), capacity + 2, overflowed=True)
    over.shard_state(mesh())
    placed = over.value
    out["placed"] = bool(placed.overflowed) and placed.overflow_seen and isinstance(placed, ShardedCatBuffer)
    step = CapturedStep(lambda state, args, kwargs: {k: v._alias() for k, v in state.items()}, writes_state=True)
    step.probe({"value": placed}, (), {})
    result = step.run_update({"value": placed}, [placed.data, placed.count, placed.overflowed], (), {}, [], False,
                             [True, True, True])
    _carry_mirrors({"value": placed}, result, step.buffer_rows)  # as the engine's dispatch does
    through = result["value"]
    out["captured"] = bool(through.overflowed) and through.overflow_seen and isinstance(through, ShardedCatBuffer)
    over.value = through
    over.unshard_state()
    out["unsharded"] = bool(over.value.overflowed) and over.value.overflow_seen
    out["count"] = int(over.value.count)
    return out


def collection_stream(batches, shard: bool = True, unshard: bool = False) -> Dict[str, Any]:
    """The mixed collection of micro Accuracy, macro Precision and a
    ConfusionMatrix, fused."""
    coll = mt.MetricCollection({
        "acc": mt.Accuracy(num_classes=16, average="micro", device="cpu"),
        "prec": mt.Precision(num_classes=16, average="macro", device="cpu"),
        "confmat": mt.ConfusionMatrix(num_classes=16, device="cpu"),
    })
    if shard:
        coll.shard_state(mesh())
    for batch in _batches(batches):
        coll.update(*batch)
    out = {"value": to_numpy(coll.compute())}
    stats = coll.engine_stats()["update"]
    out["engine"] = None if stats is None else {"compiled_calls": stats.compiled_calls,
                                               "donated_calls": stats.donated_calls}
    coll._realias_members()
    out["confmat_block"] = tuple(coll["confmat"].confmat.shape)
    out["acc_active"] = coll["acc"].active_shard_axes
    if unshard:
        coll.unshard_state()
        out["unsharded_active"] = coll["prec"].active_shard_axes
        out["after_unshard"] = to_numpy(coll.compute())
    return out


def forward_stream(spec, batches, collection: bool = False) -> Dict[str, Any]:
    """A placed metric (or, with ``collection``, a collection of placed
    ``spec`` members named ``a`` and ``b``) called as ``metric(*batch)`` per
    batch, then ``compute()``: the batch values, the value and the block
    shapes after."""
    if collection:
        target = mt.MetricCollection({"a": build(spec), "b": build(spec)})
    else:
        target = build(spec)
    target.shard_state(mesh())
    batch_values = [to_numpy(target(*batch)) for batch in _batches(batches)]
    out = {"batch_values": batch_values, "value": to_numpy(target.compute())}
    if collection:
        target._realias_members()
        out["compute_groups"] = [list(g) for g in target.compute_groups.values()]
        members = [target["a"], target["b"]]
    else:
        members = [target]
    out["shapes"] = [{n: tuple(getattr(m, n).shape) for n in m.shard_axes} for m in members]
    return out


def compute_engine_stats(spec, batches) -> Dict[str, Any]:
    """Two update -> compute cycles of a placed metric: the second compute is
    captured, and its probe's collectives land in its EngineStats."""
    metric = build(spec).shard_state(mesh())
    for batch in _batches(batches):
        metric.update(*batch)
        metric.compute()
    stats = metric.engine_stats()
    c = stats["compute"]
    return {"cache_misses": c.cache_misses, "collective_counts": dict(c.collective_counts),
            "collective_bytes": dict(c.collective_bytes), "fallback_reasons": dict(stats["fallback_reasons"])}


def sharded_incremental(tiles: np.ndarray, hits: np.ndarray) -> Dict[str, Any]:
    """An incremental streak of one step over a sharded ``tiles`` leaf (this
    rank's block) and a replicated ``hits`` leaf: the carry, the step's
    emission, the finalize, and the deferred ``sync_state`` of the stepped
    state."""
    from metrics_tpu_torch.parallel import advance_incremental, finalize_incremental_state, init_incremental, sync_state

    group = dist.group.WORLD
    state = {"tiles": torch.from_numpy(tiles), "hits": torch.from_numpy(hits)}
    reds = {"tiles": "sum", "hits": "sum"}
    modes = {k: "incremental" for k in state}
    axes = {"tiles": 0}
    carry = init_incremental(state, reds, modes=modes, shard_axes=axes, sync_every=1)
    stepped = {"tiles": state["tiles"] * 2.0, "hits": state["hits"] + 1}
    with count_collectives() as box:
        carry_after = advance_incremental(carry, stepped, reds, group, modes=modes, shard_axes=axes)
    out = finalize_incremental_state(carry_after, reds, group, modes=modes, shard_axes=axes)
    return {"acc": sorted(carry.acc), "advance": _box(box), "finalized": to_numpy(out),
            "deferred": to_numpy(sync_state(stepped, reds, group, shard_axes=axes))}
