"""Metrics and gloo rank bodies of the port's checkpoint and tenancy tests.

JAX-free: the spawned ranks of :class:`~tests.helpers.torch_dist.GlooWorld`
import it. Inputs cross as numpy arrays and every body returns numpy trees.

- ``TinyMean`` and ``TinyMax`` are the port's twins of the tiny metrics of
  the JAX package's tenancy tests (``tests/tenancy/test_tenant_set.py``).
- The checkpoint bodies save a placed metric from every rank at once (the
  save gathers the placed leaves, a collective) and restore one, placed or
  replicated.
- The tenancy bodies run the stacked sync and the stacked incremental sync of
  a :class:`~metrics_tpu_torch.tenancy.TenantSet` whose rank ``r`` holds
  ``(r + 1)`` times the base state, with their collective tallies.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

import metrics_tpu_torch as mt
from metrics_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
from metrics_tpu_torch.core.engine import classify_tenant_member
from metrics_tpu_torch.parallel import count_collectives
from metrics_tpu_torch.parallel.sync import sync_stacked_states
from tests.helpers import torch_shard as shard
from tests.helpers.torch_dist import to_numpy


class TinyMean(mt.Metric):
    """A cheap dense-state metric: two float32 sums."""

    full_state_update = False

    def __init__(self, **kw: Any) -> None:
        super().__init__(**kw)
        self.add_state("total", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("count", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, values: torch.Tensor) -> None:
        self.total = self.total + values.sum()
        self.count = self.count + float(np.prod(values.shape))

    def compute(self) -> torch.Tensor:
        return self.total / torch.clamp(self.count, min=1.0)


class TinyMax(mt.Metric):
    """A ``max`` state."""

    full_state_update = False

    def __init__(self, **kw: Any) -> None:
        super().__init__(**kw)
        self.add_state("peak", default=torch.full((), -float("inf")), dist_reduce_fx="max")

    def update(self, values: torch.Tensor) -> None:
        self.peak = torch.maximum(self.peak, values.max())

    def compute(self) -> torch.Tensor:
        return self.peak


class DeclaredMean(TinyMean):
    """TinyMean with both sums declared for the bf16 transport."""

    def __init__(self, **kw: Any) -> None:
        mt.Metric.__init__(self, **kw)
        self.add_state("total", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum",
                       sync_transport="bf16")
        self.add_state("count", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum",
                       sync_transport="bf16")


def tiny_set(capacity: int, n_admit: int, mean: type = TinyMean, with_max: bool = True) -> Tuple[Any, List[str]]:
    """A TenantSet of TinyMean (and TinyMax) on the CPU, ``n_admit`` tenants
    admitted and updated once with ``arange`` rows."""
    members = {"mean": mean(device="cpu")}
    if with_max:
        members["mx"] = TinyMax(device="cpu")
    ts = mt.TenantSet(mt.MetricCollection(members), capacity=capacity)
    ids = [f"t{i}" for i in range(n_admit)]
    for tid in ids:
        ts.admit(tid)
    if ids:
        ts.update(ids, torch.arange(n_admit * 4, dtype=torch.float32).reshape(n_admit, 4))
    return ts, ids


def _box(box: Dict[str, Any]) -> Dict[str, Any]:
    return {"count": box["count"], "by_kind": dict(box["by_kind"]), "bytes": sum(box["bytes_by_kind"].values()),
            "bytes_by_transport": {k: dict(v) for k, v in box["bytes_by_transport"].items()}}


def _scaled(stacked: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, Dict[str, torch.Tensor]]:
    """This rank's replica: the base state times ``rank + 1``."""
    scale = float(dist.get_rank() + 1)
    return {ln: {n: v * scale for n, v in st.items()} for ln, st in stacked.items()}


# --------------------------------------------------------------------------- #
# tenancy bodies
# --------------------------------------------------------------------------- #
def stacked_sync_counts(capacity: int, n_admit: int, transport: str = "exact") -> Dict[str, Any]:
    """The collectives of one stacked sync (optionally with every TinyMean
    state declared for ``transport``)."""
    ts, _ = tiny_set(capacity, n_admit)
    stacked = ts.stacked_states
    reductions = {ln: {n: ts.template._metrics[ln]._reductions[n] for n in st} for ln, st in stacked.items()}
    transports = {"mean": {"total": transport, "count": transport}} if transport != "exact" else None
    with count_collectives() as box:
        sync_stacked_states(stacked, reductions, dist.group.WORLD, transports=transports)
    return _box(box)


def one_group_counts() -> Dict[str, Any]:
    """A set of TinyMean alone (one sum bucket) and one of TinyMean and TinyMax."""
    out = {}
    for label, with_max in (("one", False), ("two", True)):
        ts, _ = tiny_set(16, 1, with_max=with_max)
        with count_collectives() as box:
            ts.sync_states(ts.stacked_states, dist.group.WORLD)
        out[label] = box["count"]
    return out


def declared_transport_counts() -> Dict[str, Any]:
    ts, _ = tiny_set(16, 1, mean=DeclaredMean)
    with count_collectives() as box:
        ts.sync_states(ts.stacked_states, dist.group.WORLD)
    return {**_box(box), "refusals": len(box["refusals"])}


def stacked_sync_values(capacity: int, n_admit: int) -> Dict[str, Any]:
    """Each rank's ``(rank + 1) * base`` synced, beside the base."""
    ts, _ = tiny_set(capacity, n_admit)
    base = ts.stacked_states
    synced = ts.sync_states(_scaled(base), dist.group.WORLD)
    return {"base": to_numpy(base), "synced": to_numpy(synced)}


def incremental_emission_counts(capacity: int, n_admit: int) -> Dict[str, Any]:
    ts, _ = tiny_set(capacity, n_admit)
    carry = ts.init_incremental_sync(ts.stacked_states)
    with count_collectives() as box:
        ts.advance_incremental_sync(carry, ts.stacked_states, dist.group.WORLD)
    return _box(box)


def incremental_against_deferred(capacity: int, n_admit: int) -> Dict[str, Any]:
    """One emission then finalize (and the finalize's collectives), against
    the deferred stacked sync of the same states."""
    ts, _ = tiny_set(capacity, n_admit)
    st = _scaled(ts.stacked_states)
    carry = ts.advance_incremental_sync(ts.init_incremental_sync(st), st, dist.group.WORLD)
    with count_collectives() as fin:
        got = ts.finalize_incremental_sync(carry, dist.group.WORLD)
    want = ts.sync_states(st, dist.group.WORLD)
    return {"got": to_numpy(got), "want": to_numpy(want), "finalize_collectives": fin["count"]}


class ShardedCounts(mt.Metric):
    """Dense class-sharded counts: tenant-stackable until a placement lands."""

    def __init__(self, num_classes: int = 8, **kw: Any) -> None:
        super().__init__(**kw)
        self.num_classes = num_classes
        self.add_state("counts", default=torch.zeros(num_classes, dtype=torch.int32), dist_reduce_fx="sum",
                       shard_axis=0)

    def update(self, labels: torch.Tensor, *_: Any) -> None:
        ones = torch.ones_like(labels, dtype=torch.int32)
        self.counts = self.counts + torch.zeros_like(self.counts).scatter_add(0, labels.to(torch.int64), ones)

    def compute(self) -> torch.Tensor:
        return self.counts.sum(dtype=torch.int32)


def sharded_tenant_set(classes: int = 8) -> Dict[str, Any]:
    """A TenantSet whose template holds a placed ConfusionMatrix and an
    unplaced ShardedCounts, against independent metrics on the same streams
    (every rank feeds the same rows: a placed update is a collective)."""
    cm = mt.ConfusionMatrix(num_classes=classes, device="cpu").shard_state(shard.mesh())
    reason = classify_tenant_member(cm)[1]
    ts = mt.TenantSet(mt.MetricCollection({"cm": cm, "counts": ShardedCounts(classes, device="cpu")}), capacity=4)
    paths = {k: v["path"] for k, v in ts.partition_view()["tenant"].items()}
    tenants = ["a", "b", "c"]
    for t in tenants:
        ts.admit(t)
    refs = {t: mt.ConfusionMatrix(num_classes=classes, device="cpu") for t in tenants}
    ref_counts = {t: ShardedCounts(classes, device="cpu") for t in tenants}
    for step in range(2):
        rng = np.random.default_rng(step)
        preds = torch.from_numpy(rng.integers(0, classes, (3, 32)))
        target = torch.from_numpy(rng.integers(0, classes, (3, 32)))
        ts.update(tenants, preds, target)
        for i, t in enumerate(tenants):
            refs[t].update(preds[i], target[i])
            ref_counts[t].update(preds[i])
    out = ts.compute(tenants)
    results = {}
    for t in tenants:
        # the unplaced reference syncs its partials over the world, as the
        # placed member's blocks hold the ranks' sum; the stacked counts are
        # this rank's, as the reference's unsynced compute
        results[f"{t}.cm"] = (to_numpy(out[t]["cm"]), to_numpy(refs[t].compute()))
        results[f"{t}.counts"] = (to_numpy(out[t]["counts"]),
                                  to_numpy(ref_counts[t].compute_state(ref_counts[t].get_state())))
    return {"reason": reason, "paths": paths, "eager_updates": ts.stats.eager_tenant_updates, "results": results}


# --------------------------------------------------------------------------- #
# checkpoint bodies
# --------------------------------------------------------------------------- #
def save_placed(spec: Tuple[str, Dict[str, Any]], batches: Sequence[tuple], root: str,
                sizes: Sequence[int] = (4,), names: Sequence[str] = ("data",)) -> Dict[str, Any]:
    """Place ``spec`` over the mesh, update with this rank's batches, save
    (every rank at once); returns its compute and whether this rank saw the
    snapshot committed."""
    axis = names[0] if len(names) == 1 else tuple(names)
    metric = shard.build(spec).shard_state(shard.mesh(sizes, names), axis_name=axis)
    for batch in batches:
        metric.update(*(torch.from_numpy(np.asarray(x)) for x in batch))
    want = metric.compute()
    handle = save_checkpoint(metric, root, step=1)
    dist.barrier()  # every shard written and the snapshot committed
    return {"compute": to_numpy(want), "committed": handle.committed}


def restore_into(spec: Tuple[str, Dict[str, Any]], root: str, placed: bool,
                 sizes: Sequence[int] = (4,), names: Sequence[str] = ("data",)) -> Dict[str, Any]:
    """Restore a snapshot into ``spec`` on every rank, placed or replicated;
    returns its compute and the shape of each state leaf on this rank."""
    metric = shard.build(spec)
    if placed:
        axis = names[0] if len(names) == 1 else tuple(names)
        metric.shard_state(shard.mesh(sizes, names), axis_name=axis)
    info = restore_checkpoint(metric, root)
    return {
        "compute": to_numpy(metric.compute()),
        "shapes": {k: tuple(v.shape) for k, v in metric.get_state().items() if isinstance(v, torch.Tensor)},
        "shards_loaded": info.shards_loaded,
    }
