"""Metric state sync over ``torch.distributed`` process groups.

Counterpart of the core of ``metrics_tpu/parallel/sync.py``. Where the JAX
package names a mesh axis, the port takes a ``ProcessGroup``; where it emits
``psum``/``pmean``/``pmax``/``pmin``/``all_gather`` inside a ``shard_map``,
the port runs one eager collective:

- ``sum``, ``max`` and ``min`` states are one ``all_reduce``; ``mean`` is a
  SUM ``all_reduce`` divided by the group's size (gloo has no AVG);
- ``cat`` states are a ragged gather: the ranks exchange their shapes (one
  ``all_gather`` of a small int64 tensor, counted as ``size_exchange``), pad
  to the largest row count, ``all_gather`` and trim, in rank-major order;
- ``None`` stacks the ranks' values and a callable applies to the stack.

By default the leaves of a state are coalesced by ``(reduction, dtype)`` into
one flat buffer per bucket and one collective each (``_sync_bucketed``), as in
the JAX package; ``CatBuffer`` states gather their fill counts and overflow
flags in one ``all_gather`` and their payloads in one per dtype
(``_sync_bucketed_catbuffers``). Bools cross the wire as int32, since gloo
reduces no bool.

``group=None`` is the identity: outside a multi-process run there is
nothing to sync. Unlike ``shard_map``, where every device runs one trace, the
ranks here run their own Python: every rank must call the same syncs in the
same order, with states of the same names, dtypes and number of dimensions.
An empty ``cat`` list or an unmaterialized ``CatBuffer`` passes through
unchanged, as in the JAX package, so a rank that never appended to such a
state must not sync it while others do.

Not ported: transports and codecs, incremental sync, sharded and resharded
state, sketches and tenant-stacked sync.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch import Tensor

from metrics_tpu_torch.core.buffers import CatBuffer

Group = Optional[dist.ProcessGroup]
Reduction = Optional[Union[str, Callable]]

_REDUCTIONS = ("sum", "mean", "max", "min", "cat", None)
_ELEMENTWISE = ("sum", "mean", "max", "min")
_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}

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
# collective counting
# --------------------------------------------------------------------------- #
_counter = threading.local()


@contextlib.contextmanager
def count_collectives() -> Iterator[Dict[str, Any]]:
    """Count the collectives this module issues while the block runs.

    Yields a dict: ``count``, ``by_kind`` (``all_reduce``, ``all_gather``,
    ``size_exchange``), ``bytes`` and ``bytes_by_kind``, the payload bytes
    each rank puts into the collectives. The JAX package counts at trace
    time; the port counts the collectives it runs. The shape exchanges of
    ragged ``cat`` gathers have a kind of their own, so the payload
    collectives compare with the JAX package's kind for kind (``psum``,
    ``pmean``, ``pmax`` and ``pmin`` are each an ``all_reduce`` here). Boxes
    nest: every open box sees every collective.
    """
    stack = getattr(_counter, "stack", None)
    if stack is None:
        stack = _counter.stack = []
    box: Dict[str, Any] = {"count": 0, "by_kind": {}, "bytes": 0, "bytes_by_kind": {}}
    stack.append(box)
    try:
        yield box
    finally:
        popped = stack.pop()
        assert popped is box


def _tick(kind: str, wire: Tensor) -> None:
    nbytes = wire.numel() * wire.element_size()
    for box in getattr(_counter, "stack", None) or ():
        box["count"] += 1
        box["by_kind"][kind] = box["by_kind"].get(kind, 0) + 1
        box["bytes"] += nbytes
        box["bytes_by_kind"][kind] = box["bytes_by_kind"].get(kind, 0) + nbytes


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


def _all_reduce(x: Tensor, reduction: str, group: dist.ProcessGroup) -> Tensor:
    wire = _to_wire(x)
    _tick("all_reduce", wire)
    dist.all_reduce(wire, op=_REDUCE_OPS[reduction], group=group)
    if reduction == "mean":
        return wire / dist.get_world_size(group)
    if x.dtype == torch.bool and reduction != "sum":
        return wire.to(torch.bool)
    return wire


def _all_gather(x: Tensor, group: dist.ProcessGroup, kind: str = "all_gather") -> List[Tensor]:
    """Every rank's ``x`` (equal shapes), in rank order."""
    wire = _to_wire(x)
    _tick(kind, wire)
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


def _sync_bucketed(entries: List[Tuple[str, Tensor, Reduction]], group: dist.ProcessGroup) -> Dict[str, Tensor]:
    """One collective per ``(reduction, dtype)`` bucket (plus one shape
    exchange for a ``cat`` bucket): the bucket's leaves are flattened with
    ``torch.cat`` and unflattened by offsets, bitwise equal to the per-leaf
    path. A singleton bucket goes straight through :func:`sync_array`."""
    out: Dict[str, Tensor] = {}
    buckets: Dict[Tuple[Reduction, torch.dtype], List[Tuple[str, Tensor]]] = {}
    for name, x, red in entries:
        buckets.setdefault((red, x.dtype), []).append((name, x))
    for (red, _dtype), items in buckets.items():
        if len(items) == 1:
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
    """``CatBuffer`` states: the fill counts and overflow flags of every
    buffer in one ``all_gather``, then the payloads in one per dtype, each
    buffer padded to the largest rank's count (ranks may hold different
    capacities, since eager buffers grow geometrically). Each buffer comes
    back compacted, its rows in rank-major order, its overflow flag or-ed
    across ranks."""
    n = len(entries)
    device = entries[0][1].data.device
    meta = torch.tensor([b.count for _, b in entries] + [int(b.overflowed) for _, b in entries], dtype=torch.int32, device=device)
    gmeta = torch.stack(_all_gather(meta, group)).cpu()  # (world, 2n)
    world = gmeta.shape[0]
    max_counts = gmeta[:, :n].amax(dim=0).tolist()
    out: Dict[str, CatBuffer] = {}
    buckets: Dict[torch.dtype, List[Tuple[int, str, CatBuffer]]] = {}
    for i, (name, buf) in enumerate(entries):
        buckets.setdefault(buf.data.dtype, []).append((i, name, buf))
    for items in buckets.values():
        if not any(max_counts[i] for i, _, _ in items):
            out.update((name, buf.copy()) for _, name, buf in items)
            continue
        flat = torch.cat([_pad_rows(buf.data[: buf.count], max_counts[i]).reshape(-1) for i, _, buf in items])
        gathered = _all_gather(flat, group)
        offset = 0
        for i, name, buf in items:
            m, item = max_counts[i], buf.data.shape[1:]
            size = m * int(item.numel())
            data = torch.stack([g[offset : offset + size].view(m, *item) for g in gathered]).reshape(world * m, *item)
            offset += size
            counts = gmeta[:, i]
            valid = (torch.arange(m)[None, :] < counts[:, None]).reshape(-1).to(device)
            overflowed = bool(gmeta[:, n + i].any())
            out[name] = CatBuffer._compact(data, valid, int(counts.sum()), overflowed)
    return out


def sync_state(
    state: Dict[str, Any],
    reductions: Dict[str, Reduction],
    group: Group,
    bucketed: Optional[bool] = None,
) -> Dict[str, Any]:
    """Sync a whole state dict over ``group`` by each state's reduction tag.

    ``cat`` list states are concatenated locally first, so each costs one
    gather, and come back as a one-element container of the input's type.
    ``bucketed`` (default: :func:`bucketed_sync_enabled`) coalesces the
    leaves by ``(reduction, dtype)``; materialized ``CatBuffer`` states join
    their own bucket; callables always sync per leaf. ``group=None`` returns
    the state unchanged.
    """
    if group is None:
        return dict(state)
    if bucketed is None:
        bucketed = bucketed_sync_enabled()
    out: Dict[str, Any] = {}
    entries: List[Tuple[str, Tensor, Reduction]] = []
    buf_entries: List[Tuple[str, CatBuffer]] = []
    rewrap: Dict[str, type] = {}
    for name, val in state.items():
        red = reductions.get(name)
        if isinstance(val, CatBuffer):
            if red not in ("cat", None):
                raise ValueError(f"CatBuffer state {name!r} only supports dist_reduce_fx 'cat'/None, got {red!r}")
            if not val.materialized:
                out[name] = val
            elif bucketed:
                buf_entries.append((name, val))
            else:
                out[name] = val.gather(group)
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
            out[name] = sync_array(val, red, group, name)
    if entries:
        out.update(_sync_bucketed(entries, group))
    if buf_entries:
        out.update(_sync_bucketed_catbuffers(buf_entries, group))
    for name, container in rewrap.items():
        out[name] = container((out[name],))
    return {name: out[name] for name in state}


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
