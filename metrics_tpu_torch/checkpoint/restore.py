"""Restore, verification, and reshard-on-restore shard folding.

Counterpart of ``metrics_tpu/checkpoint/restore.py``. Folded leaves are
tensors on the live metric's device (a restore never falls back to the
CPU), and a metric placed by ``shard_state`` gets its sharded leaves placed
again from the folded partials (each rank keeps its block; a collective of
every rank of the placement).

Restore is strictly two-pass: every check (commit marker, manifest version,
checksums, fingerprint diff) and every shard fold happens on host-side numpy
state *before* the live object is touched. Only when the complete folded state
exists is it applied, after which the object's dispatch memos are invalidated
(``_computed`` memos, the engines' :class:`~metrics_tpu_torch.core.engine._SigCache`
state-signature memos, the alias bookkeeping) so a captured step never
replays against a stale state tensor: the next call copies the restored
leaves into its static buffers.

**Reshard-on-restore**: a checkpoint written by N hosts (N shards) restores
onto M hosts for any M by assigning shards round-robin — host ``i`` of ``M``
folds shards ``{i, i+M, i+2M, …}`` with each leaf's recorded reduction:
``sum`` adds, ``max``/``min`` take the elementwise extremum,
``cat``/``CatBuffer``/list states concatenate in shard order, and ``mean``
is recomputed from the recorded per-shard update counts. The fold is the
metric's own :meth:`~metrics_tpu_torch.Metric.merge_states` — the same primitive
that backs cross-batch accumulation and cross-rank sync — so a folded
restore is bitwise-identical to having accumulated on fewer hosts from the
start for all mergeable reductions.

**The reshard plan**: shard folding is *streamed*, never gathered. Before any
payload is read, the manifest metadata is compiled into an explicit
:class:`ReshardPlan` — a load → fold → free step sequence per assigned shard
with byte estimates — and the executor walks it one shard at a time, merging
into the running fold and dropping each payload before loading the next. Peak
host memory is bounded by O(folded state + one transfer block) instead of the
gather-everything O(sum of assigned payloads + state); the plan, both modeled
peaks, and the measured resident peak are surfaced on :class:`RestoreInfo`.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from metrics_tpu_torch.checkpoint import io as _io
from metrics_tpu_torch.checkpoint.format import (
    SELF_KEY,
    describe,
    fingerprint_diff,
    object_fingerprint,
    tag_mergeable,
)
from metrics_tpu_torch.core.buffers import CatBuffer
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.observability import tracer as _otrace
from metrics_tpu_torch.observability.instruments import REGISTRY as _REGISTRY
from metrics_tpu_torch.sketches import SKETCH_CLASSES
from metrics_tpu_torch.utils.prints import rank_zero_warn


@dataclass
class ReshardPlan:
    """Minimal-collective fold schedule for one host's assigned shards.

    Compiled from manifest metadata alone (no payload reads): per shard a
    ``load`` (npz into host memory, transfer-block bytes), a ``fold`` (merge
    into the running state; bytes = modeled resident folded state after the
    merge) and a ``free`` (payload dropped). ``plan_peak_bytes`` is the
    modeled streaming peak — max over steps of folded state + the one live
    transfer block; ``gather_peak_bytes`` models the load-everything
    alternative that holds every assigned payload while folding.
    """

    world_size: int                 # shards the checkpoint was written with
    shards: Tuple[int, ...]         # this host's assigned shard indices
    steps: List[Dict[str, Any]] = field(default_factory=list)
    plan_peak_bytes: int = 0
    gather_peak_bytes: int = 0


@dataclass
class RestoreInfo:
    """What a restore actually did (returned by ``restore_checkpoint``)."""

    root: str
    step: int
    world_size: int            # hosts that wrote the checkpoint
    shards_loaded: Tuple[int, ...]  # shard indices folded into this host
    host_index: int
    host_count: int
    # wall seconds per phase: verify_s (manifest/fingerprint/checksum checks +
    # host-side shard load/fold — everything before live state is touched) and
    # apply_s (folded state applied + dispatch invalidation)
    timings: Dict[str, float] = field(default_factory=dict)
    # newest committed step that failed verification when this restore fell
    # back to an older verifiable one (None on the normal path)
    fallback_from: Optional[int] = None
    # the executed fold schedule (None for tenant-set restores, which load
    # exactly one host-local shard and never fold)
    reshard_plan: Optional[ReshardPlan] = None
    # convenience mirrors of the plan's modeled peaks plus the *observed*
    # resident peak (payload + folded state bytes) during the streaming fold
    plan_peak_bytes: int = 0
    gather_peak_bytes: int = 0
    measured_peak_bytes: int = 0


@dataclass
class VerifyReport:
    """Result of verifying one snapshot."""

    root: str
    step: int
    ok: bool
    world_size: int = 0
    shards: int = 0
    issues: List[str] = field(default_factory=list)


# --------------------------------------------------------------------------- #
# shard decoding + folding (no live object involved)
# --------------------------------------------------------------------------- #
def _decode_member_state(
    payload: Dict[str, np.ndarray], member_key: str, leaves: Dict[str, Any], device: Any = "cpu"
) -> Dict[str, Any]:
    """Rebuild one member's state dict from a shard's payload, as tensors
    on ``device``."""
    prefix = "" if member_key == SELF_KEY else f"{member_key}."
    state: Dict[str, Any] = {}

    def tensor(arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.require(arr, requirements="C")).to(device)

    for name, meta in leaves.items():
        key = prefix + name
        kind = meta["kind"]
        if kind == "array":
            if key not in payload:
                raise _io.CheckpointCorruptError(f"payload key {key!r} missing from shard")
            state[name] = tensor(payload[key])
        elif kind == "list":
            items = [tensor(payload[f"{key}.{i}"]) for i in range(meta["length"])]
            state[name] = tuple(items) if meta.get("container") == "tuple" else items
        elif kind == "catbuffer":
            if not meta.get("materialized", False):
                state[name] = CatBuffer.empty(meta["capacity"], device=device)
            else:
                arr = tensor(payload[key])
                cap = max(int(meta["capacity"]), int(arr.shape[0]), 1)
                state[name] = (
                    CatBuffer.empty(cap, device=device) if arr.shape[0] == 0 else CatBuffer.from_array(arr, capacity=cap)
                )
        elif kind == "sketch":
            cls = SKETCH_CLASSES.get(meta.get("sketch_class", ""))
            if cls is None:
                raise _io.CheckpointCorruptError(
                    f"unknown sketch class {meta.get('sketch_class')!r} for {key!r}"
                )
            sketch = cls.from_config(meta.get("config") or {}, device=device)
            comps = {}
            for fname, _ in sketch.component_reductions():
                fkey = f"{key}.{fname}"
                if fkey not in payload:
                    raise _io.CheckpointCorruptError(f"payload key {fkey!r} missing from shard")
                comps[fname] = tensor(payload[fkey])
            state[name] = sketch.replace(**comps)
        else:
            raise _io.CheckpointCorruptError(f"unknown leaf kind {kind!r} for {key!r}")
    return state


def _check_foldable(leaves: Dict[str, Any], n_shards: int, member_key: str) -> None:
    if n_shards <= 1:
        return
    for name, meta in leaves.items():
        if not tag_mergeable(meta["reduction"], meta["kind"]):
            raise _io.CheckpointMismatchError(
                f"state {member_key}.{name} (reduction {meta['reduction']!r}, kind "
                f"{meta['kind']!r}) cannot be folded across shards; restore with the "
                "same host count the checkpoint was written with, or merge offline "
                "after replacing the reduction"
            )


def fold_member_shards(
    metric: Metric,
    member_key: str,
    shard_states: List[Dict[str, Any]],
    shard_counts: List[int],
    leaves: Dict[str, Any],
) -> Tuple[Dict[str, Any], int]:
    """Fold shard states with the metric's own merge semantics.

    Returns ``(folded_state, total_update_count)``. A single shard passes
    through untouched (the N==M fast path).
    """
    _check_foldable(leaves, len(shard_states), member_key)
    state, count = shard_states[0], shard_counts[0]
    for incoming, inc_count in zip(shard_states[1:], shard_counts[1:]):
        state = metric.merge_states(state, incoming, (count, inc_count))
        count += inc_count
    return state, count


def _entry_decoded_bytes(entry: Dict[str, Any]) -> Tuple[int, int]:
    """``(dense_bytes, concat_bytes)`` decoded-state estimate for one shard.

    Dense mergeable leaves (sum/mean/max/min arrays) keep their shape across
    folds — one resident copy regardless of shard count; concatenating leaves
    (``cat`` arrays, materialized CatBuffer prefixes) accumulate per shard.
    List-leaf element shapes live only in the payload, so they are covered by
    the transfer-block term (the manifest's npz ``bytes``), not the state term.
    """
    dense = 0
    concat = 0
    for mmeta in entry["members"].values():
        for meta in (mmeta.get("leaves") or {}).values():
            kind = meta["kind"]
            if kind == "array":
                n = 1
                for s in meta["shape"]:
                    n *= int(s)
                nb = n * np.dtype(meta["dtype"]).itemsize
                if meta["reduction"] == "cat":
                    concat += nb
                else:
                    dense += nb
            elif kind == "catbuffer" and meta.get("materialized"):
                n = int(meta["count"])
                for s in meta.get("item_shape", []):
                    n *= int(s)
                concat += n * np.dtype(meta["dtype"]).itemsize
            elif kind == "sketch":
                # fixed-size by construction; folds keep one resident copy
                cls = SKETCH_CLASSES.get(meta.get("sketch_class", ""))
                if cls is not None:
                    dense += cls.from_config(meta.get("config") or {}, device="cpu").state_nbytes
    return dense, concat


def build_reshard_plan(manifest: Dict[str, Any], shards: Tuple[int, ...]) -> ReshardPlan:
    """Compile the streaming fold schedule for ``shards`` from the manifest.

    Pure metadata: byte figures come from the recorded npz sizes and per-leaf
    shape/dtype entries, so the plan (and its peak bound) exists before any
    payload I/O happens.
    """
    entries = {int(s["shard_index"]): s for s in manifest["shards"]}
    steps: List[Dict[str, Any]] = []
    dense = 0
    concat_cum = 0
    plan_peak = 0
    payload_total = 0
    for idx in shards:
        entry = entries[idx]
        nbytes = int(entry["bytes"])
        payload_total += nbytes
        d, c = _entry_decoded_bytes(entry)
        dense = max(dense, d)
        concat_cum += c
        steps.append({"op": "load", "shard": idx, "bytes": nbytes})
        steps.append({"op": "fold", "shard": idx, "bytes": dense + concat_cum})
        steps.append({"op": "free", "shard": idx, "bytes": nbytes})
        plan_peak = max(plan_peak, dense + concat_cum + nbytes)
    return ReshardPlan(
        world_size=int(manifest["world_size"]),
        shards=tuple(shards),
        steps=steps,
        plan_peak_bytes=plan_peak,
        gather_peak_bytes=payload_total + dense + concat_cum,
    )


def _nbytes(x: Any) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _state_resident_nbytes(state: Dict[str, Any]) -> int:
    """Resident host/device bytes of one decoded or folded member state."""
    total = 0
    for val in state.values():
        if isinstance(val, CatBuffer):
            if val.materialized:
                total += _nbytes(val.data)
        elif isinstance(val, (list, tuple)):
            total += sum(_nbytes(v) for v in val)
        else:
            total += _nbytes(val)
    return total


def assign_shards(world_size: int, host_index: int, host_count: int) -> Tuple[int, ...]:
    """Round-robin shard ownership for reshard-on-restore."""
    if host_count <= 0:
        raise _io.CheckpointError(f"host_count must be positive, got {host_count}")
    if not (0 <= host_index < host_count):
        raise _io.CheckpointError(f"host_index {host_index} out of range for host_count {host_count}")
    return tuple(range(host_index, world_size, host_count))


# --------------------------------------------------------------------------- #
# the live-object restore
# --------------------------------------------------------------------------- #
def process_position() -> Tuple[int, int]:
    """``(rank, world size)`` of the default ``torch.distributed`` group, or
    ``(0, 1)`` when none is up: the default host index and count of a
    restore, and the default shard index and world size of a save."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def restore_checkpoint(
    obj: Any,
    root: str,
    step: Optional[int] = None,
    *,
    host_index: Optional[int] = None,
    host_count: Optional[int] = None,
    verify_payload: bool = True,
    fallback_to_verified: bool = True,
) -> RestoreInfo:
    """Load a committed snapshot into a live Metric / MetricCollection.

    ``host_index``/``host_count`` default to the ``torch.distributed`` rank
    and world size when a group is up, else 0 and 1; pass them explicitly
    to reshard (e.g.
    ``host_count=1`` folds every shard into this process). All verification
    and folding completes before any live state is replaced.

    **Graceful degradation**: when ``step`` is ``None`` (restore-latest) and
    the newest committed step fails checksum/manifest verification, the
    restore walks older committed steps — newest first — and loads the
    latest *verifiable* one instead of raising (``fallback_to_verified=False``
    restores the old raise-on-first-corruption behavior). The skipped step is
    recorded in ``RestoreInfo.fallback_from``, warned about, counted in
    ``metrics_tpu_checkpoint_restore_fallbacks_total``, and traced as a
    ``checkpoint/restore/fallback`` event. An explicitly requested ``step``
    never falls back, and fingerprint mismatches (wrong live object) are
    never skipped — only corruption is.
    """
    rank, world = process_position()
    host_index = rank if host_index is None else host_index
    host_count = world if host_count is None else host_count

    if getattr(obj, "_is_tenant_set", False):
        return _restore_tenant_set(
            obj, root, step,
            host_index=host_index, host_count=host_count,
            verify_payload=verify_payload,
            fallback_to_verified=fallback_to_verified,
        )

    t0 = time.perf_counter()
    requested = step
    if requested is None and fallback_to_verified:
        candidates = sorted(_io.available_steps(root), reverse=True)
        if not candidates:
            raise _io.CheckpointNotFoundError(f"no committed checkpoint under {root!r}")
    else:
        candidates = [_io.resolve_step(root, requested)]

    kind, members = describe(obj)
    live_fp = object_fingerprint(obj)

    # pass 1: load + fold on host memory; the live object is untouched. Only
    # *corruption* moves on to the next (older) candidate — a fingerprint
    # mismatch or missing step raises straight out.
    first_err: Optional[_io.CheckpointCorruptError] = None
    fallback_from: Optional[int] = None
    for attempt_i, cand in enumerate(candidates):
        try:
            manifest = _io.read_manifest(root, cand)
            diff = fingerprint_diff(manifest["fingerprint"], live_fp)
            if diff:
                raise _io.CheckpointMismatchError(
                    f"checkpoint step {cand} under {root!r} does not match the live "
                    f"{type(obj).__name__}; refusing to restore. Diff (checkpoint vs live):\n  "
                    + "\n  ".join(diff)
                )
            world_size = int(manifest["world_size"])
            mine = assign_shards(world_size, host_index, host_count)
            shard_entries = {int(s["shard_index"]): s for s in manifest["shards"]}
            plan = build_reshard_plan(manifest, mine)
            folded: Dict[str, Tuple[Dict[str, Any], int]] = {}
            first_entry: Optional[Dict[str, Any]] = None
            measured_peak = 0
            # walk the plan: load one shard, fold it into every member's
            # running state, free the payload before the next load. The merge
            # order matches :func:`fold_member_shards` left-to-right, so the
            # streamed result is bitwise-identical to the gather-everything
            # fold — only the peak host footprint changes
            for idx in mine:
                entry = shard_entries[idx]
                payload = _io.load_shard_payload(root, cand, entry, verify=verify_payload)
                if first_entry is None:
                    first_entry = entry
                payload_nbytes = sum(int(a.nbytes) for a in payload.values())
                for key, metric in members.items():
                    mmeta = entry["members"][key]
                    leaves = mmeta["leaves"]
                    incoming = _decode_member_state(payload, key, leaves, metric.device)
                    inc_count = int(mmeta["update_count"])
                    if key not in folded:
                        _check_foldable(leaves, len(mine), key)
                        folded[key] = (incoming, inc_count)
                    else:
                        state0, count0 = folded[key]
                        folded[key] = (
                            metric.merge_states(state0, incoming, (count0, inc_count)),
                            count0 + inc_count,
                        )
                resident = payload_nbytes + sum(
                    _state_resident_nbytes(s) for s, _ in folded.values()
                )
                measured_peak = max(measured_peak, resident)
                del payload
            for key, metric in members.items():
                if key not in folded:
                    # more restore hosts than shards: this host starts from
                    # the defaults (of the unplaced metric: they are partials)
                    folded[key] = (metric._unplaced_init_state(), 0)
            step = cand
            break
        except _io.CheckpointCorruptError as err:
            if first_err is None:
                first_err, fallback_from = err, cand
            if attempt_i + 1 >= len(candidates):
                raise  # nothing older verifies: surface the (newest) failure
            rank_zero_warn(
                f"checkpoint step {cand} under {root!r} failed verification "
                f"({type(err).__name__}: {err}); falling back to an older committed step"
            )
    if fallback_from is not None:
        _REGISTRY.counter(
            "checkpoint_restore_fallbacks_total",
            "Restores that skipped a corrupt newest step for an older verifiable one.",
        ).inc()
        if _otrace.active:
            _otrace.emit_instant(
                "checkpoint/restore/fallback", "checkpoint",
                from_step=int(fallback_from), to_step=int(step),
                error=f"{type(first_err).__name__}: {str(first_err)[:160]}",
            )
    t1 = time.perf_counter()
    if _otrace.active:
        _otrace.emit_complete(
            "checkpoint/restore/verify", "checkpoint",
            int(t0 * 1e6), int((t1 - t0) * 1e6),
            step=step, shards=len(mine), world_size=world_size,
        )

    # pass 2: apply + invalidate dispatch state
    for key, metric in members.items():
        state, count = folded[key]
        metric.set_state(state)
        if metric.state_sharding is not None:
            # folded leaves are partials of the unplaced state: place them
            # again, so each rank keeps its block (a collective)
            metric._place_partials(state)
        if first_entry is not None:
            # update-determined python config (Accuracy.mode, ...); identical
            # across shards (the committer pinned the fingerprints equal and
            # mixed input modes raise at update time)
            for aux_name, aux_val in (first_entry["members"][key].get("aux") or {}).items():
                setattr(metric, aux_name, aux_val)
        metric._update_count = count
        metric._is_synced = False
        metric._cache = None
        metric._shared_state_ids = frozenset()
        metric._invalidate_dispatch()
    if kind == "collection":
        obj._members_stale = False
        # group members share their leader's restored tensors, as after an
        # update (the engines never write shared tensors in place)
        for group in obj._groups:
            if len(group) > 1:
                obj._share_leader_state(group)
        obj._invalidate_dispatch()
    t2 = time.perf_counter()
    if _otrace.active:
        _otrace.emit_complete(
            "checkpoint/restore/apply", "checkpoint",
            int(t1 * 1e6), int((t2 - t1) * 1e6),
            step=step, members=len(members),
        )
    return RestoreInfo(
        root=root,
        step=step,
        world_size=world_size,
        shards_loaded=mine,
        host_index=host_index,
        host_count=host_count,
        timings={"verify_s": t1 - t0, "apply_s": t2 - t1, "total_s": t2 - t0},
        fallback_from=fallback_from,
        reshard_plan=plan,
        plan_peak_bytes=plan.plan_peak_bytes,
        gather_peak_bytes=plan.gather_peak_bytes,
        measured_peak_bytes=measured_peak,
    )


def _restore_tenant_set(
    obj: Any,
    root: str,
    step: Optional[int],
    *,
    host_index: int,
    host_count: int,
    verify_payload: bool,
    fallback_to_verified: bool,
) -> RestoreInfo:
    """Restore a :class:`~metrics_tpu_torch.tenancy.TenantSet` from its snapshot.

    Tenant slots are host-local (each host's set serves its own tenants), so
    there is no cross-shard fold: this host loads exactly the shard written by
    its ``host_index``. A world-size change therefore refuses — re-partition
    tenants explicitly with ``export_tenant``/``import_tenant`` instead.
    Fingerprint gating and the corruption-fallback walk match the Metric path.
    """
    t0 = time.perf_counter()
    requested = step
    if requested is None and fallback_to_verified:
        candidates = sorted(_io.available_steps(root), reverse=True)
        if not candidates:
            raise _io.CheckpointNotFoundError(f"no committed checkpoint under {root!r}")
    else:
        candidates = [_io.resolve_step(root, requested)]
    live_fp = obj.fingerprint()
    first_err: Optional[_io.CheckpointCorruptError] = None
    fallback_from: Optional[int] = None
    for attempt_i, cand in enumerate(candidates):
        try:
            manifest = _io.read_manifest(root, cand)
            diff = fingerprint_diff(manifest["fingerprint"], live_fp)
            if diff:
                raise _io.CheckpointMismatchError(
                    f"checkpoint step {cand} under {root!r} does not match the live "
                    f"TenantSet; refusing to restore. Diff (checkpoint vs live):\n  "
                    + "\n  ".join(diff)
                )
            world_size = int(manifest["world_size"])
            if world_size != host_count:
                raise _io.CheckpointMismatchError(
                    f"TenantSet checkpoint step {cand} was written by {world_size} "
                    f"host(s) but is being restored onto {host_count}: tenant slots "
                    "are host-local and cannot be folded — move individual tenants "
                    "with export_tenant()/import_tenant() instead."
                )
            entry = next(
                s for s in manifest["shards"] if int(s["shard_index"]) == host_index
            )
            payload = _io.load_shard_payload(root, cand, entry, verify=verify_payload)
            step = cand
            break
        except _io.CheckpointCorruptError as err:
            if first_err is None:
                first_err, fallback_from = err, cand
            if attempt_i + 1 >= len(candidates):
                raise
            rank_zero_warn(
                f"checkpoint step {cand} under {root!r} failed verification "
                f"({type(err).__name__}: {err}); falling back to an older committed step"
            )
    if fallback_from is not None:
        _REGISTRY.counter(
            "checkpoint_restore_fallbacks_total",
            "Restores that skipped a corrupt newest step for an older verifiable one.",
        ).inc()
        if _otrace.active:
            _otrace.emit_instant(
                "checkpoint/restore/fallback", "checkpoint",
                from_step=int(fallback_from), to_step=int(step),
                error=f"{type(first_err).__name__}: {str(first_err)[:160]}",
            )
    t1 = time.perf_counter()
    if _otrace.active:
        _otrace.emit_complete(
            "checkpoint/restore/verify", "checkpoint",
            int(t0 * 1e6), int((t1 - t0) * 1e6),
            step=step, shards=1, world_size=world_size,
        )
    obj._apply_snapshot(payload, entry["members"])
    t2 = time.perf_counter()
    if _otrace.active:
        _otrace.emit_complete(
            "checkpoint/restore/apply", "checkpoint",
            int(t1 * 1e6), int((t2 - t1) * 1e6),
            step=step, members=1,
        )
    return RestoreInfo(
        root=root,
        step=step,
        world_size=world_size,
        shards_loaded=(host_index,),
        host_index=host_index,
        host_count=host_count,
        timings={"verify_s": t1 - t0, "apply_s": t2 - t1, "total_s": t2 - t0},
        fallback_from=fallback_from,
    )


# --------------------------------------------------------------------------- #
# verification (no live object needed)
# --------------------------------------------------------------------------- #
def verify_checkpoint(root: str, step: Optional[int] = None) -> VerifyReport:
    """Structural + checksum verification of one committed snapshot."""
    try:
        step = _io.resolve_step(root, step)
    except _io.CheckpointError as err:
        return VerifyReport(root=root, step=-1 if step is None else step, ok=False, issues=[str(err)])
    report = VerifyReport(root=root, step=step, ok=True)
    try:
        manifest = _io.read_manifest(root, step)
    except _io.CheckpointError as err:
        report.ok = False
        report.issues.append(str(err))
        return report
    report.world_size = int(manifest["world_size"])
    report.shards = len(manifest["shards"])
    if report.shards != report.world_size:
        report.ok = False
        report.issues.append(
            f"manifest lists {report.shards} shards but world_size is {report.world_size}"
        )
    for entry in manifest["shards"]:
        try:
            payload = _io.load_shard_payload(root, step, entry, verify=True)
        except _io.CheckpointError as err:
            report.ok = False
            report.issues.append(str(err))
            continue
        # every manifest leaf must be present in the payload (tenant_set
        # shards carry a slot table instead of per-member leaves metadata —
        # the checksum pass above already covered their payload)
        for member_key, mmeta in entry["members"].items():
            if "leaves" not in mmeta:
                continue
            try:
                _decode_member_state(payload, member_key, mmeta["leaves"])
            except _io.CheckpointError as err:
                report.ok = False
                report.issues.append(f"shard {entry['shard_index']}: {err}")
    return report


def verify_all(root: str) -> List[VerifyReport]:
    return [verify_checkpoint(root, s) for s in _io.available_steps(root)]


# --------------------------------------------------------------------------- #
# offline shard merge (the CLI `merge` subcommand)
# --------------------------------------------------------------------------- #
def _merge_leaf_offline(
    meta: Dict[str, Any],
    values: List[Any],
    counts: List[int],
) -> Any:
    """Numpy-only fold of one leaf across shards by its recorded reduction."""
    tag, kind = meta["reduction"], meta["kind"]
    if kind == "list":
        out: List[np.ndarray] = []
        for v in values:
            out.extend(v)
        return out
    if kind == "catbuffer":
        mats = [v for v in values if v is not None]
        return np.concatenate(mats, axis=0) if mats else None
    if tag == "sum":
        out = values[0]
        for v in values[1:]:
            out = out + v
        return out
    if tag == "max":
        out = values[0]
        for v in values[1:]:
            out = np.maximum(out, v)
        return out
    if tag == "min":
        out = values[0]
        for v in values[1:]:
            out = np.minimum(out, v)
        return out
    if tag == "mean":
        total = max(sum(counts), 1)
        acc = np.zeros_like(np.asarray(values[0], dtype=np.result_type(values[0], np.float64)))
        for v, n in zip(values, counts):
            acc = acc + np.asarray(v) * n
        return (acc / total).astype(np.asarray(values[0]).dtype)
    if tag == "cat":
        return np.concatenate([np.atleast_1d(v) for v in values], axis=0)
    raise _io.CheckpointMismatchError(
        f"cannot merge leaves with reduction {tag!r} offline (kind {kind!r})"
    )


def merge_shards(root: str, out_root: str, step: Optional[int] = None, out_step: Optional[int] = None) -> int:
    """Fold an N-shard snapshot into a committed 1-shard snapshot at
    ``out_root`` (offline reshard; no live metric objects needed). Returns the
    written step."""
    step = _io.resolve_step(root, step)
    manifest = _io.read_manifest(root, step)
    out_step = step if out_step is None else out_step
    entries = sorted(manifest["shards"], key=lambda s: s["shard_index"])
    payloads = [_io.load_shard_payload(root, step, e, verify=True) for e in entries]

    merged_payload: Dict[str, np.ndarray] = {}
    merged_members: Dict[str, Any] = {}
    member_keys = entries[0]["members"].keys()
    for member_key in member_keys:
        prefix = "" if member_key == SELF_KEY else f"{member_key}."
        leaves = entries[0]["members"][member_key]["leaves"]
        counts = [int(e["members"][member_key]["update_count"]) for e in entries]
        merged_leaves: Dict[str, Any] = {}
        for name, meta in leaves.items():
            key = prefix + name
            kind = meta["kind"]
            if kind == "list":
                values = [
                    [p[f"{key}.{i}"] for i in range(e["members"][member_key]["leaves"][name]["length"])]
                    for e, p in zip(entries, payloads)
                ]
                merged = _merge_leaf_offline(meta, values, counts)
                new_meta = dict(meta)
                new_meta["length"] = len(merged)
                for i, a in enumerate(merged):
                    merged_payload[f"{key}.{i}"] = a
                merged_leaves[name] = new_meta
            elif kind == "catbuffer":
                values = [
                    p.get(key) if e["members"][member_key]["leaves"][name].get("materialized") else None
                    for e, p in zip(entries, payloads)
                ]
                merged = _merge_leaf_offline(meta, values, counts)
                new_meta = dict(meta)
                if merged is None:
                    new_meta["materialized"] = False
                    new_meta["count"] = 0
                else:
                    new_meta["materialized"] = True
                    new_meta["count"] = int(merged.shape[0])
                    new_meta["capacity"] = max(
                        int(meta["capacity"]), int(merged.shape[0]), 1
                    )
                    new_meta["dtype"] = str(merged.dtype)
                    new_meta["item_shape"] = [int(s) for s in merged.shape[1:]]
                    merged_payload[key] = merged
                merged_leaves[name] = new_meta
            else:
                values = [p[key] for p in payloads]
                merged = _merge_leaf_offline(meta, values, counts)
                new_meta = dict(meta)
                new_meta["shape"] = [int(s) for s in np.asarray(merged).shape]
                merged_payload[key] = np.asarray(merged)
                merged_leaves[name] = new_meta
        merged_members[member_key] = {
            "update_count": sum(counts),
            "leaves": merged_leaves,
            "aux": entries[0]["members"][member_key].get("aux") or {},
        }

    shard_meta = {
        "kind": manifest["kind"],
        "members": merged_members,
        "fingerprint": manifest["fingerprint"],
    }
    _io.get_storage().makedirs(out_root)
    pending = _io.pending_dir(out_root, out_step)
    _io.write_shard(pending, 0, 1, merged_payload, shard_meta)
    _io.try_commit(out_root, out_step, 1)
    return out_step
