"""Rank bodies of ``tests/test_torch_autotune.py``: the port's self-tuning sync
in a gloo world.

This module imports torch, numpy and ``metrics_tpu_torch`` only (never JAX):
the spawned ranks of ``tests/helpers/torch_dist.GlooWorld`` import it. Every
body resets the tuner first and leaves it off; inputs arrive as numpy, rank
``r`` scales them by ``r + 1``, and results go back as numpy and JSON.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

import metrics_tpu_torch as mt
from metrics_tpu_torch import autotune as at
from metrics_tpu_torch.autotune import controller as at_controller
from metrics_tpu_torch.core import engine
from metrics_tpu_torch.parallel import count_collectives
from metrics_tpu_torch.parallel import sync as sync_mod
from metrics_tpu_torch.resilience import chaos
from metrics_tpu_torch.resilience.chaos import ChaosError, FaultSpec
from tests.helpers.torch_dist import _card_replay_path, to_numpy, to_torch


def _reset() -> None:
    mt.set_autotune(False)
    sync_mod.set_sync_transport(None)
    sync_mod.set_sync_cadence(None)


def _rank_state(state: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    r = dist.get_rank()
    return {k: torch.from_numpy(np.asarray(v * (r + 1), dtype=v.dtype)) for k, v in state.items()}


def _buckets(ctl: Any) -> Dict[str, Any]:
    return {key: {"phase": t.phase, "current": t.current, "committed": t.committed, "cadence": t.cadence,
                  "ladder": list(t.ladder()), "nelems": t.nelems, "poisoned": sorted(t.poisoned)}
            for key, t in ctl.buckets.items()}


def tuned_drive(state: Dict[str, np.ndarray], reds: Dict[str, Any], steps: int, extra: int = 0,
                tolerances: Optional[Dict[str, float]] = None, transports: Optional[Dict[str, str]] = None,
                pin: Optional[dict] = None) -> Dict[str, Any]:
    """``steps`` eager syncs of this rank's state with tuning on (or the plan
    ``pin`` pinned), then ``extra`` more: the decisions, the exported plan and
    the epoch after ``steps``; the decisions and the epoch after the extra
    syncs; the last output; the tuner's buckets; the collectives' bytes by
    transport of the last sync."""
    _reset()
    mt.set_autotune(True if pin is None else pin)
    ctl = at_controller.get_controller()
    st = _rank_state(state)
    out = None
    for _ in range(steps):
        out = sync_mod.sync_state(st, reds, dist.group.WORLD, bucketed=True, transports=transports,
                                  tolerances=tolerances)
    report = {"decisions": json.dumps(ctl.decisions, sort_keys=True),
              "plan": json.dumps(ctl.export_plan().to_dict(), sort_keys=True), "epoch": at.decision_epoch()}
    for _ in range(extra):
        with count_collectives() as box:
            out = sync_mod.sync_state(st, reds, dist.group.WORLD, bucketed=True, transports=transports,
                                      tolerances=tolerances)
        report["bytes_by_transport"] = {k: dict(v) for k, v in box["bytes_by_transport"].items()}
    report.update(decisions_after=json.dumps(ctl.decisions, sort_keys=True), epoch_after=at.decision_epoch(),
                  out=to_numpy(out), buckets=_buckets(ctl), pinned=ctl.pinned is not None)
    _reset()
    return report


def exact_sync(state: Dict[str, np.ndarray], reds: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """This rank's state synced with every state declared exact."""
    _reset()
    return to_numpy(sync_mod.sync_state(_rank_state(state), reds, dist.group.WORLD, bucketed=True,
                                        transports={k: "exact" for k in state}))


def stacked_keys(tenants: int) -> Dict[str, Any]:
    """One tuned ``sync_stacked_states`` of two leaders stacked ``tenants``
    deep: the tuner's bucket keys and element counts."""
    _reset()
    mt.set_autotune(True)
    states = {
        "acc": {"tp": torch.zeros((tenants, 16), dtype=torch.float32)},
        "f1": {"tp": torch.zeros((tenants, 16), dtype=torch.float32),
               "count": torch.zeros((tenants,), dtype=torch.int32)},
    }
    reds = {"acc": {"tp": "sum"}, "f1": {"tp": "sum", "count": "sum"}}
    sync_mod.sync_stacked_states(states, reds, dist.group.WORLD)
    ctl = at_controller.get_controller()
    out = {key: t.nelems for key, t in ctl.buckets.items()}
    _reset()
    return out


def _admissible(ctl: Any) -> List[str]:
    """Every decision whose transport the gate refuses at its bucket's
    parameters (none may be)."""
    bad = []
    for event in ctl.decisions:
        to = event["to"]
        if to == "exact":
            continue
        tuner = ctl.buckets[event["bucket"]]
        final, refusal = sync_mod._gate_transport(
            to, None if tuner.kind == "reshard" else tuner.red, tuner.dtype, tuner.nelems, tuner.world,
            tuner.tolerance_for(to), kind=tuner.kind, error_scale=tuner.max_error_scale,
        )
        if final != to or refusal is not None:
            bad.append(f"{event}: {refusal}")
    return bad


def _chaos_drive(st: Dict[str, torch.Tensor], reds: Dict[str, Any], steps: int) -> tuple:
    """Eager tuned syncs that survive chaos: an aborted sync is dropped."""
    out, aborted = None, 0
    for _ in range(steps):
        try:
            out = sync_mod.sync_state(st, reds, dist.group.WORLD, bucketed=True)
        except ChaosError:
            aborted += 1
    return out, aborted


def chaos_floor(state: Dict[str, np.ndarray], reds: Dict[str, Any], seed: int) -> Dict[str, Any]:
    """Latency and aborted-build faults at the sync sites (the same seed on
    every rank, so every rank aborts the same syncs): the decisions the gate
    would refuse, the buckets, the faults fired, a post-chaos sync."""
    _reset()
    mt.set_autotune(True)
    specs = [FaultSpec("sync/*", kind="latency", probability=0.4, latency_s=0.002),
             FaultSpec("sync/bucket_build", kind="error", probability=0.3, times=4)]
    st = _rank_state(state)
    with chaos.plan(specs, seed=seed) as plan:
        _, aborted = _chaos_drive(st, reds, 40)
        fired = plan.fired("sync/bucket_build")
    ctl = at_controller.get_controller()
    out = sync_mod.sync_state(st, reds, dist.group.WORLD, bucketed=True)
    report = {"bad": _admissible(ctl), "buckets": _buckets(ctl), "fired": fired, "aborted": aborted,
              "tolerance": ctl.buckets["sum|float32|psum"].tolerance_for("int8"), "out": to_numpy(out)}
    _reset()
    return report


def error_spikes(state: Dict[str, np.ndarray], reds: Dict[str, Any], seed: int) -> Dict[str, Any]:
    """Tuned syncs under aborted builds, then measured-error spikes until
    both sum buckets sit on a lossless rung, then 3 x min_dwell exact
    observations and two more syncs."""
    _reset()
    mt.set_autotune(True)
    st = _rank_state(state)
    with chaos.plan([FaultSpec("sync/bucket_build", kind="error", probability=0.25, times=3)], seed=seed):
        _chaos_drive(st, reds, 40)
    ctl = at_controller.get_controller()
    committed_lossy = {}
    for dtype, n in ((np.dtype("float32"), 8192), (np.dtype("int32"), 1000)):
        tuner = ctl.buckets[at.bucket_key("sum", dtype)]
        committed_lossy[dtype.name] = tuner.phase == "committed" and tuner.committed != "exact"
        for _ in range(len(at.LADDER)):
            if tuner.current in ("exact", "sparse_count"):
                break
            ctl.observe_error("sum", dtype, measured=10.0 * tuner.tolerance_for(tuner.current))
    reasons = [d["reason"] for d in ctl.decisions]
    n_decisions = len(ctl.decisions)
    for _ in range(3 * ctl.config.min_dwell):
        for dtype, n in ((np.dtype("float32"), 8192), (np.dtype("int32"), 1000)):
            ctl.observe_bucket("sum", dtype, requested="exact", transport="exact", nelems=n,
                               world=dist.get_world_size())
    quiet_after = len(ctl.decisions) == n_decisions
    out, _ = _chaos_drive(st, reds, 2)
    report = {"committed_lossy": committed_lossy, "reasons": reasons, "quiet_after": quiet_after,
              "bad": _admissible(ctl), "buckets": _buckets(ctl), "out": to_numpy(out)}
    _reset()
    return report


class _Sum8k(mt.Metric):
    """One undeclared float32 sum state of 8,192 elements."""

    full_state_update = False

    def __init__(self) -> None:
        super().__init__(device="cpu")
        self.add_state("total", torch.zeros(8192), dist_reduce_fx="sum")

    def update(self, x: torch.Tensor) -> None:
        self.total = self.total + x

    def compute(self) -> torch.Tensor:
        return self.total


def probe_decides(x: np.ndarray) -> Dict[str, Any]:
    """A compiled synced compute whose probe makes a decision
    (``explore_per_rung=2``: the eager call observes exact once, the probe's
    observation moves the tuner to bf16). The capture and every later run of
    the captured body sync as the probe did (exact); the next call, under
    the moved epoch, is a new signature and runs eager on bf16."""
    _reset()
    mt.set_autotune(True, config={"explore_per_rung": 2})
    world = dist.group.WORLD
    with _card_replay_path():
        metric = _Sum8k()
        metric.update(torch.from_numpy(x * (dist.get_rank() + 1)))
        out = []
        with sync_mod.sync_axes(world):
            for _ in range(3):
                metric._computed = None
                epoch = at.decision_epoch()
                out.append((metric.compute().clone(), epoch, at.decision_epoch()))
        eng = metric._compute_engine
        steps = list(eng._steps.values())
        step = steps[0]
        # the captured body again on the state, now that the tuner answers bf16
        for static, leaf in zip(step.state_static, engine.tree_leaves(metric.get_state())):
            static.copy_(leaf)
        with engine._steady(), sync_mod._muted():
            step._body()
        body_out = step._unpack_outputs()
        ctl = at_controller.get_controller()
        stats = eng.stats
        report = {
            "computes": [to_numpy(v) for v, _, _ in out], "epochs": [(a, b) for _, a, b in out],
            "tuned": [(list(k), t) for k, t in step.tuned], "body": to_numpy(body_out),
            "now": ctl.transport_for("sum", torch.float32), "steps": len(steps),
            "calls": (stats.eager_calls, stats.cache_misses, stats.cache_hits),
            "decisions": [(d["from"], d["to"], d["reason"]) for d in ctl.decisions],
        }
    _reset()
    return report


def _config2(num_classes: int) -> Any:
    c = num_classes
    return mt.MetricCollection({
        "acc": mt.Accuracy(num_classes=c, average="micro", device="cpu"),
        "f1": mt.F1Score(num_classes=c, average="macro", device="cpu"),
        "precision": mt.Precision(num_classes=c, average="macro", device="cpu"),
        "recall": mt.Recall(num_classes=c, average="macro", device="cpu"),
        "binned_ap": mt.BinnedAveragePrecision(num_classes=c, thresholds=21, device="cpu"),
    })


def _rounds(coll: Any, batches: List[tuple], rounds: int, first: int, per_round: int) -> List[Dict[str, Any]]:
    out = []
    with sync_mod.sync_axes(dist.group.WORLD):
        for r in range(first, first + rounds):
            for probs, labels in batches[r * per_round:(r + 1) * per_round]:
                coll.update(torch.from_numpy(probs), torch.from_numpy(labels))
            for m in coll.values():
                m._computed = None
            out.append(to_numpy(coll.compute()))
    return out


def _snapshot(coll: Any) -> Dict[str, Any]:
    stats = coll.engine_stats()
    return {"builds": coll._dispatcher.stats.builds,
            "captures": [None if stats[k] is None else stats[k].cache_misses for k in ("update", "compute")],
            "engines": [id(coll._update_engine), id(coll._compute_engine)]}


def collection_rounds(probs: np.ndarray, labels: np.ndarray, rounds: int, per_round: int) -> Dict[str, Any]:
    """config2 + binned AP at the engine defaults (captured steps replay
    their bodies), ``rounds`` rounds of ``per_round`` updates and a synced
    compute with tuning on, ``rounds`` more, then all of them again under
    the exported plan pinned from its JSON file."""
    _reset()
    batches = list(zip(probs, labels))
    with _card_replay_path():
        mt.set_autotune(True)
        coll = _config2(probs.shape[-1])
        explore = _rounds(coll, batches, rounds, 0, per_round)
        ctl = at_controller.get_controller()
        decisions, epoch, before = [dict(d) for d in ctl.decisions], at.decision_epoch(), _snapshot(coll)
        post = _rounds(coll, batches, rounds, rounds, per_round)
        after = _snapshot(coll)
        report = {"decisions": json.dumps(decisions, sort_keys=True), "buckets": _buckets(ctl),
                  "moved": (len(ctl.decisions) - len(decisions), at.decision_epoch() - epoch),
                  "before": before, "after": after, "explore": explore, "post": post,
                  "fallbacks": coll.engine_stats()["fallback_reasons"]}
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "plan.json")
            at.export_plan().save(path)
            mt.set_autotune(path)
            pinned_epoch = at.decision_epoch()
            pinned = _config2(probs.shape[-1])
            replay = _rounds(pinned, batches, 2 * rounds, 0, per_round)
        pin_ctl = at_controller.get_controller()
        report.update(pinned_decisions=len(pin_ctl.decisions), pinned_moved=at.decision_epoch() - pinned_epoch,
                      pinned_snapshot=_snapshot(pinned), replay=replay[rounds:])
    _reset()
    return report


def pinned_incremental(plan: dict) -> Dict[str, Any]:
    """An int32 sum streak (sync_every=1) under a pinned plan: what
    ``emission_transports`` answers at each emission (the gate judges the
    emission's compounded bound) and what the emissions put on the wire;
    then, with live tuning, a sync under ``sync._quiet()`` observes nothing
    and a plain one observes once."""
    _reset()
    mt.set_autotune(plan)
    world = dist.group.WORLD
    state = {"hits": torch.zeros(1000, dtype=torch.int32)}
    reds, modes = {"hits": "sum"}, {"hits": "incremental"}
    carry = sync_mod.init_incremental(state, reds, modes=modes, sync_every=1)
    planned = []
    with count_collectives() as box:
        for step in range(3):
            new = {"hits": carry.state["hits"] + (torch.arange(1000, dtype=torch.int32) % 5) * (dist.get_rank() + 1)}
            planned += sync_mod.emission_transports(carry, reds, dist.get_world_size(), modes=modes)
            carry = sync_mod.advance_incremental(carry, new, reds, world, modes=modes)
    report = {"track": carry.track_emissions, "planned": [[list(names), t] for names, t in planned],
              "transports": sorted(box["bytes_by_transport"])}
    mt.set_autotune(True)
    ctl = at_controller.get_controller()
    with sync_mod._quiet():
        sync_mod.sync_state(state, reds, world)
    report["quiet_buckets"] = sorted(ctl.buckets)
    sync_mod.sync_state(state, reds, world)
    report["observations"] = {k: t.observations for k, t in ctl.buckets.items()}
    _reset()
    return report
