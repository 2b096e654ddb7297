"""A gloo world of CPU ranks for the port's sync tests, and the bodies its ranks run.

This module imports torch, numpy and ``metrics_tpu_torch`` only (never JAX or
``tests/helpers/torch_port.py``): the spawned ranks import it. Inputs cross
to the ranks as numpy arrays (and strings), results come back as numpy.

:class:`GlooWorld` spawns the ranks once; each joins the default group
through a file store under a directory of the caller's (so parallel test
workers never race for a port) with a 60 s collective timeout, then runs
the bodies it is sent. Every call has a watchdog: a world that does not
answer within ``WATCHDOG_S`` is terminated and the call fails.
"""
from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import os
import queue
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

import metrics_tpu_torch as mt
from metrics_tpu_torch.core.buffers import CatBuffer
from metrics_tpu_torch.entry import dryrun_multichip
from metrics_tpu_torch.parallel import count_collectives, make_mesh, sync_state
from metrics_tpu_torch.utils.exceptions import MetricsUserError

WATCHDOG_S = 120.0
GROUP_TIMEOUT = datetime.timedelta(seconds=60)


# --------------------------------------------------------------------------- #
# the world
# --------------------------------------------------------------------------- #
def _serve(rank: int, world: int, init_file: str, tasks: Any, results: Any) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world, timeout=GROUP_TIMEOUT)
    try:
        while True:
            task = tasks.get()
            if task is None:
                return
            body, args = task
            try:
                results.put((rank, True, body(*args)))
            except Exception:  # report the body's failure and serve the next one
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class GlooWorld:
    """``size`` spawned CPU ranks in one gloo world, kept for many calls."""

    def __init__(self, size: int, store_dir: str) -> None:
        ctx = multiprocessing.get_context("spawn")
        self.size = size
        self._tasks = [ctx.Queue() for _ in range(size)]
        self._results = ctx.Queue()
        init_file = os.path.join(store_dir, "gloo_store")
        self._procs = [
            ctx.Process(target=_serve, args=(rank, size, init_file, self._tasks[rank], self._results), daemon=True)
            for rank in range(size)
        ]
        for p in self._procs:
            p.start()
        self._down: Optional[str] = None

    def run(self, body: Callable, rank_args: Sequence[tuple]) -> List[Any]:
        """Run ``body(*rank_args[r])`` on every rank ``r``; the results in rank order.

        A body that raises on any rank raises here with its traceback."""
        if self._down:
            raise RuntimeError(f"the gloo world is down: {self._down}")
        assert len(rank_args) == self.size
        for rank, args in enumerate(rank_args):
            self._tasks[rank].put((body, tuple(args)))
        reports: Dict[int, Any] = {}
        deadline = time.monotonic() + WATCHDOG_S
        while len(reports) < self.size:
            try:
                rank, ok, payload = self._results.get(timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                self._down = f"{body.__name__} did not finish on every rank within {WATCHDOG_S:.0f} s"
                self.close()
                raise TimeoutError(self._down) from None
            reports[rank] = (ok, payload)
        failed = {rank: payload for rank, (ok, payload) in reports.items() if not ok}
        if failed:
            raise RuntimeError("\n".join(f"rank {rank}:\n{tb}" for rank, tb in sorted(failed.items())))
        return [reports[rank][1] for rank in range(self.size)]

    def run_all(self, body: Callable, *args: Any) -> List[Any]:
        """Run ``body(*args)`` on every rank."""
        return self.run(body, [args] * self.size)

    def close(self) -> None:
        for q in self._tasks:
            q.put(None)
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join()


# --------------------------------------------------------------------------- #
# conversions
# --------------------------------------------------------------------------- #
def to_torch(tree: Any) -> Any:
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v) for v in tree)
    return tree


def to_numpy(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, CatBuffer):
        return tree.to_array().cpu().numpy() if tree.materialized else None
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree


# --------------------------------------------------------------------------- #
# the metrics under test
# --------------------------------------------------------------------------- #
VOCAB = ["[CLS]", "[SEP]", "[PAD]", "hello", "there", "general", "kenobi", "master", "world", "hi"]
TABLE = torch.from_numpy(np.random.RandomState(0).randn(len(VOCAB), 16).astype(np.float32))


class ToyTokenizer:
    """Pads to ``width`` tokens, or to each batch's longest sentence when None."""

    def __init__(self, width: Optional[int] = 8) -> None:
        self.width = width

    def __call__(self, sentences: List[str]) -> Dict[str, np.ndarray]:
        width = self.width or max(len(s.split()) for s in sentences) + 2
        ids = np.full((len(sentences), width), VOCAB.index("[PAD]"), dtype=np.int32)
        mask = np.zeros((len(sentences), width), dtype=np.int32)
        for row, sent in enumerate(sentences):
            for col, tok in enumerate(["[CLS]"] + sent.split()[: width - 2] + ["[SEP]"]):
                ids[row, col] = VOCAB.index(tok)
                mask[row, col] = 1
        return {"input_ids": ids, "attention_mask": mask}


def toy_forward(model: Any, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    return TABLE[batch["input_ids"]]


C = 5  # classes of the small classification cases

FACTORIES: Dict[str, Callable[..., Any]] = {
    "StatScores": lambda **kw: mt.StatScores(num_classes=C, reduce="macro", **kw),
    "Accuracy": lambda **kw: mt.Accuracy(num_classes=C, average="macro", **kw),
    "Precision": lambda **kw: mt.Precision(num_classes=C, average="macro", **kw),
    "Recall": lambda **kw: mt.Recall(num_classes=C, average="micro", **kw),
    "F1Score": lambda **kw: mt.F1Score(num_classes=C, average="macro", **kw),
    "FBetaScore": lambda **kw: mt.FBetaScore(num_classes=C, beta=0.5, average="weighted", **kw),
    "BinnedPrecisionRecallCurve": lambda **kw: mt.BinnedPrecisionRecallCurve(num_classes=C, thresholds=11, **kw),
    "BinnedAveragePrecision": lambda **kw: mt.BinnedAveragePrecision(num_classes=C, thresholds=21, **kw),
    "BinnedRecallAtFixedPrecision": lambda **kw: mt.BinnedRecallAtFixedPrecision(
        num_classes=C, min_precision=0.3, thresholds=21, **kw
    ),
    "MeanAveragePrecision": lambda **kw: mt.MeanAveragePrecision(class_metrics=True, **kw),
    "BERTScore": lambda width=8, **kw: mt.BERTScore(
        model=object(), user_tokenizer=ToyTokenizer(width), user_forward_fn=toy_forward, max_length=8, **kw
    ),
    "CompositionalMetric": lambda **kw: (
        mt.Accuracy(num_classes=C, average="micro", **kw) + mt.F1Score(num_classes=C, average="macro", **kw)
    ) / 2,
    "ImageNetWidth": lambda **kw: mt.BinnedAveragePrecision(num_classes=1000, thresholds=100, **kw),
}


def make_metric(name: str, **kwargs: Any) -> Any:
    return FACTORIES[name](device="cpu", **kwargs)


def make_collection(num_classes: int) -> mt.MetricCollection:
    """The collection of the entry point."""
    return mt.MetricCollection(
        {
            "acc": mt.Accuracy(num_classes=num_classes, average="micro", device="cpu"),
            "f1": mt.F1Score(num_classes=num_classes, average="macro", device="cpu"),
            "precision": mt.Precision(num_classes=num_classes, average="macro", device="cpu"),
            "recall": mt.Recall(num_classes=num_classes, average="macro", device="cpu"),
        }
    )


def _leaf_metrics(metric: Any) -> List[Any]:
    """The metrics that hold state: the operands of a composition."""
    if isinstance(metric, mt.CompositionalMetric):
        return [leaf for m in (metric.metric_a, metric.metric_b) if isinstance(m, mt.Metric) for leaf in _leaf_metrics(m)]
    return [metric]


def feed(metric: Any, batches: Sequence[tuple]) -> Any:
    for batch in batches:
        metric.update(*to_torch(batch))
    return metric


# --------------------------------------------------------------------------- #
# rank bodies
# --------------------------------------------------------------------------- #
def synced_compute(name: str, batches: Sequence[tuple], kwargs: Optional[dict] = None) -> Dict[str, Any]:
    """Update on this rank's batches; compute (synced over the world) under a
    collective count; the synced and the restored local state."""
    metric = feed(make_metric(name, **(kwargs or {})), batches)
    local = [to_numpy(m.get_state()) for m in _leaf_metrics(metric)]
    with count_collectives() as box:
        result = metric.compute()
    synced = []
    for m in _leaf_metrics(metric):
        m.sync()
        synced.append(to_numpy(m.get_state()))
        m.unsync()
    restored = [to_numpy(m.get_state()) for m in _leaf_metrics(metric)]
    return dict(result=to_numpy(result), synced=synced, local=local, restored=restored, counts=box)


def collection_compute(num_classes: int, batches: Sequence[tuple]) -> Dict[str, Any]:
    """The entry collection through the facade: per-group synced compute."""
    coll = make_collection(num_classes)
    for batch in batches:
        coll.update(*to_torch(batch))
    with count_collectives() as box:
        result = coll.compute()
    return dict(result=to_numpy(result), counts=box,
                states={k: to_numpy(m.get_state()) for k, m in coll.items(keep_base=True)})


def pure_sync_counts(kind: str, batch: tuple) -> Dict[str, Any]:
    """The collective count of the pure ``sync_states`` of one update."""
    target = make_collection(C) if kind == "collection" else make_metric(kind)
    state = target.update_state(target.init_state(), *to_torch(batch))
    with count_collectives() as box:
        target.sync_states(state, dist.group.WORLD)
    return box


def bucketed_against_per_leaf(state: Dict[str, Any], reductions: Dict[str, Any]) -> Dict[str, Any]:
    """One rank's synthetic state (numpy, lists for ``cat`` lists) synced
    bucketed and per leaf."""
    reductions = {k: (_stack_max if v == "callable" else v) for k, v in reductions.items()}
    state = to_torch(state)
    out = {}
    for bucketed in (True, False):
        with count_collectives() as box:
            out[bucketed] = to_numpy(sync_state(state, reductions, dist.group.WORLD, bucketed=bucketed))
        out[f"counts_{bucketed}"] = box
    return out


def _stack_max(stacked: torch.Tensor) -> torch.Tensor:
    return stacked.amax(dim=0)


def state_machine() -> List[str]:
    """The facade's sync state-machine errors, in order."""
    metric = mt.Accuracy(device="cpu")
    metric.update(torch.tensor([0, 1, 1]), torch.tensor([0, 1, 0]))
    errors = []
    metric.sync()
    for attempt in (metric.sync, lambda: metric(torch.tensor([0]), torch.tensor([0]))):
        try:
            attempt()
        except MetricsUserError as err:
            errors.append(str(err))
    metric.unsync()
    try:
        metric.unsync()
    except MetricsUserError as err:
        errors.append(str(err))
    metric._is_synced, metric._cache = True, None
    try:
        metric.unsync()
    except MetricsUserError as err:
        errors.append(str(err))
    return errors


def forward_and_flags(batches: Sequence[tuple]) -> Dict[str, Any]:
    """``dist_sync_on_step`` (the batch value synced), ``sync_on_compute=False``
    (the local value) and ``compute_on_cpu`` (list states on the host)."""
    on_step = mt.Accuracy(num_classes=C, average="micro", dist_sync_on_step=True, device="cpu")
    plain = mt.Accuracy(num_classes=C, average="micro", device="cpu")
    unsynced = mt.Accuracy(num_classes=C, average="micro", sync_on_compute=False, device="cpu")
    on_cpu = make_metric("BERTScore", compute_on_cpu=True)
    step_values, plain_values = [], []
    for preds, target in batches:
        step_values.append(to_numpy(on_step(*to_torch((preds, target)))))
        plain_values.append(to_numpy(plain(*to_torch((preds, target)))))
        unsynced.update(*to_torch((preds, target)))
    on_cpu.update(["hello there", "master kenobi"], ["hello there", "general kenobi"])
    return dict(
        step_values=step_values,
        plain_values=plain_values,
        on_step_compute=to_numpy(on_step.compute()),
        unsynced_compute=to_numpy(unsynced.compute()),
        on_cpu_devices=sorted({str(t.device) for t in on_cpu.preds_input_ids}),
        on_cpu_result=to_numpy(on_cpu.compute()),
    )


def bert_width_error(sentences: List[str]) -> str:
    """BERTScore over per-batch widths: the sync's error, which every rank raises."""
    metric = make_metric("BERTScore", width=None)
    metric.update(sentences, sentences)
    try:
        metric.compute()
    except ValueError as err:
        return str(err)
    return ""


def clone_shares_the_group() -> bool:
    metric = mt.Accuracy(device="cpu", process_group=dist.group.WORLD)
    metric.update(torch.tensor([0, 1]), torch.tensor([0, 0]))
    copy = metric.clone()
    return copy.process_group is metric.process_group and copy.tp is not metric.tp and bool((copy.tp == metric.tp).all())


def mesh_layout(sizes: Sequence[int]) -> Dict[str, Any]:
    """This rank's coordinates and, for each axis tuple, the ranks of its group."""
    mesh = make_mesh(sizes, ["data", "model"])
    out: Dict[str, Any] = {"coords": (mesh.axis_index("data"), mesh.axis_index("model")),
                           "sizes": (mesh.axis_size("data"), mesh.axis_size("model"))}
    for axes in ("data", "model", ("data", "model")):
        group = mesh.group(axes)
        ranks = [torch.zeros((), dtype=torch.int64) for _ in range(dist.get_world_size(group))]
        dist.all_gather(ranks, torch.tensor(dist.get_rank()), group=group)
        out[str(axes)] = [int(r) for r in ranks]
    return out


def dryrun(n_devices: int) -> Dict[str, Any]:
    """``dryrun_multichip`` in this world; its outputs as numpy."""
    return to_numpy(dryrun_multichip(n_devices, device="cpu"))


def twin_synced_compute(
    name: str, buffered: bool, calls: Sequence[tuple], kwargs: Optional[dict] = None, seed: Optional[int] = None
) -> Any:
    """The ``INVENTORY`` twin (``tests/helpers/torch_twins.py``, with
    ``kwargs`` added) fed this rank's ``(args, kwargs)`` calls at the engine
    defaults; its synced compute. ``seed`` remakes the twin's host generator
    (BootStrapper's resampling) from that seed."""
    from tests.helpers.torch_twins import make_twin

    metric = make_twin(name, buffered, **(kwargs or {}))
    if seed is not None:
        metric._rng = np.random.default_rng(seed)
    for args, kwargs in calls:
        metric.update(*to_torch(args), **to_torch(kwargs))
    return to_numpy(metric.compute())


# --------------------------------------------------------------------------- #
# sketches (tests/test_torch_sketches.py)
# --------------------------------------------------------------------------- #
def sketch_state(values: np.ndarray, keys: np.ndarray) -> Dict[str, Any]:
    """One of each sketch, this rank's values and keys inserted."""
    from metrics_tpu_torch import sketches as sk

    x, k = torch.from_numpy(values), torch.from_numpy(keys)
    return {
        "q": sk.QuantileSketch(device="cpu").insert(x),
        "hll": sk.HyperLogLogSketch(precision=8, device="cpu").insert(k),
        "cm": sk.CountMinSketch(width=64, depth=3, device="cpu").insert(k),
        "dy": sk.DyadicCountMinSketch(domain_bits=10, width=32, depth=2, device="cpu").insert(k),
        "plain": torch.tensor([float(len(values))]),  # a dense sum leaf sharing the (sum, float32) bucket
    }


SKETCH_REDUCTIONS = {"q": "sketch", "hll": "sketch", "cm": "sketch", "dy": "sketch", "plain": "sum"}


def sketch_sync(values: np.ndarray, keys: np.ndarray) -> Dict[str, Any]:
    """This rank's sketch state synced bucketed and per leaf: components as
    numpy, and the collectives each ran."""
    state = sketch_state(values, keys)
    out: Dict[str, Any] = {}
    for bucketed in (True, False):
        with count_collectives() as box:
            synced = sync_state(state, SKETCH_REDUCTIONS, dist.group.WORLD, bucketed=bucketed)
        out[bucketed] = {name: ({f: to_numpy(c) for f, c in v.components().items()} if hasattr(v, "components")
                                else to_numpy(v)) for name, v in synced.items()}
        out[f"counts_{bucketed}"] = box
    return out


def auroc_sketch_synced(calls: Sequence[tuple]) -> Any:
    """AUROC(approx="sketch") fed this rank's calls at the engine defaults;
    its synced compute."""
    metric = mt.AUROC(approx="sketch", device="cpu")
    for args in calls:
        metric.update(*to_torch(args))
    return to_numpy(metric.compute())


# --------------------------------------------------------------------------- #
# FID (tests/test_torch_image_metrics.py)
# --------------------------------------------------------------------------- #
def fid_synced(calls: Sequence[tuple]) -> Dict[str, Any]:
    """FID over identity features, fed this rank's ``(features, real)``
    calls: its local state, its synced state, the synced compute and the
    collectives of the sync."""
    metric = mt.FrechetInceptionDistance(feature=lambda x: x, feature_size=calls[0][0].shape[1], device="cpu")
    for x, real in calls:
        metric.update(torch.from_numpy(x), real=real)
    local = metric.get_state()
    with count_collectives() as box:
        synced = metric.sync_states(local, dist.group.WORLD)
    value = metric.compute()
    return {"local": to_numpy(local), "synced": to_numpy(synced), "counts": dict(box["by_kind"]), "fid": float(value)}


# --------------------------------------------------------------------------- #
# transports and incremental sync (tests/test_torch_sync_transports.py and
# tests/test_torch_incremental_sync.py)
# --------------------------------------------------------------------------- #
_SINGLETON: Dict[str, Any] = {}


def _group(singleton: bool) -> Any:
    """The world, or this rank's group of one (every rank makes every
    singleton group, in rank order, the first time one is asked for)."""
    if not singleton:
        return dist.group.WORLD
    if not _SINGLETON:
        for r in range(dist.get_world_size()):
            group = dist.new_group([r])
            if r == dist.get_rank():
                _SINGLETON["own"] = group
    return _SINGLETON["own"]


@contextlib.contextmanager
def _defaults(transport: Optional[str] = None, mode: Optional[str] = None):
    """The global transport and sync mode for the block, restored after."""
    mt.set_sync_transport(transport)
    mt.set_sync_mode(mode)
    try:
        yield
    finally:
        mt.set_sync_transport(None)
        mt.set_sync_mode(None)


def transport_sync(state: Dict[str, Any], reductions: Dict[str, Any], transports: Optional[dict] = None,
                   tolerances: Optional[dict] = None, singleton: bool = False, default: Optional[str] = None) -> Dict[str, Any]:
    """This rank's state synced over the world (or its group of one) with the
    declared transports; the synced state and the collectives' box."""
    with _defaults(default), count_collectives() as box:
        out = sync_state(to_torch(state), reductions, _group(singleton), bucketed=True, transports=transports,
                         tolerances=tolerances)
    return {"state": to_numpy(out), "box": box}


class QuantMetric(mt.Metric):
    """A metric declaring a transport on its sum state."""

    full_state_update = False

    def __init__(self, transport: Optional[str] = None, tolerance: Optional[float] = None) -> None:
        super().__init__(device="cpu", compiled_compute=False)
        kw: Dict[str, Any] = {}
        if transport is not None:
            kw["sync_transport"] = transport
        if tolerance is not None:
            kw["sync_tolerance"] = tolerance
        self.add_state("total", torch.zeros(32), dist_reduce_fx="sum", **kw)
        self.add_state("n", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, x: torch.Tensor) -> None:
        self.total = self.total + x
        self.n = self.n + 1.0

    def compute(self) -> torch.Tensor:
        return self.total / torch.clamp(self.n, min=1.0)


def declared_sync(x: np.ndarray, transport: Optional[str], batch: tuple) -> Dict[str, Any]:
    """QuantMetric's and the entry collection's ``sync_states`` with every
    state declared on ``transport``, and the collectives of each."""
    metric = QuantMetric(transport)
    with count_collectives() as box:
        synced = metric.sync_states(metric.update_state(metric.init_state(), torch.from_numpy(x)), dist.group.WORLD)
    coll = make_collection(C)
    if transport is not None:
        for m in coll.values():
            m._sync_transports = {name: transport for name in m._defaults}
    states = coll.update_state(coll.init_state(), *to_torch(batch))
    with count_collectives() as coll_box:
        coll_synced = coll.sync_states(states, dist.group.WORLD)
    return {"metric": to_numpy(synced), "box": box, "collection": to_numpy(coll_synced), "coll_box": coll_box}


INCR_REDUCTIONS = {"hits": "sum", "n": "sum", "total": "sum", "peak": "max"}


def incr_state() -> Dict[str, torch.Tensor]:
    """Fold (int sums) and replace (float sum, max) leaves, a scalar of each."""
    return {"hits": torch.arange(16, dtype=torch.int32), "n": torch.tensor(0, dtype=torch.int32),
            "total": torch.zeros(8), "peak": torch.tensor(float("-inf"))}


def incr_step(state: Dict[str, torch.Tensor], x: torch.Tensor, t: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {"hits": state["hits"] + x, "n": state["n"] + 1, "total": state["total"] + t,
            "peak": torch.maximum(state["peak"], x.max().to(torch.float32))}


def incremental_streak(xs: np.ndarray, ts: np.ndarray, sync_every: int, modes: Optional[dict],
                       no_group: bool = False, transports: Optional[dict] = None) -> Dict[str, Any]:
    """The streak through the carry protocol, then finalize; the collectives
    of every step and of the finalize, and the carry's bookkeeping."""
    group = None if no_group else dist.group.WORLD
    carry = mt.parallel.init_incremental(incr_state(), INCR_REDUCTIONS, modes=modes, sync_every=sync_every,
                                         transports=transports)
    per_step, marks = [], []
    for x, t in zip(xs, ts):
        state = incr_step(carry.state, torch.from_numpy(x), torch.from_numpy(t))
        with count_collectives() as box:
            carry = mt.parallel.advance_incremental(carry, state, INCR_REDUCTIONS, group, modes=modes,
                                                    transports=transports)
        per_step.append(box["count"])
        marks.append((carry.sync_every, carry.pending, carry.emissions, carry.track_emissions))
    with count_collectives() as fin:
        out = mt.parallel.finalize_incremental_state(carry, INCR_REDUCTIONS, group, modes=modes, transports=transports)
    return {"out": to_numpy(out), "per_step": per_step, "final": fin["count"], "marks": marks,
            "state": to_numpy(carry.state)}


def deferred_streak(xs: np.ndarray, ts: np.ndarray) -> Dict[str, Any]:
    """The same updates, one deferred ``sync_state`` at the end."""
    state = incr_state()
    for x, t in zip(xs, ts):
        state = incr_step(state, torch.from_numpy(x), torch.from_numpy(t))
    with count_collectives() as box:
        out = sync_state(state, INCR_REDUCTIONS, dist.group.WORLD)
    return {"out": to_numpy(out), "count": box["count"]}


def metric_incremental(preds: np.ndarray, target: np.ndarray, sync_every: int) -> Dict[str, Any]:
    """Accuracy (micro) with every state incremental: the carry protocol and
    the deferred ``sync_states`` over the same updates, each with its compute."""
    world = dist.group.WORLD
    metric = mt.Accuracy(num_classes=C, average="micro", device="cpu")
    for name in metric._defaults:
        metric._sync_modes[name] = "incremental"
    carry = metric.init_incremental(metric.init_state(), sync_every=sync_every)
    state = metric.init_state()
    for p, t in zip(preds, target):
        carry = metric.update_state_incremental(carry, torch.from_numpy(p), torch.from_numpy(t), group=world)
        state = metric.update_state(state, torch.from_numpy(p), torch.from_numpy(t))
    deferred = metric.sync_states(state, world)
    return {"incremental": to_numpy(metric.finalize_incremental(carry, world)), "deferred": to_numpy(deferred),
            "incremental_value": to_numpy(metric.sync_compute_incremental(carry, world)),
            "deferred_value": to_numpy(metric.compute_state(deferred))}


def default_modes_sync(batch: tuple) -> Dict[str, Any]:
    """Accuracy at the default sync mode: ``sync_states`` of its state and
    the incremental finalize of a carry over the same update, with the
    collectives of each."""
    world = dist.group.WORLD
    metric = mt.Accuracy(num_classes=C, average="micro", device="cpu")
    args = to_torch(batch)
    with count_collectives() as box:
        deferred = metric.sync_states(metric.update_state(metric.init_state(), *args), world)
    carry = metric.update_state_incremental(metric.init_incremental(metric.init_state()), *args, group=world)
    with count_collectives() as fin:
        finalized = metric.finalize_incremental(carry, world)
    return {"deferred": to_numpy(deferred), "finalized": to_numpy(finalized), "box": box, "fin": fin,
            "covered": sorted(carry.acc)}


class _BodyGraph:
    """A stand-in graph whose replay runs the captured body, ticking nothing
    (a graph's replay runs no Python), so the card's replay path runs on the
    CPU (``tests/helpers/torch_port.py`` has the same for the JAX-side tests)."""

    def __init__(self, step: Any) -> None:
        self.step = step

    def replay(self) -> None:
        from metrics_tpu_torch.core import engine
        from metrics_tpu_torch.parallel import sync as sync_mod

        with engine._steady(), sync_mod._muted():
            self.step._body()


@contextlib.contextmanager
def _card_replay_path():
    from metrics_tpu_torch.core import engine

    probe = engine.CapturedStep.probe

    def probe_then_graph(self, state, args, kwargs):
        out = probe(self, state, args, kwargs)
        self.graph = _BodyGraph(self)
        return out

    engine.CapturedStep.probe = probe_then_graph
    try:
        yield
    finally:
        engine.CapturedStep.probe = probe


def _config2_and_binned() -> Any:
    coll = make_collection(C)
    coll.add_metrics({"binned": make_metric("BinnedAveragePrecision")})
    return coll


def captured_incremental(batches: Sequence[tuple], sync_every: int) -> Dict[str, Any]:
    """config2 plus a binned AP, every state incremental, through
    ``CompiledIncrementalStep`` (replays run the captured body) and through
    the eager protocol: both finalizes, the deferred sync of the final
    states, the emitting steps and the engine's counters."""
    from metrics_tpu_torch.core.engine import CompiledIncrementalStep

    world = dist.group.WORLD
    with _defaults(mode="incremental"), _card_replay_path():
        coll = _config2_and_binned()
        step = CompiledIncrementalStep(coll, world)
        carries = coll.init_incremental(coll.init_state(), sync_every=sync_every)
        eager = coll.init_incremental(coll.init_state(), sync_every=sync_every)
        emitting, counts = 0, []
        for batch in batches:
            args = to_torch(batch)
            with count_collectives() as box:
                carries = step(carries, *args)
            eager = coll.update_state_incremental(eager, *args, group=world)
            emitting += next(iter(carries.values())).pending == 0
            counts.append(box["count"])
        with count_collectives() as fin:
            captured = coll.finalize_incremental(carries, world)
        deferred = coll.sync_states({k: c.state for k, c in eager.items()}, world)
        stats = step.stats
        return {"captured": to_numpy(captured), "eager": to_numpy(coll.finalize_incremental(eager, world)),
                "deferred": to_numpy(deferred), "emitting": emitting, "counts": counts, "final": fin["count"],
                "calls": (stats.eager_calls, stats.cache_misses, stats.cache_hits), "broken": step.broken,
                "collective_counts": dict(stats.collective_counts),
                "values": to_numpy(coll.sync_compute_incremental(carries, world))}


def captured_synced_compute(batches: Sequence[tuple], transport: Optional[str] = None, calls: int = 3) -> Dict[str, Any]:
    """config2 plus a binned AP at the engine defaults, fed this rank's
    batches, then ``calls`` synced computes (replays run the captured body):
    each result and its collectives, the compute engine's counters and the
    partition's compute paths."""
    with _defaults(transport), _card_replay_path():
        coll = _config2_and_binned()
        for batch in batches:
            coll.update(*to_torch(batch))
        results, boxes = [], []
        with mt.parallel.sync_axes(dist.group.WORLD):
            for _ in range(calls):
                for m in coll.values():
                    m._computed = None
                with count_collectives() as box:
                    results.append(to_numpy(coll.compute()))
                boxes.append(box)
        stats = coll.engine_stats()
        compute = stats["compute"]
        return {"results": results, "boxes": boxes,
                "stats": None if compute is None else {
                    "calls": (compute.eager_calls, compute.cache_misses, compute.cache_hits),
                    "collective_counts": dict(compute.collective_counts),
                    "collective_bytes": dict(compute.collective_bytes),
                    "collective_bytes_by_transport": {k: dict(v) for k, v in compute.collective_bytes_by_transport.items()},
                    "transport_refusals": compute.transport_refusals},
                "fallback_reasons": stats["fallback_reasons"],
                "paths": {k: v["path"] for k, v in stats["partition"]["compute"].items()},
                "reasons": {k: v["reason"] for k, v in stats["partition"]["compute"].items()}}
