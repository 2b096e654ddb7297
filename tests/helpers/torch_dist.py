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
