"""The port's twins of ``__graft_entry__.entry()`` and ``dryrun_multichip(n)``.

``entry(device=None)`` returns ``(fn, example_args)``: one ``MetricCollection``
step (``update_state`` then ``compute_state``) of Accuracy (micro) and
F1/Precision/Recall (macro) over 10 classes, on the JAX entry's 64 seeded rows.

``dryrun_multichip(n_devices, device=None)`` runs the JAX dry-run's
distributed step with the same shapes, seed and ``(data, model)`` layout, one
rank per device:

- model: ``x_local @ w_local`` with ``w`` column-sharded over ``model``, the
  logits gathered over ``model``;
- loss: the cross-entropy averaged over ``data`` and an SGD step at lr 0.1
  with the gradient of that mean loss. The JAX step's gradient is ``tp``
  times it: the transpose of its tiled ``all_gather`` sums the replicated
  cotangent over ``model``. The port takes ``dL/dlogits`` on the full
  logits and slices this rank's columns;
- the collection updated on the local rows, synced over ``data``, computed;
- ``BinnedAveragePrecision`` over ``n_th_pad`` thresholds with the JAX
  step's shape-conditional slice over ``model``, sum over ``data`` and
  gather over ``model``. Its states are ``(num_classes, T)``, so at these
  shapes neither the slice nor the gather applies: the leg is a sum over
  ``data`` of the full-grid counts, as in the JAX step;
- the per-token ``Accuracy(mdmc_average="global")`` on ``(B, C, S)`` logits,
  ``S`` split over ``model``, synced over both axes.

It keeps the JAX checks (finite loss, results and AP; the sequence accuracy
within 1e-6 of the oracle on the full token grid) and returns the outputs.

When no process group exists, the function makes one: ``n_devices == 1`` is
a world of one rank in this process (NCCL on the card, gloo for
``device="cpu"``); more ranks are spawned, gloo ranks for ``device="cpu"``,
else one NCCL rank per card, and there must be that many cards.
"""
from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from metrics_tpu_torch.classification import Accuracy, BinnedAveragePrecision, F1Score, Precision, Recall
from metrics_tpu_torch.classification.binned_precision_recall import linspace_thresholds
from metrics_tpu_torch.core.collections import MetricCollection
from metrics_tpu_torch.core.metric import resolve_device
from metrics_tpu_torch.parallel.mesh import make_mesh
from metrics_tpu_torch.parallel.sync import sync_array

NUM_CLASSES, FEAT, N_THRESHOLDS, LR = 8, 16, 21, 0.1
_SPAWN_TIMEOUT_S = 300.0
_GROUP_TIMEOUT = datetime.timedelta(seconds=60)


def _make_collection(num_classes: int, device: torch.device) -> MetricCollection:
    return MetricCollection(
        {
            "acc": Accuracy(num_classes=num_classes, average="micro", device=device),
            "f1": F1Score(num_classes=num_classes, average="macro", device=device),
            "precision": Precision(num_classes=num_classes, average="macro", device=device),
            "recall": Recall(num_classes=num_classes, average="macro", device=device),
        }
    )


def entry(device: Optional[Union[str, torch.device]] = None) -> Tuple[Callable, Tuple]:
    """Return ``(fn, example_args)``: one metric eval step of the collection.

    Example:
        >>> from metrics_tpu_torch.entry import entry
        >>> fn, args = entry(device="cpu")
        >>> states, results = fn(*args)
        >>> sorted(results), int(states["acc"]["tp"].sum())
        (['acc', 'f1', 'precision', 'recall'], 3)
    """
    device = resolve_device(device)
    num_classes = 10
    coll = _make_collection(num_classes, device)

    def step(states, logits, target):
        new_states = coll.update_state(states, logits, target)
        return new_states, coll.compute_state(new_states)

    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(size=(64, num_classes)).astype(np.float32)).to(device)
    target = torch.from_numpy(rng.integers(0, num_classes, size=(64,)).astype(np.int32)).to(device)
    return step, (coll.init_state(), logits, target)


def dryrun_inputs(n_devices: int) -> Dict[str, Any]:
    """The dry-run's layout and its seeded full inputs, as numpy arrays."""
    dp = max(1, n_devices // 2) if n_devices >= 2 else 1
    tp = n_devices // dp
    batch, seq = 4 * dp, 2 * tp
    rng = np.random.default_rng(0)
    return dict(
        dp=dp,
        tp=tp,
        n_th_pad=((N_THRESHOLDS + tp - 1) // tp) * tp,
        x=rng.normal(size=(batch, FEAT)).astype(np.float32),
        y=rng.integers(0, NUM_CLASSES, size=(batch,)).astype(np.int32),
        w=(rng.normal(size=(FEAT, NUM_CLASSES)) * 0.1).astype(np.float32),
        tok_logits=rng.normal(size=(batch, NUM_CLASSES, seq)).astype(np.float32),
        y_tok=rng.integers(0, NUM_CLASSES, size=(batch, seq)).astype(np.int32),
    )


def _gather_tiled(x: torch.Tensor, group: dist.ProcessGroup, dim: int) -> torch.Tensor:
    """The tiled ``all_gather`` along ``dim``."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _dryrun_rank(n_devices: int, device: torch.device) -> Dict[str, Any]:
    """One rank's part of the distributed step, in an existing world of ``n_devices`` ranks."""
    if dist.get_world_size() != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) runs in a world of {n_devices} ranks, not {dist.get_world_size()}")
    inp = dryrun_inputs(n_devices)
    dp, tp, n_th_pad = inp["dp"], inp["tp"], inp["n_th_pad"]
    mesh = make_mesh([dp, tp], ["data", "model"], backend="gloo" if device.type == "cpu" else "nccl")
    d, m = mesh.axis_index("data"), mesh.axis_index("model")
    data, model = mesh.group("data"), mesh.group("model")

    def local(name: str, rows: bool = True, axis: Optional[int] = None) -> torch.Tensor:
        """This rank's block: rows split over ``data``, ``axis`` over ``model``."""
        arr = inp[name]
        if rows:
            size = arr.shape[0] // dp
            arr = arr[d * size : (d + 1) * size]
        if axis is not None:
            size = arr.shape[axis] // tp
            arr = np.take(arr, np.arange(m * size, (m + 1) * size), axis=axis)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

    x_local, y_local = local("x"), local("y")
    w_local = local("w", rows=False, axis=1)
    tok_local, y_tok_local = local("tok_logits", axis=2), local("y_tok", axis=1)

    # model forward (tp): local columns, full logits gathered over 'model'
    logits = _gather_tiled(x_local @ w_local, model, dim=1)

    # loss and the gradient of the mean loss (dp): dL/dlogits on the full
    # logits, this rank's columns of it, both averaged over 'data'
    full = logits.detach().requires_grad_(True)
    loss = -torch.mean(torch.gather(F.log_softmax(full, dim=-1), 1, y_local.long()[:, None]))
    (dlogits,) = torch.autograd.grad(loss, full)
    cols = slice(m * w_local.shape[1], (m + 1) * w_local.shape[1])
    grads = sync_array(x_local.T @ dlogits[:, cols], "mean", data)
    loss = sync_array(loss.detach(), "mean", data)
    w_new = _gather_tiled(w_local - LR * grads, model, dim=1)

    # the collection on the local rows, one bucketed sync per group over 'data'
    coll = _make_collection(NUM_CLASSES, device)
    states = coll.sync_states(coll.update_state(coll.init_state(), logits, y_local), data)
    results = coll.compute_state(states)

    # the binned curve with the JAX step's shape-conditional threshold split
    binned = BinnedAveragePrecision(num_classes=NUM_CLASSES, thresholds=linspace_thresholds(n_th_pad), device=device)
    size = n_th_pad // tp
    local_binned = {
        k: v[m * size : (m + 1) * size] if v.ndim and v.shape[0] == n_th_pad else v for k, v in binned.init_state().items()
    }
    local_binned = binned.update_state(local_binned, torch.softmax(logits, dim=-1), y_local)
    local_binned = {k: sync_array(v, "sum", data) if v.ndim and v.shape[0] != n_th_pad else v for k, v in local_binned.items()}
    binned_state = {k: _gather_tiled(v, model, dim=0) if v.ndim and v.shape[0] == size else v for k, v in local_binned.items()}
    ap = torch.stack(binned.compute_state(binned_state))

    # per-token accuracy on this rank's (batch, sequence) tile, synced over both axes
    seq_metric = Accuracy(num_classes=NUM_CLASSES, average="micro", mdmc_average="global", device=device)
    seq_state = seq_metric.sync_states(seq_metric.update_state(seq_metric.init_state(), tok_local, y_tok_local), mesh.group(("data", "model")))
    seq_acc = seq_metric.compute_state(seq_state)

    if not bool(torch.isfinite(loss)):
        raise AssertionError("loss must be finite")
    for k, v in results.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"metric {k} not finite")
    if not bool(torch.isfinite(ap).all()):
        raise AssertionError("binned AP not finite")
    want_seq = float(np.mean(np.argmax(inp["tok_logits"], axis=1) == inp["y_tok"]))
    if abs(float(seq_acc) - want_seq) >= 1e-6:
        raise AssertionError((float(seq_acc), want_seq))
    return dict(states=states, binned_state=binned_state, seq_state=seq_state, w_new=w_new, loss=loss,
                results=results, ap=ap, seq_acc=seq_acc)


def _to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def _to_torch(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


def _spawned_rank(rank: int, n_devices: int, backend: str, init_file: str, results: Any) -> None:
    try:
        device = torch.device("cpu")
        if backend == "nccl":
            device = torch.device("cuda", rank)
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank, world_size=n_devices,
                                timeout=_GROUP_TIMEOUT)
        try:
            out = _dryrun_rank(n_devices, device)
            results.put((rank, True, _to_numpy(out) if rank == 0 else None))
        finally:
            dist.destroy_process_group()
    except Exception:  # the worker's boundary: report the failure to the parent, then exit
        results.put((rank, False, traceback.format_exc()))


def _spawn(n_devices: int, backend: str) -> Dict[str, Any]:
    """Run the step in ``n_devices`` spawned ranks; rank 0's outputs, on the CPU."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [
            ctx.Process(target=_spawned_rank, args=(rank, n_devices, backend, os.path.join(tmp, "store"), results))
            for rank in range(n_devices)
        ]
        for p in procs:
            p.start()
        try:
            reports = {}
            deadline = time.monotonic() + _SPAWN_TIMEOUT_S
            while len(reports) < n_devices:
                try:
                    rank, ok, payload = results.get(timeout=max(deadline - time.monotonic(), 0.1))
                except queue.Empty:
                    raise TimeoutError(f"dryrun_multichip({n_devices}): ranks {sorted(set(range(n_devices)) - set(reports))} "
                                       f"did not finish within {_SPAWN_TIMEOUT_S:.0f} s") from None
                reports[rank] = (ok, payload)
                if not ok:
                    raise RuntimeError(f"dryrun_multichip({n_devices}): rank {rank} failed:\n{payload}")
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.terminate()
                    p.join()
    return _to_torch(reports[0][1])


def dryrun_multichip(n_devices: int, device: Optional[Union[str, torch.device]] = None) -> Dict[str, Any]:
    """Run the distributed dry-run over ``n_devices`` ranks and return its
    outputs: the synced collection ``states``, ``binned_state`` and
    ``seq_state``, ``w_new`` (the whole updated weight), ``loss``,
    ``results``, the per-class ``ap`` and ``seq_acc``.

    In an existing world of ``n_devices`` ranks, every rank calls it and gets
    its outputs. Otherwise it makes the world (see the module docstring);
    spawned ranks return rank 0's outputs on the CPU.
    """
    device = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        return _dryrun_rank(n_devices, device)
    backend = "gloo" if device.type == "cpu" else "nccl"
    if n_devices == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, device_id=device if backend == "nccl" else None)
        try:
            return _dryrun_rank(1, device)
        finally:
            dist.destroy_process_group()
    if backend == "nccl" and n_devices > torch.cuda.device_count():
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) on the card needs {n_devices} CUDA devices (NCCL takes one per rank), "
            f"this machine has {torch.cuda.device_count()}; pass device='cpu' to run gloo ranks on the CPU"
        )
    return _spawn(n_devices, backend)
