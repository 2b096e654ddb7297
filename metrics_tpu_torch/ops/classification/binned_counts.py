"""Binned threshold counts, the hot op of the binned PR-curve metrics.

Counterpart of ``metrics_tpu/ops/classification/binned_pallas.py``. For
``(N, C)`` scores, a target and T thresholds, ``(TP, FP, FN)`` of shape
``(C, T)`` count, per class and threshold, the rows predicted positive
(``score >= threshold``; NaN scores never are) against the target. The
target is dense, ``(N, C)`` bool, or ``(N,)`` class labels, which stand for
their one-hot (``to_onehot(labels) == 1``) without it being built.

- :func:`binned_counts` is the wrapper. For CUDA tensors it launches the
  hand-written kernel ``metrics_tpu_torch/csrc/binned_counts.cu`` or raises;
  it never falls back. Only for CPU tensors does it run the plain version.
- :func:`binned_counts_plain` is the plain PyTorch version of the same
  function (the form of ``_binned_counts_xla``): bucketize each score with
  ``searchsorted``, histogram the buckets per class in int32, cumsum; labels
  become ``labels[:, None] == arange(C)``. The CPU path and the on-card
  comparison use it.

Thresholds are sorted once, when a metric is built
(:func:`sort_thresholds`); both versions take the sorted grid and the
permutation back to the caller's order.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.ops.kernels import KERNELS
from metrics_tpu_torch.utils.exceptions import Uncapturable

KERNEL = KERNELS["binned_counts"]

Counts = Tuple[Tensor, Tensor, Tensor]


class SortedThresholds(NamedTuple):
    """A threshold grid sorted once: ``values[b] == thresholds[order[b]]``."""

    values: Tensor  # (T,) float32, ascending
    order: Tensor  # (T,) int32


def sort_thresholds(thresholds: Tensor) -> SortedThresholds:
    thresholds = thresholds.to(torch.float32).reshape(-1)
    order = torch.argsort(thresholds, stable=True)
    return SortedThresholds(thresholds[order].contiguous(), order.to(torch.int32).contiguous())


def _counts_from_sorted_plain(preds: Tensor, target: Tensor, grid: SortedThresholds) -> Counts:
    n, c = preds.shape
    t = grid.values.numel()
    nb = t + 1
    bucket = torch.searchsorted(grid.values, preds.contiguous(), right=True)  # (N, C) in [0, T]
    # searchsorted sends NaN past the end; `nan >= thr` is False everywhere
    bucket = torch.where(torch.isnan(preds), 0, bucket)
    seg = (torch.arange(c, device=preds.device) * nb + bucket).reshape(-1)
    spare = c * nb  # negatives go here in the positive histogram and vice versa
    if target.ndim == 1:  # class labels: row n is positive for class label[n] only
        is_pos = (target[:, None] == torch.arange(c, device=target.device)).reshape(-1)
    else:
        is_pos = target.reshape(-1).to(torch.bool)
    pos = torch.bincount(torch.where(is_pos, seg, spare), minlength=spare + 1)[:spare]
    neg = torch.bincount(torch.where(is_pos, spare, seg), minlength=spare + 1)[:spare]
    pos = pos.to(torch.int32).reshape(c, nb)
    neg = neg.to(torch.int32).reshape(c, nb)

    cum_pos = torch.cumsum(pos, dim=1, dtype=torch.int32)[:, :t]
    cum_neg = torch.cumsum(neg, dim=1, dtype=torch.int32)[:, :t]
    tp = pos.sum(dim=1, keepdim=True, dtype=torch.int32) - cum_pos
    fp = neg.sum(dim=1, keepdim=True, dtype=torch.int32) - cum_neg
    fn = cum_pos

    inv = torch.argsort(grid.order.to(torch.int64))  # back to the caller's threshold order
    return tp[:, inv].to(torch.float32), fp[:, inv].to(torch.float32), fn[:, inv].to(torch.float32)


def binned_counts_plain(preds: Tensor, target: Tensor, thresholds: Tensor) -> Counts:
    """The plain PyTorch version: ``(TP, FP, FN)``, each ``(C, T)`` float32.
    ``target`` is dense ``(N, C)`` or ``(N,)`` class labels, as for
    :func:`binned_counts`."""
    return _counts_from_sorted_plain(preds, target, sort_thresholds(thresholds))


# kernel target forms (csrc/binned_counts.cu, TargetForm)
_FORMS = {torch.bool: 0, torch.uint8: 0, torch.int32: 1, torch.int64: 2}
# The global path's zeroed int32 workspace, one per (device, stream) that has
# run that path, held for the life of the process; every launch leaves it zeroed.
_WORKSPACES: Dict[Tuple[int, int], Tensor] = {}


def _workspace(device: torch.device, stream: int, need: int) -> Tensor:
    """The stream's workspace, of ``need`` int32 at least.

    Refused under a CUDA graph capture when it does not exist yet: made there,
    it would live in the graph's private pool. The compiled engines run a step
    once on their capture stream before they capture it, so it exists then.
    """
    ws = _WORKSPACES.get((device.index, stream))
    if ws is None or ws.numel() < need:
        if torch.cuda.is_current_stream_capturing():
            raise Uncapturable(
                "binned_counts: the large-T workspace of this stream would be made inside a CUDA graph capture;"
                " run the step once on the capture stream first"
            )
        ws = torch.zeros(need, dtype=torch.int32, device=device)  # once per stream and size
        _WORKSPACES[(device.index, stream)] = ws
    return ws


def binned_counts(preds: Tensor, target: Tensor, grid: SortedThresholds, *, plain: bool = False) -> Counts:
    """``(TP, FP, FN)``, each ``(C, T)`` float32, from ``(N, C)`` scores and a
    target that is either dense, ``(N, C)`` bool (or uint8, nonzero is
    positive), or ``(N,)`` integer class labels (row n is positive for class
    ``label[n]`` alone; a label outside ``[0, C)`` makes an all-negative row,
    as its one-hot would).

    CPU tensors take the plain version. CUDA tensors launch the kernel on the
    current stream, or raise on what it does not take (labels must be int32
    or int64). ``plain=True`` runs the plain version on any device; it exists
    so that a check can hold the kernel against it, and no metric path sets
    it by default.
    """
    if preds.ndim != 2 or (target.shape != preds.shape and target.shape != preds.shape[:1]):
        raise ValueError(
            f"binned_counts takes (N, C) scores with (N, C) targets or (N,) labels, got {tuple(preds.shape)} "
            f"and {tuple(target.shape)}"
        )
    if plain or preds.device.type == "cpu":
        return _counts_from_sorted_plain(preds, target, grid)
    if preds.device.type != "cuda":
        raise ValueError(f"binned_counts runs on CPU or CUDA tensors, got {preds.device}")
    form = _FORMS.get(target.dtype)
    if preds.dtype != torch.float32 or form is None or (form == 0) != (target.ndim == 2):
        raise TypeError(
            f"binned_counts kernel takes float32 scores with bool/uint8 (N, C) targets or int32/int64 (N,) labels,"
            f" got {preds.dtype} and {target.dtype} {tuple(target.shape)}"
        )
    index = preds.get_device()
    if target.get_device() != index or grid.values.get_device() != index:
        raise ValueError(f"binned_counts: target and thresholds must lie on {preds.device} with the scores")
    if not (preds.is_contiguous() and target.is_contiguous()):
        raise ValueError("binned_counts kernel takes contiguous scores and targets")

    n, c = preds.shape
    t = grid.values.numel()
    if n == 0 or c == 0 or t == 0:  # nothing to count: zeros, no launch
        return torch.zeros((3, c, t), dtype=torch.float32, device=preds.device).unbind(0)
    if n >= 2**31:
        raise ValueError(f"binned_counts kernel takes fewer than 2**31 rows, got {n}")
    out = torch.empty((3, c, t), dtype=torch.float32, device=preds.device)  # the kernel writes every element
    if target.dtype == torch.bool:
        target = target.view(torch.uint8)
    lib = KERNEL._lib or KERNEL.lib()

    def launch() -> int:
        stream = torch.cuda.current_stream().cuda_stream
        need = lib.binned_counts_workspace_len(c, t)  # 0 on the cluster path
        if need < 0:
            raise RuntimeError("binned_counts kernel could not query the device")
        ws_ptr = _workspace(preds.device, stream, need).data_ptr() if need else None
        return lib.binned_counts_launch(
            preds.data_ptr(), target.data_ptr(), form, grid.values.data_ptr(), grid.order.data_ptr(),
            out.data_ptr(), ws_ptr, need, n, c, t, stream,
        )

    if index == torch.cuda.current_device():
        err = launch()
    else:
        with torch.cuda.device(index):
            err = launch()
    if err != 0:
        raise RuntimeError(f"binned_counts kernel launch failed with CUDA error {err}")
    KERNEL.launches += 1
    return out.unbind(0)
