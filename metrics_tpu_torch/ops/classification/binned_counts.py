"""Binned threshold counts, the hot op of the binned PR-curve metrics.

Counterpart of ``metrics_tpu/ops/classification/binned_pallas.py``. For
``(N, C)`` scores and targets and T thresholds, ``(TP, FP, FN)`` of shape
``(C, T)`` count, per class and threshold, the rows predicted positive
(``score >= threshold``; NaN scores never are) against the target.

- :func:`binned_counts` is the wrapper. For CUDA tensors it launches the
  hand-written kernel ``metrics_tpu_torch/csrc/binned_counts.cu`` or raises;
  it never falls back. Only for CPU tensors does it run the plain version.
- :func:`binned_counts_plain` is the plain PyTorch version of the same
  function (the form of ``_binned_counts_xla``): bucketize each score with
  ``searchsorted``, histogram the buckets per class in int32, cumsum. The
  CPU path and the on-card comparison use it.

Thresholds are sorted once, when a metric is built
(:func:`sort_thresholds`); both versions take the sorted grid and the
permutation back to the caller's order.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.ops.kernels import KERNELS

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


def _counts_from_sorted_plain(preds: Tensor, target_bool: Tensor, grid: SortedThresholds) -> Counts:
    n, c = preds.shape
    t = grid.values.numel()
    nb = t + 1
    bucket = torch.searchsorted(grid.values, preds.contiguous(), right=True)  # (N, C) in [0, T]
    # searchsorted sends NaN past the end; `nan >= thr` is False everywhere
    bucket = torch.where(torch.isnan(preds), 0, bucket)
    seg = (torch.arange(c, device=preds.device) * nb + bucket).reshape(-1)
    spare = c * nb  # negatives go here in the positive histogram and vice versa
    is_pos = target_bool.reshape(-1).to(torch.bool)
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


def binned_counts_plain(preds: Tensor, target_bool: Tensor, thresholds: Tensor) -> Counts:
    """The plain PyTorch version: ``(TP, FP, FN)``, each ``(C, T)`` float32."""
    return _counts_from_sorted_plain(preds, target_bool, sort_thresholds(thresholds))


def _check_kernel_inputs(preds: Tensor, target: Tensor, grid: SortedThresholds) -> None:
    device = preds.device
    if preds.dtype != torch.float32:
        raise TypeError(f"binned_counts kernel takes float32 scores, got {preds.dtype}")
    if target.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"binned_counts kernel takes bool or uint8 targets, got {target.dtype}")
    if grid.values.dtype != torch.float32 or grid.order.dtype != torch.int32:
        raise TypeError("binned_counts kernel takes float32 sorted thresholds and an int32 order")
    if grid.values.ndim != 1 or grid.order.shape != grid.values.shape:
        raise ValueError("sorted thresholds and their order must be 1-D of equal length")
    for name, x in (("target", target), ("thresholds", grid.values), ("order", grid.order)):
        if x.device != device:
            raise ValueError(f"binned_counts: {name} lies on {x.device}, scores on {device}")
    for name, x in (("preds", preds), ("target", target), ("thresholds", grid.values), ("order", grid.order)):
        if not x.is_contiguous():
            raise ValueError(f"binned_counts kernel takes contiguous tensors; {name} is not")


def binned_counts(preds: Tensor, target_bool: Tensor, grid: SortedThresholds, *, plain: bool = False) -> Counts:
    """``(TP, FP, FN)``, each ``(C, T)`` float32, from ``(N, C)`` scores and targets.

    CPU tensors take the plain version. CUDA tensors launch the kernel on the
    current stream, or raise on what it does not take. ``plain=True`` runs
    the plain version on any device; it exists so that a check can hold the
    kernel against it, and no metric path sets it by default.
    """
    if preds.ndim != 2 or target_bool.shape != preds.shape:
        raise ValueError(
            f"binned_counts takes (N, C) scores and targets of one shape, got {tuple(preds.shape)} "
            f"and {tuple(target_bool.shape)}"
        )
    if plain or preds.device.type == "cpu":
        return _counts_from_sorted_plain(preds, target_bool, grid)
    if preds.device.type != "cuda":
        raise ValueError(f"binned_counts runs on CPU or CUDA tensors, got {preds.device}")
    _check_kernel_inputs(preds, target_bool, grid)

    n, c = preds.shape
    t = grid.values.numel()
    if n == 0 or c == 0 or t == 0:  # nothing to count: zeros, no launch
        out = torch.zeros((3, c, t), dtype=torch.float32, device=preds.device)
        return out[0], out[1], out[2]
    out = torch.empty((3, c, t), dtype=torch.float32, device=preds.device)  # the kernel writes every element
    hist = torch.zeros((2, c, t + 1), dtype=torch.int32, device=preds.device)
    target_u8 = target_bool.view(torch.uint8) if target_bool.dtype == torch.bool else target_bool
    lib = KERNEL.lib()
    with torch.cuda.device(preds.device):
        err = lib.binned_counts_launch(
            preds.data_ptr(), target_u8.data_ptr(), grid.values.data_ptr(), grid.order.data_ptr(),
            hist.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            n, c, t, torch.cuda.current_stream(preds.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"binned_counts kernel launch failed with CUDA error {err}")
    KERNEL.launches += 1
    return out[0], out[1], out[2]
