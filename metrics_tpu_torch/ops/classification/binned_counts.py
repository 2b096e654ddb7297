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
  ``searchsorted``, histogram the buckets per class in int32 with a
  fixed-size ``scatter_add``, cumsum; labels become
  ``labels[:, None] == arange(C)``. The CPU path and the on-card comparison
  use it.

Thresholds are sorted once, when a metric is built
(:func:`sort_thresholds`); both versions take the sorted grid and the
permutation back to the caller's order.

**Under a tenant axis.** Inside ``torch.vmap`` the wrapper calls the
operator ``metrics_tpu::binned_counts`` (a ``torch.library.custom_op`` with
a fake implementation, so the engines' probe and a CUDA-graph capture see
one operator; outside vmap it launches directly, as before). Its ``vmap``
rule turns a batched call, as a
:class:`~metrics_tpu_torch.tenancy.TenantSet`'s stacked update makes it,
into one call of ``metrics_tpu::binned_counts_batched``: ``(B, N, C)``
scores with ``(B, N, C)`` targets or ``(B, N)`` labels and one threshold
grid give ``(B, 3, C, T)`` counts. On the card that is one launch of
``binned_counts_batched_launch`` for every tenant (the Pallas kernel's grid
under ``jax.vmap``; one a slice of 65,535 tenants beyond that, the grid's z
limit), counted under its own name; on the CPU it is the plain
version under ``torch.vmap``, which the scatter-add form allows. A batched
threshold grid raises: a tenant set shares one.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch import Tensor
from torch._C._functorch import is_batchedtensor

from metrics_tpu_torch.ops.kernels import KERNELS, count_launch
from metrics_tpu_torch.utils.exceptions import Uncapturable

KERNEL = KERNELS["binned_counts"]
BATCHED_KERNEL = KERNELS["binned_counts_batched"]

Counts = Tuple[Tensor, Tensor, Tensor]


class SortedThresholds(NamedTuple):
    """A threshold grid sorted once: ``values[b] == thresholds[order[b]]``."""

    values: Tensor  # (T,) float32, ascending
    order: Tensor  # (T,) int32


def sort_thresholds(thresholds: Tensor) -> SortedThresholds:
    thresholds = thresholds.to(torch.float32).reshape(-1)
    order = torch.argsort(thresholds, stable=True)
    return SortedThresholds(thresholds[order].contiguous(), order.to(torch.int32).contiguous())


def _plain_counts(preds: Tensor, target: Tensor, grid: SortedThresholds) -> Tensor:
    """``(..., 3, C, T)`` counts of ``(..., N, C)`` scores: every leading
    index (a tenant) is its own problem, counted with one histogram whose
    bins carry the tenant's offset."""
    *lead, n, c = preds.shape
    b = 1
    for d in lead:
        b *= d
    t = grid.values.numel()
    nb = t + 1
    preds = preds.reshape(b, n, c)
    bucket = torch.searchsorted(grid.values, preds.contiguous(), right=True)  # (B, N, C) in [0, T]
    # searchsorted sends NaN past the end; `nan >= thr` is False everywhere
    bucket = torch.where(torch.isnan(preds), 0, bucket)
    tenant = torch.arange(b, device=preds.device).reshape(b, 1, 1) * (c * nb)
    seg = (tenant + torch.arange(c, device=preds.device) * nb + bucket).reshape(-1)
    spare = b * c * nb  # negatives go here in the positive histogram and vice versa
    if target.ndim == len(lead) + 1:  # class labels: row n is positive for class label[n] only
        is_pos = (target.reshape(b, n, 1) == torch.arange(c, device=target.device)).reshape(-1)
    else:
        is_pos = target.reshape(-1).to(torch.bool)
    # a fixed-size scatter-add, not bincount: vmap batches it, and the int32
    # counts are the same
    ones = torch.ones_like(seg, dtype=torch.int32)
    hist = torch.zeros(spare + 1, dtype=torch.int32, device=preds.device)
    pos = hist.scatter_add(0, torch.where(is_pos, seg, spare), ones)[:spare].reshape(b, c, nb)
    neg = hist.scatter_add(0, torch.where(is_pos, spare, seg), ones)[:spare].reshape(b, c, nb)

    cum_pos = torch.cumsum(pos, dim=2, dtype=torch.int32)[..., :t]
    cum_neg = torch.cumsum(neg, dim=2, dtype=torch.int32)[..., :t]
    tp = pos.sum(dim=2, keepdim=True, dtype=torch.int32) - cum_pos
    fp = neg.sum(dim=2, keepdim=True, dtype=torch.int32) - cum_neg
    fn = cum_pos

    inv = torch.argsort(grid.order.to(torch.int64))  # back to the caller's threshold order
    out = torch.stack([tp[..., inv], fp[..., inv], fn[..., inv]], dim=1).to(torch.float32)
    return out.reshape(*lead, 3, c, t)


def _counts_from_sorted_plain(preds: Tensor, target: Tensor, grid: SortedThresholds) -> Counts:
    return tuple(_plain_counts(preds, target, grid).unbind(0))


def binned_counts_plain(preds: Tensor, target: Tensor, thresholds: Tensor) -> Counts:
    """The plain PyTorch version: ``(TP, FP, FN)``, each ``(C, T)`` float32.
    ``target`` is dense ``(N, C)`` or ``(N,)`` class labels, as for
    :func:`binned_counts`."""
    return _counts_from_sorted_plain(preds, target, sort_thresholds(thresholds))


# the batched entry's grid holds the tenants in its z dimension
MAX_TENANTS_PER_LAUNCH = 65535
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


def _check_kernel_inputs(preds: Tensor, target: Tensor, grid: SortedThresholds, rows: int) -> int:
    """Raise on what the kernel does not take; return the target's form."""
    if preds.device.type != "cuda":
        raise ValueError(f"binned_counts runs on CPU or CUDA tensors, got {preds.device}")
    form = _FORMS.get(target.dtype)
    if preds.dtype != torch.float32 or form is None or (form == 0) != (target.ndim == preds.ndim):
        raise TypeError(
            f"binned_counts kernel takes float32 scores with bool/uint8 (N, C) targets or int32/int64 (N,) labels,"
            f" got {preds.dtype} and {target.dtype} {tuple(target.shape)}"
        )
    index = preds.get_device()
    if target.get_device() != index or grid.values.get_device() != index or grid.order.get_device() != index:
        raise ValueError(f"binned_counts: target and thresholds must lie on {preds.device} with the scores")
    if not (preds.is_contiguous() and target.is_contiguous()):
        raise ValueError("binned_counts kernel takes contiguous scores and targets")
    if rows >= 2**31:
        raise ValueError(f"binned_counts kernel takes fewer than 2**31 rows, got {rows}")
    return form


def _launch(preds: Tensor, target: Tensor, grid: SortedThresholds, b: Optional[int]) -> Tensor:
    """``(3, C, T)`` counts (``b is None``) from one launch of the unbatched
    entry, or ``(b, 3, C, T)`` for ``b`` tenants from the tenant-batched
    entry: one launch for up to :data:`MAX_TENANTS_PER_LAUNCH` tenants, and
    one a slice of that many beyond, each counted."""
    n, c = preds.shape[-2:]
    t = grid.values.numel()
    form = _check_kernel_inputs(preds, target, grid, n)
    shape = (3, c, t) if b is None else (b, 3, c, t)
    if n == 0 or c == 0 or t == 0 or b == 0:  # nothing to count: zeros, no launch
        return torch.zeros(shape, dtype=torch.float32, device=preds.device)
    out = torch.empty(shape, dtype=torch.float32, device=preds.device)  # the kernel writes every element
    if target.dtype == torch.bool:
        target = target.view(torch.uint8)
    kernel = KERNEL if b is None else BATCHED_KERNEL
    lib = kernel._lib or kernel.lib()

    def launch(p: Tensor, y: Tensor, o: Tensor, bs: Optional[int]) -> int:
        stream = torch.cuda.current_stream().cuda_stream
        # 0 on the cluster path
        need = lib.binned_counts_workspace_len(c, t) if bs is None else lib.binned_counts_batched_workspace_len(bs, c, t)
        if need < 0:
            raise RuntimeError("binned_counts kernel could not query the device")
        ws_ptr = _workspace(preds.device, stream, need).data_ptr() if need else None
        if bs is None:
            return lib.binned_counts_launch(
                p.data_ptr(), y.data_ptr(), form, grid.values.data_ptr(), grid.order.data_ptr(),
                o.data_ptr(), ws_ptr, need, n, c, t, stream,
            )
        return lib.binned_counts_batched_launch(
            p.data_ptr(), y.data_ptr(), form, grid.values.data_ptr(), grid.order.data_ptr(),
            o.data_ptr(), ws_ptr, need, bs, n, c, t, stream,
        )

    step = MAX_TENANTS_PER_LAUNCH
    slices = [(None, preds, target, out)] if b is None else [
        (min(step, b - s), preds[s:s + step], target[s:s + step], out[s:s + step]) for s in range(0, b, step)
    ]
    index = preds.get_device()
    for bs, p, y, o in slices:
        if index == torch.cuda.current_device():
            err = launch(p, y, o, bs)
        else:
            with torch.cuda.device(index):
                err = launch(p, y, o, bs)
        if err != 0:
            raise RuntimeError(f"binned_counts kernel launch failed with CUDA error {err}")
        count_launch(kernel)
    return out


@torch.library.custom_op("metrics_tpu::binned_counts", mutates_args=())
def _counts_op(preds: Tensor, target: Tensor, values: Tensor, order: Tensor) -> Tensor:
    """``(3, C, T)``: the plain version on the CPU, one launch on the card."""
    grid = SortedThresholds(values, order)
    if preds.device.type == "cpu":
        return _plain_counts(preds, target, grid)
    return _launch(preds, target, grid, None)


@_counts_op.register_fake
def _(preds: Tensor, target: Tensor, values: Tensor, order: Tensor) -> Tensor:
    return preds.new_empty((3, preds.shape[1], values.shape[0]))


@torch.library.custom_op("metrics_tpu::binned_counts_batched", mutates_args=())
def _batched_op(preds: Tensor, target: Tensor, values: Tensor, order: Tensor) -> Tensor:
    """``(B, 3, C, T)`` for ``(B, N, C)`` scores: the plain version on the
    CPU, one launch for every tenant on the card (up to 65,535)."""
    grid = SortedThresholds(values, order)
    if preds.device.type == "cpu":
        return _plain_counts(preds, target, grid)
    return _launch(preds, target, grid, preds.shape[0])


@_batched_op.register_fake
def _(preds: Tensor, target: Tensor, values: Tensor, order: Tensor) -> Tensor:
    return preds.new_empty((preds.shape[0], 3, preds.shape[2], values.shape[0]))


def _tenant_major(x: Tensor, dim: Optional[int], size: int) -> Tensor:
    """``x`` with its vmapped dimension first (broadcast where unbatched), contiguous."""
    x = x.movedim(dim, 0) if dim is not None else x.expand(size, *x.shape)
    return x.contiguous()


def _refuse_batched_grid(grid_dims: Tuple[Optional[int], Optional[int]]) -> None:
    if any(d is not None for d in grid_dims):
        raise ValueError(
            "binned_counts under vmap takes one threshold grid for every tenant; the grid was batched"
        )


def _counts_vmap(info: Any, in_dims: Tuple, preds: Tensor, target: Tensor, values: Tensor, order: Tensor):
    """A tenant axis over an unbatched call: one batched call for every tenant."""
    _refuse_batched_grid(in_dims[2:])
    b = info.batch_size
    return _batched_op(_tenant_major(preds, in_dims[0], b), _tenant_major(target, in_dims[1], b), values, order), 0


def _batched_vmap(info: Any, in_dims: Tuple, preds: Tensor, target: Tensor, values: Tensor, order: Tensor):
    """A second tenant axis: the two axes fold into one batched call."""
    _refuse_batched_grid(in_dims[2:])
    outer = info.batch_size
    p, y = _tenant_major(preds, in_dims[0], outer), _tenant_major(target, in_dims[1], outer)
    inner = p.shape[1]
    out = _batched_op(p.reshape(outer * inner, *p.shape[2:]), y.reshape(outer * inner, *y.shape[2:]), values, order)
    return out.reshape(outer, inner, *out.shape[1:]), 0


_counts_op.register_vmap(_counts_vmap)
_batched_op.register_vmap(_batched_vmap)


def binned_counts(preds: Tensor, target: Tensor, grid: SortedThresholds, *, plain: bool = False) -> Counts:
    """``(TP, FP, FN)``, each ``(C, T)`` float32, from ``(N, C)`` scores and a
    target that is either dense, ``(N, C)`` bool (or uint8, nonzero is
    positive), or ``(N,)`` integer class labels (row n is positive for class
    ``label[n]`` alone; a label outside ``[0, C)`` makes an all-negative row,
    as its one-hot would).

    CPU tensors take the plain version. CUDA tensors launch the kernel on the
    current stream, or raise on what it does not take (labels must be int32
    or int64). Under ``torch.vmap`` (a tenant axis) every tenant's counts
    come from one batched launch (see the module's docstring). ``plain=True``
    runs the plain version on any device; it exists so that a check can hold
    the kernel against it, and no metric path sets it by default.
    """
    if preds.ndim != 2 or (target.shape != preds.shape and target.shape != preds.shape[:1]):
        raise ValueError(
            f"binned_counts takes (N, C) scores with (N, C) targets or (N,) labels, got {tuple(preds.shape)} "
            f"and {tuple(target.shape)}"
        )
    if plain:
        return _counts_from_sorted_plain(preds, target, grid)
    if preds.device.type not in ("cpu", "cuda"):
        raise ValueError(f"binned_counts runs on CPU or CUDA tensors, got {preds.device}")
    if not (is_batchedtensor(preds) or is_batchedtensor(target)):
        # outside vmap: the launch itself, without the operator's dispatch,
        # which costs the call about 20 us more on the host (medians 101.1
        # and 101.5 against 77.1 and 82.9 us in two runs at (1024, 1000, 100)
        # labels on an H100, chip_smoke.py's route timing)
        if preds.device.type == "cpu":
            return _counts_from_sorted_plain(preds, target, grid)
        return _launch(preds, target, grid, None).unbind(0)
    return _counts_op(preds, target, grid.values, grid.order).unbind(0)


def binned_counts_batched(preds: Tensor, target: Tensor, grid: SortedThresholds, *, plain: bool = False) -> Tensor:
    """``(B, 3, C, T)`` counts of ``B`` tenants: ``(B, N, C)`` scores with
    ``(B, N, C)`` targets or ``(B, N)`` labels, one threshold grid. What the
    ``vmap`` rule of :func:`binned_counts` calls; on the card one launch for
    every tenant. ``plain=True`` runs the plain version on any device."""
    if preds.ndim != 3 or (target.shape != preds.shape and target.shape != preds.shape[:2]):
        raise ValueError(
            f"binned_counts_batched takes (B, N, C) scores with (B, N, C) targets or (B, N) labels, got"
            f" {tuple(preds.shape)} and {tuple(target.shape)}"
        )
    if plain:
        return _plain_counts(preds, target, grid)
    if preds.device.type not in ("cpu", "cuda"):
        raise ValueError(f"binned_counts runs on CPU or CUDA tensors, got {preds.device}")
    return _batched_op(preds, target, grid.values, grid.order)
