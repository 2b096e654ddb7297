"""Data/shape helpers (counterpart of ``metrics_tpu/utils/data.py``).

Integer results keep the JAX package's dtypes: torch promotes sums of int32
to int64, so the reductions here pass the input dtype back explicitly.
"""
from __future__ import annotations

from typing import Any, Callable, List, Mapping, Optional, Sequence, Union

import torch
from torch import Tensor

METRIC_EPS = 1e-6


# --------------------------------------------------------------------------- #
# dim-zero reductions (the `dist_reduce_fx` vocabulary)
# --------------------------------------------------------------------------- #
def dim_zero_cat(x: Union[Tensor, Sequence[Tensor]]) -> Tensor:
    """Concatenate a (list of) tensor(s) along dim 0; scalars become 1-d. A
    :class:`~metrics_tpu_torch.core.buffers.CatBuffer` gives its valid rows."""
    if isinstance(x, Tensor):
        return x
    if hasattr(x, "to_array"):  # a CatBuffer (core.buffers imports this module)
        return x.to_array()
    x = [torch.atleast_1d(el) for el in x]
    if not x:
        raise ValueError("No samples to concatenate")
    return torch.cat(x, dim=0)


def _keep_dtype(x: Tensor) -> Optional[torch.dtype]:
    return None if x.dtype == torch.bool else x.dtype


def dim_zero_sum(x: Tensor) -> Tensor:
    return x.sum(dim=0, dtype=_keep_dtype(x))


def dim_zero_mean(x: Tensor) -> Tensor:
    return (x if x.is_floating_point() else x.to(torch.float32)).mean(dim=0)


def dim_zero_max(x: Tensor) -> Tensor:
    return x.amax(dim=0)


def dim_zero_min(x: Tensor) -> Tensor:
    return x.amin(dim=0)


def append_cat(state: Any, value: Tensor) -> Any:
    """A ``cat`` state with ``value`` appended: a new list for a list state;
    a buffer state is appended to in place (``Metric.update_state`` hands
    the update its own copy), which spares ``buf + [value]``'s clone."""
    if isinstance(state, list):
        return state + [value]
    state.append(value)
    return state


def bincount(x: Tensor, minlength: Optional[int] = None, weights: Optional[Tensor] = None) -> Tensor:
    """``jnp.bincount(x, weights, length=minlength)``: a static length, where
    a negative value counts in bin 0 and a value >= ``minlength`` is dropped
    (``torch.bincount`` raises on the first and grows on the second).

    Counts are int32 (exact integer scatter-adds); weighted sums are masked
    row sums, so the card gives the same bits on every run (float atomics
    would not). ``minlength=None`` reads the maximum back: eager only.
    """
    x = x.reshape(-1)
    if minlength is None:
        minlength = int(x.max()) + 1 if x.numel() else 0
    index = x.clamp(min=0).to(torch.int64)
    if weights is not None:
        bins = torch.arange(minlength, device=x.device)
        return torch.where(index[None, :] == bins[:, None], weights.reshape(-1)[None, :], 0).sum(dim=1)
    index = torch.where(index < minlength, index, minlength)  # the extra bin takes what is dropped
    ones = torch.ones_like(index, dtype=torch.int32)
    return torch.zeros(minlength + 1, dtype=torch.int32, device=x.device).index_add_(0, index, ones)[:minlength]


def linspace_thresholds(num: int) -> Tensor:
    """``jnp.linspace(0, 1.0, num)``, bit for bit.

    ``torch.linspace`` rounds differently (1 of 100 values, 20 of 101, 125 of
    1000 differ by an ulp) and a one-ulp shift moves scores between buckets.
    ``jnp.linspace`` computes ``i * float32(1 / (num - 1))`` and sets the last
    value to exactly 1.0.
    """
    if num <= 1:
        return torch.zeros(num, dtype=torch.float32)
    step = torch.tensor(1.0 / (num - 1), dtype=torch.float32)
    return torch.cat([torch.arange(num - 1, dtype=torch.float32) * step, torch.ones(1, dtype=torch.float32)])


def _flatten(x: Sequence) -> List:
    """Flatten one level of nesting."""
    return [item for sublist in x for item in sublist]


# --------------------------------------------------------------------------- #
# label-format conversions
# --------------------------------------------------------------------------- #
def to_onehot(label_tensor: Tensor, num_classes: Optional[int] = None) -> Tensor:
    """Dense ``(N, ...)`` integer labels -> int32 one-hot ``(N, C, ...)``.

    Out-of-range (and negative) labels give all-zero rows, as
    ``jax.nn.one_hot`` does; ``torch.nn.functional.one_hot`` would raise.
    """
    if num_classes is None:
        num_classes = int(label_tensor.max()) + 1
    classes = torch.arange(num_classes, device=label_tensor.device)
    oh = (label_tensor.unsqueeze(-1) == classes).to(torch.int32)
    # (N, ..., C) -> (N, C, ...)
    return oh.movedim(-1, 1) if oh.ndim > 2 else oh


def argmax_first(x: Tensor, dim: int = 1) -> Tensor:
    """First-occurrence argmax along ``dim`` via max + min-over-index.

    Same result as ``metrics_tpu.utils.data.argmax_first`` in every case,
    NaN rows included: a row whose max is NaN matches no element and returns
    ``x.shape[dim]`` (``torch.argmax`` would return the NaN's index).
    """
    dim = dim % x.ndim
    n = x.shape[dim]
    pmax = x.amax(dim=dim, keepdim=True)
    shape = [1] * x.ndim
    shape[dim] = n
    index = torch.arange(n, device=x.device).reshape(shape)
    return torch.where(x == pmax, index, n).amin(dim=dim)


def select_topk(prob_tensor: Tensor, topk: int = 1, dim: int = 1) -> Tensor:
    """int32 mask of the top-k entries along ``dim`` (ties to the lower index)."""
    if topk == 1:
        idx = argmax_first(prob_tensor, dim=dim).unsqueeze(dim)
        mask = torch.zeros_like(prob_tensor, dtype=torch.int32)
        return mask.scatter_(dim, idx.clamp(max=prob_tensor.shape[dim] - 1), 1)
    thresh = torch.sort(prob_tensor, dim=dim, descending=True).values.narrow(dim, topk - 1, 1)
    ge = prob_tensor >= thresh
    order = torch.argsort(torch.argsort(-prob_tensor, dim=dim, stable=True), dim=dim, stable=True)
    return (ge & (order < topk)).to(torch.int32)


def to_categorical(x: Tensor, argmax_dim: int = 1) -> Tensor:
    """Probabilities or one-hot rows -> dense labels (the first maximum)."""
    return torch.argmax(x, dim=argmax_dim)


# --------------------------------------------------------------------------- #
# collection traversal
# --------------------------------------------------------------------------- #
def apply_to_collection(data: Any, dtype: Union[type, tuple], function: Callable, *args: Any, **kwargs: Any) -> Any:
    """Recursively apply ``function`` to all elements of type ``dtype``."""
    elem_type = type(data)
    if isinstance(data, dtype):
        return function(data, *args, **kwargs)
    if isinstance(data, Mapping):
        return elem_type({k: apply_to_collection(v, dtype, function, *args, **kwargs) for k, v in data.items()})
    if isinstance(data, tuple) and hasattr(data, "_fields"):  # namedtuple
        return elem_type(*(apply_to_collection(d, dtype, function, *args, **kwargs) for d in data))
    if isinstance(data, Sequence) and not isinstance(data, str):
        return elem_type([apply_to_collection(d, dtype, function, *args, **kwargs) for d in data])
    return data


def _squeeze_if_scalar(data: Any) -> Any:
    """Squeeze size-1 tensors to 0-d (0-d tensors pass through untouched: a
    list of C per-class scalars costs no C squeeze ops)."""
    return apply_to_collection(data, Tensor, lambda x: x.squeeze() if x.ndim > 0 and x.numel() == 1 else x)


# --------------------------------------------------------------------------- #
# grouping
# --------------------------------------------------------------------------- #
def get_group_indexes(indexes: Tensor) -> List[Tensor]:
    """The positions of each value of ``indexes``, one int32 tensor per value,
    in the order the values first appear, each group's positions ascending:
    what the JAX package's host dict of lists gives.

    One stable sort groups the positions on the device; only the group
    starts, sizes and order are read back (three reads, where a ``tolist()``
    of every index would move the whole stream to the host).
    """
    idx = indexes.reshape(-1)
    n = idx.numel()
    if n == 0:
        return []
    order = torch.argsort(idx, stable=True)  # positions ascending within a value
    sorted_idx = idx[order]
    starts = torch.ones(n, dtype=torch.bool, device=idx.device)
    starts[1:] = sorted_idx[1:] != sorted_idx[:-1]
    start_pos = torch.arange(n, device=idx.device)[starts]
    sizes = torch.diff(start_pos, append=start_pos.new_full((1,), n)).tolist()
    first_seen = torch.argsort(order[starts]).tolist()  # the groups in first-appearance order
    groups = torch.split(order.to(torch.int32), sizes)
    return [groups[g] for g in first_seen]


def allclose(t1: Tensor, t2: Tensor, **kwargs: Any) -> bool:
    """Shape-then-value closeness check (reads the answer back to the host)."""
    if t1.shape != t2.shape:
        return False
    return bool(torch.allclose(t1.to(t2.dtype) if t1.dtype != t2.dtype else t1, t2, **kwargs))
