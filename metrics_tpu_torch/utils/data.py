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
    """Concatenate a (list of) tensor(s) along dim 0; scalars become 1-d."""
    if isinstance(x, Tensor):
        return x
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
