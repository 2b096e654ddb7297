"""Permutation Invariant Training (counterpart of ``metrics_tpu/ops/audio/pit.py``).

Every (target, prediction) speaker pair is scored in one batched call of the
metric over ``B * S * S`` rows. The best assignment is the exhaustive search
over the ``S!`` permutation table, a device constant made once per speaker
count and device (on the first, eager call), with ``argmax``/``argmin``
taking the first index on ties as JAX's do. An eager call with more than
``_HUNGARIAN_CUTOVER`` speakers reads the (B, S, S) matrix to the host for
scipy's ``linear_sum_assignment``, as the JAX package does outside a trace;
while the engines probe or capture a step (``utils.checks._capturing``) the
exhaustive table is used instead.
"""
from __future__ import annotations

from functools import lru_cache
from itertools import permutations
from typing import Any, Callable, Tuple

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _capturing

_HUNGARIAN_CUTOVER = 7  # 7! = 5040 permutations; beyond this use scipy eagerly


@lru_cache(maxsize=None)
def _permutation_table(spk_num: int, device: torch.device) -> Tensor:
    """(S!, S) int64: row p maps target t to prediction ``table[p, t]``."""
    return torch.tensor(list(permutations(range(spk_num))), dtype=torch.int64, device=device)


def _metric_matrix(preds: Tensor, target: Tensor, metric_func: Callable, **kwargs: Any) -> Tensor:
    """[B, S, S] matrix with mtx[b, t, p] = metric(preds[b, p], target[b, t])."""
    batch_size, spk_num = target.shape[0:2]
    shape = (batch_size, spk_num, spk_num)
    flat_preds = preds[:, None].expand(shape + tuple(preds.shape[2:])).reshape((-1,) + tuple(preds.shape[2:]))
    flat_target = target[:, :, None].expand(shape + tuple(target.shape[2:])).reshape((-1,) + tuple(target.shape[2:]))
    vals = metric_func(flat_preds, flat_target, **kwargs)
    return vals.reshape(shape)


def _find_best_perm_exhaustive(metric_mtx: Tensor, eval_max: bool) -> Tuple[Tensor, Tensor]:
    """Exhaustive search over the ``S!`` permutation table."""
    spk_num = metric_mtx.shape[-1]
    ps = _permutation_table(spk_num, metric_mtx.device)  # (P, S)
    cols = torch.arange(spk_num, device=metric_mtx.device)[None, :]
    metric_of_ps = metric_mtx[:, cols, ps].mean(dim=-1)  # (B, P)
    best_idx = torch.argmax(metric_of_ps, dim=-1) if eval_max else torch.argmin(metric_of_ps, dim=-1)
    best_metric = torch.take_along_dim(metric_of_ps, best_idx[:, None], dim=-1)[:, 0]
    best_perm = ps[best_idx].to(torch.int32)
    return best_metric, best_perm


def _find_best_perm_hungarian(metric_mtx: Tensor, eval_max: bool) -> Tuple[Tensor, Tensor]:
    """scipy's linear-sum assignment on the host (eager calls, large S)."""
    from scipy.optimize import linear_sum_assignment

    mtx = metric_mtx.detach().cpu().numpy()
    best_perm = np.stack([linear_sum_assignment(m, eval_max)[1] for m in mtx])
    best_perm_t = torch.from_numpy(best_perm.astype(np.int32)).to(metric_mtx.device)
    best_metric = torch.take_along_dim(metric_mtx, best_perm_t[:, :, None].long(), dim=2).mean(dim=(-1, -2))
    return best_metric, best_perm_t


def permutation_invariant_training(
    preds: Tensor, target: Tensor, metric_func: Callable, eval_func: str = "max", **kwargs: Any
) -> Tuple[Tensor, Tensor]:
    """PIT: the best metric value and the permutation that gives it, per
    sample: ``(B,)`` float and ``(B, S)`` int32.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import permutation_invariant_training, scale_invariant_signal_noise_ratio
        >>> t = torch.arange(16, dtype=torch.float32)
        >>> target = torch.stack([torch.stack([torch.sin(t), torch.cos(t)])] * 2)   # (batch, spk, time)
        >>> preds = torch.stack([target[0], target[1].flip(0)]) + 0.1 * torch.sin(3 * t)
        >>> best, perm = permutation_invariant_training(preds, target, scale_invariant_signal_noise_ratio)
        >>> [round(float(x), 2) for x in best]
        [19.2, 19.2]
        >>> perm.tolist()
        [[0, 1], [1, 0]]
    """
    if preds.shape[0:2] != target.shape[0:2]:
        raise RuntimeError(
            "Predictions and targets are expected to have the same shape at the batch and speaker dimensions"
        )
    if eval_func not in ("max", "min"):
        raise ValueError(f'eval_func can only be "max" or "min" but got {eval_func}')
    if target.ndim < 2:
        raise ValueError(
            f"Inputs must be of shape [batch, spk, ...], got {tuple(target.shape)} and {tuple(preds.shape)} instead"
        )

    metric_mtx = _metric_matrix(preds, target, metric_func, **kwargs)
    spk_num = target.shape[1]
    eval_max = eval_func == "max"
    if spk_num > _HUNGARIAN_CUTOVER and not _capturing():
        return _find_best_perm_hungarian(metric_mtx, eval_max)
    return _find_best_perm_exhaustive(metric_mtx, eval_max)


def pit_permutate(preds: Tensor, perm: Tensor) -> Tensor:
    """Reorder ``preds[b, s]`` as ``preds[b, perm[b, s]]``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import pit_permutate
        >>> preds = torch.arange(12.0).reshape(2, 3, 2)
        >>> pit_permutate(preds, torch.tensor([[2, 0, 1], [0, 1, 2]]))[0].tolist()
        [[4.0, 5.0], [0.0, 1.0], [2.0, 3.0]]
    """
    index = perm.reshape(tuple(perm.shape) + (1,) * (preds.ndim - 2)).long()
    return torch.take_along_dim(preds, index, dim=1)
