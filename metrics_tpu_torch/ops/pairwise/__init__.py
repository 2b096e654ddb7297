"""Pairwise similarity and distance matrices (counterpart of
``metrics_tpu/ops/pairwise/__init__.py``).

Inputs are cast to float32. The product forms go through
:func:`~metrics_tpu_torch.utils.compute.safe_matmul` (``torch.matmul``; TF32
follows ``torch.backends.cuda.matmul.allow_tf32``, which the parity tests and
``chip_smoke.py`` turn off); Manhattan broadcasts ``(N, M, D)`` as the JAX
package does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.compute import safe_matmul


def _check_input(
    x: Tensor, y: Optional[Tensor] = None, zero_diagonal: Optional[bool] = None
) -> Tuple[Tensor, Tensor, bool]:
    """Validate 2D inputs; ``y=None`` pairs ``x`` with itself (diagonal zeroed)."""
    if x.ndim != 2:
        raise ValueError(f"Expected argument `x` to be a 2D tensor of shape `[N, d]` but got {tuple(x.shape)}")
    if y is not None:
        if y.ndim != 2 or y.shape[1] != x.shape[1]:
            raise ValueError(
                "Expected argument `y` to be a 2D tensor of shape `[M, d]` where"
                " `d` should be same as the last dimension of `x`"
            )
        zero_diagonal = False if zero_diagonal is None else zero_diagonal
    else:
        y = x
        zero_diagonal = True if zero_diagonal is None else zero_diagonal
    return x.to(torch.float32), y.to(torch.float32), zero_diagonal


def _reduce_distance_matrix(distmat: Tensor, reduction: Optional[str] = None) -> Tensor:
    if reduction == "mean":
        return torch.mean(distmat, dim=-1)
    if reduction == "sum":
        return torch.sum(distmat, dim=-1)
    if reduction is None or reduction == "none":
        return distmat
    raise ValueError(f"Expected reduction to be one of `['mean', 'sum', None]` but got {reduction}")


def _zero_diag(distmat: Tensor, zero_diagonal: bool) -> Tensor:
    if zero_diagonal:
        # a select, not a product: it also clears NaN diagonals (0/0 cosine rows)
        eye = torch.eye(distmat.shape[0], distmat.shape[1], dtype=torch.bool, device=distmat.device)
        distmat = torch.where(eye, 0.0, distmat)
    return distmat


def pairwise_cosine_similarity(
    x: Tensor, y: Optional[Tensor] = None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """Pairwise cosine similarity matrix.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import pairwise_cosine_similarity
        >>> x = torch.tensor([[2.0, 3.0], [3.0, 5.0], [5.0, 8.0]])
        >>> y = torch.tensor([[1.0, 1.0], [2.0, 1.0]])
        >>> [[round(float(v), 4) for v in row] for row in pairwise_cosine_similarity(x, y)]
        [[0.9806, 0.8682], [0.9701, 0.8437], [0.9744, 0.8533]]
    """
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    norm_x = torch.linalg.vector_norm(x, ord=2, dim=1)
    norm_y = torch.linalg.vector_norm(y, ord=2, dim=1)
    distmat = safe_matmul(x, y.T) / (norm_x[:, None] * norm_y[None, :])
    distmat = _zero_diag(distmat, zero_diagonal)
    return _reduce_distance_matrix(distmat, reduction)


def pairwise_euclidean_distance(
    x: Tensor, y: Optional[Tensor] = None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """Pairwise euclidean distance matrix.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import pairwise_euclidean_distance
        >>> x = torch.tensor([[2.0, 3.0], [3.0, 5.0], [5.0, 8.0]])
        >>> y = torch.tensor([[1.0, 1.0], [2.0, 1.0]])
        >>> [[round(float(v), 4) for v in row] for row in pairwise_euclidean_distance(x, y)]
        [[2.2361, 2.0], [4.4721, 4.1231], [8.0623, 7.6158]]
    """
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    x_norm = torch.sum(x * x, dim=1, keepdim=True)
    y_norm = torch.sum(y * y, dim=1)
    distmat = x_norm + y_norm[None, :] - 2 * safe_matmul(x, y.T)
    distmat = torch.sqrt(torch.clamp(distmat, min=0.0))
    distmat = _zero_diag(distmat, zero_diagonal)
    return _reduce_distance_matrix(distmat, reduction)


def pairwise_linear_similarity(
    x: Tensor, y: Optional[Tensor] = None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """Pairwise dot-product matrix.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import pairwise_linear_similarity
        >>> x = torch.tensor([[2.0, 3.0], [3.0, 5.0], [5.0, 8.0]])
        >>> y = torch.tensor([[1.0, 1.0], [2.0, 1.0]])
        >>> [[round(float(v), 4) for v in row] for row in pairwise_linear_similarity(x, y)]
        [[5.0, 7.0], [8.0, 11.0], [13.0, 18.0]]
    """
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    distmat = safe_matmul(x, y.T)
    distmat = _zero_diag(distmat, zero_diagonal)
    return _reduce_distance_matrix(distmat, reduction)


def pairwise_manhattan_distance(
    x: Tensor, y: Optional[Tensor] = None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """Pairwise L1 distance matrix.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops import pairwise_manhattan_distance
        >>> x = torch.tensor([[2.0, 3.0], [3.0, 5.0], [5.0, 8.0]])
        >>> y = torch.tensor([[1.0, 1.0], [2.0, 1.0]])
        >>> [[round(float(v), 4) for v in row] for row in pairwise_manhattan_distance(x, y)]
        [[3.0, 2.0], [6.0, 5.0], [11.0, 10.0]]
    """
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    distmat = torch.sum(torch.abs(x[:, None, :] - y[None, :, :]), dim=-1)
    distmat = _zero_diag(distmat, zero_diagonal)
    return _reduce_distance_matrix(distmat, reduction)
