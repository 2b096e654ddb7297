"""Pairwise token cosine similarity and greedy max matching for BERTScore.

Counterpart of ``metrics_tpu/ops/kernels/cosine_matching.py``. BERTScore
matches every token of a sentence with its most similar token of the other
sentence: precision averages the row maxima of the (P, R) similarity of
normalised embeddings, recall the column maxima, each weighted by idf.

The maxima (the TPU kernel ``_maxsim_kernel``, ``cosine_matching.py:53``)
are a hand-written CUDA kernel with a plain PyTorch version beside it:

- :func:`maxsim` launches ``csrc/maxsim_tc.cu`` (``maxsim_tf32x3``: 3xTF32
  products on the tensor cores, fed by TMA), which never writes the
  (B, L, P, R) similarity to device memory. Operands that TMA cannot describe
  (:func:`_tma_route`: D not a multiple of 4, or a base not 16-byte aligned)
  are first copied with D padded by zero columns (:func:`_tma_operands`);
- :func:`maxsim_plain` is the full ``einsum`` followed by two ``amax``.

For CUDA tensors :func:`maxsim` launches its kernel or raises; it never falls
back. Only for CPU tensors, or with ``plain=True`` (a check hook), does it run
the plain version. The two sum each similarity in different orders, so they
agree within float32 rounding and not to the bit. The idf weighting and F1
(:func:`_finalize`) are plain PyTorch on both routes.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.ops.kernels import KERNELS, check_kernel_inputs, count_launch, current_stream

__all__ = ["maxsim", "maxsim_plain", "pairwise_cosine_pr"]

MAXSIM_KERNEL = KERNELS["maxsim_tf32x3"]


def _tma_route(preds_embeddings: Tensor, target_embeddings: Tensor) -> bool:
    """Whether TMA can describe both operands as they are: D a positive
    multiple of 4 (16-byte row strides) and both bases 16-byte aligned. The
    operands are contiguous."""
    d = preds_embeddings.shape[-1]
    return (
        d > 0 and d % 4 == 0
        and preds_embeddings.data_ptr() % 16 == 0 and target_embeddings.data_ptr() % 16 == 0
    )


def _tma_operands(preds_embeddings: Tensor, target_embeddings: Tensor) -> Tuple[Tensor, Tensor]:
    """Copies of both operands that TMA can describe: D padded with zero
    columns up to a positive multiple of 4, in fresh allocations (PyTorch's
    allocators align them to far more than 16 bytes). A zero column adds an
    exact zero to every dot product, so the maxima do not change."""
    d = preds_embeddings.shape[-1]
    width = max(4, -(-d // 4) * 4)
    out = []
    for x in (preds_embeddings, target_embeddings):
        padded = x.new_zeros((*x.shape[:-1], width))
        padded[..., :d] = x
        out.append(padded)
    return out[0], out[1]


def _finalize(rowmax: Tensor, colmax: Tensor, preds_idf_scale: Tensor,
              target_idf_scale: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """idf-weighted sums of the maxima and F1, NaN F1 set to 0; (L, B) squeezed."""
    precision = (rowmax * preds_idf_scale[:, None, :]).sum(-1)
    recall = (colmax * target_idf_scale[:, None, :]).sum(-1)
    f1 = 2 * precision * recall / (precision + recall)
    f1 = torch.where(torch.isnan(f1), torch.zeros((), dtype=f1.dtype, device=f1.device), f1)
    return precision.T.squeeze(), recall.T.squeeze(), f1.T.squeeze()


def maxsim_plain(preds_embeddings: Tensor, target_embeddings: Tensor) -> Tuple[Tensor, Tensor]:
    """The plain version: the full similarity, then its row and column maxima."""
    cos_sim = torch.einsum("blpd,blrd->blpr", preds_embeddings, target_embeddings)
    return cos_sim.amax(dim=3), cos_sim.amax(dim=2)


def _pr_f1_reference(preds_embeddings: Tensor, target_embeddings: Tensor,
                     preds_idf_scale: Tensor, target_idf_scale: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Precision, recall and F1 through the plain version, on any device."""
    return _finalize(*maxsim_plain(preds_embeddings, target_embeddings), preds_idf_scale, target_idf_scale)


def maxsim(preds_embeddings: Tensor, target_embeddings: Tensor, *, plain: bool = False) -> Tuple[Tensor, Tensor]:
    """Row and column maxima of the token similarity of each (batch, layer):
    (B, L, P, D) x (B, L, R, D) -> (B, L, P), (B, L, R), float32.

    Both inputs are contiguous float32 on one device, with P and R at least 1.
    CPU tensors take the plain version; CUDA tensors launch the kernel on the
    current stream or raise, after a padded copy where :func:`_tma_route`
    does not hold. ``plain=True`` runs the plain version on any device, so
    that a check can hold the kernel against it.
    """
    if (
        preds_embeddings.ndim != 4 or target_embeddings.ndim != 4
        or preds_embeddings.shape[:2] != target_embeddings.shape[:2]
        or preds_embeddings.shape[3] != target_embeddings.shape[3]
    ):
        raise ValueError(
            "maxsim takes (B, L, P, D) and (B, L, R, D) embeddings, got "
            f"{tuple(preds_embeddings.shape)} and {tuple(target_embeddings.shape)}"
        )
    b, l, p, d = preds_embeddings.shape
    r = target_embeddings.shape[2]
    if p == 0 or r == 0:
        raise ValueError(f"maxsim needs at least one token on each side, got P={p}, R={r}")
    check_kernel_inputs(
        "maxsim", preds_embeddings.device,
        preds_embeddings=(preds_embeddings, torch.float32), target_embeddings=(target_embeddings, torch.float32),
    )
    if plain or preds_embeddings.device.type == "cpu":
        return maxsim_plain(preds_embeddings, target_embeddings)
    if preds_embeddings.device.type != "cuda":
        raise ValueError(f"maxsim runs on CPU or CUDA tensors, got {preds_embeddings.device}")
    device = preds_embeddings.device
    rowmax = torch.empty((b, l, p), dtype=torch.float32, device=device)  # the kernel writes every element
    colmax = torch.empty((b, l, r), dtype=torch.float32, device=device)
    pairs = b * l
    if pairs == 0:  # an empty grid is not a valid launch
        return rowmax, colmax
    if not _tma_route(preds_embeddings, target_embeddings):
        preds_embeddings, target_embeddings = _tma_operands(preds_embeddings, target_embeddings)
        d = preds_embeddings.shape[3]
    keys = torch.empty((pairs * r,), dtype=torch.int32, device=device)  # column keys, zeroed by the launch
    with torch.cuda.device(device):
        err = MAXSIM_KERNEL.lib().maxsim_tc_launch(
            preds_embeddings.data_ptr(), target_embeddings.data_ptr(), keys.data_ptr(),
            rowmax.data_ptr(), colmax.data_ptr(), pairs, p, r, d, current_stream(preds_embeddings),
        )
    if err != 0:
        raise RuntimeError(f"{MAXSIM_KERNEL.name} kernel launch failed with CUDA error {err}")
    count_launch(MAXSIM_KERNEL)
    return rowmax, colmax


def pairwise_cosine_pr(
    preds_embeddings: Tensor,  # (B, L, P, D) normalised token embeddings
    target_embeddings: Tensor,  # (B, L, R, D)
    preds_idf_scale: Tensor,  # (B, P)
    target_idf_scale: Tensor,  # (B, R)
) -> Tuple[Tensor, Tensor, Tensor]:
    """BERTScore greedy-matching precision, recall and F1 per sentence (and
    layer), shaped (L, B) and squeezed, through :func:`maxsim`."""
    rowmax, colmax = maxsim(preds_embeddings, target_embeddings)
    return _finalize(rowmax, colmax, preds_idf_scale, target_idf_scale)
