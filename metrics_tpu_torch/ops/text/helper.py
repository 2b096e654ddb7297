"""Shared text helpers: input validation, tokens to ids, batched edit distance.

Counterpart of ``metrics_tpu/ops/text/helper.py``. Sentences are encoded to
padded int32 id arrays on the host (one vocabulary per batch, in first-seen
order; predictions padded with -1 and references with -2, so padding never
matches; widths rounded up to multiples of 16), and the whole batch of
Levenshtein recurrences runs on the tensors' device.

The row recurrence ``row[j] = min(prev[j] + 1, prev[j-1] + cost_j, row[j-1] + 1)``
depends on ``row[j-1]``; because an insertion always costs 1 it factors into
a min-plus prefix scan. With ``c_0 = i`` and
``c_j = min(prev[j] + 1, prev[j-1] + cost_j)``,

    row[j] = min_{k<=j} (c_k + (j - k)) = j + cummin(c_k - k).

The JAX package scans ``row`` itself; here the scan runs on ``u = row - j``,
where the recurrence reads ``u[j] = cummin(i, min(u_prev[j] + 1,
u_prev[j-1] + cost_j - 1))``, so each prediction token is three elementwise
operations and one ``torch.cummin`` over a ``(B, R+1)`` int32 row, written
into a preallocated ``(P+1, B, R+1)`` history; one gather at the end reads
``u[pred_len, b, ref_len] + ref_len``. Integer arithmetic throughout, so the
result is exact and equal to the JAX scan's. On a CPU tensor the same code
is the plain version; on a CUDA tensor it runs on the card, and a failure
there raises.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

_PAD = -1


def _validate_text_inputs(
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    preds: Union[str, Sequence[str]],
) -> Tuple[Sequence[Sequence[str]], Sequence[str]]:
    """Canonicalize (target, preds) corpora to (Sequence[Sequence[str]], Sequence[str])."""
    if isinstance(preds, str):
        preds = [preds]
    if all(isinstance(ref, str) for ref in target):
        target = [target] if len(preds) == 1 else [[ref] for ref in target]  # type: ignore[list-item]
    if preds and all(ref for ref in target) and len(target) != len(preds):
        raise ValueError(f"Corpus has different size {len(target)} != {len(preds)}")
    return target, preds  # type: ignore[return-value]


def _edit_distance_host(prediction_tokens: List[str], reference_tokens: List[str]) -> int:
    """Plain host Levenshtein DP: the oracle of the batched scan."""
    dp = list(range(len(reference_tokens) + 1))
    for i in range(1, len(prediction_tokens) + 1):
        prev_diag, dp[0] = dp[0], i
        for j in range(1, len(reference_tokens) + 1):
            cost = 0 if prediction_tokens[i - 1] == reference_tokens[j - 1] else 1
            prev_diag, dp[j] = dp[j], min(dp[j] + 1, dp[j - 1] + 1, prev_diag + cost)
    return dp[-1]


def edit_distance_batch(pred_ids: Tensor, pred_lens: Tensor, ref_ids: Tensor, ref_lens: Tensor) -> Tensor:
    """Batched Levenshtein distances of padded token-id arrays.

    Args:
        pred_ids: (B, P) int32, any value beyond ``pred_lens``.
        pred_lens: (B,) prediction lengths.
        ref_ids: (B, R) int32, padded with values that match no prediction id.
        ref_lens: (B,) reference lengths.

    Returns:
        (B,) int32 distances ``dp[pred_len, ref_len]``, on the inputs' device.
        The work is ``4 P + 12`` device operations, independent of ``B``.
    """
    b, p = pred_ids.shape
    r = ref_ids.shape[1]
    device = pred_ids.device
    # cost - 1 of every (token, batch, reference position): -1 on a match, 0 off it
    cost_m1 = (pred_ids.T[:, :, None] != ref_ids[None, :, :]).to(torch.int32) - 1  # (P, B, R)
    u = torch.empty((p + 1, b, r + 1), dtype=torch.int32, device=device)
    c = torch.empty_like(u)
    u[0] = 0  # row 0 is j, so u is 0
    c[:, :, 0] = torch.arange(p + 1, dtype=torch.int32, device=device)[:, None]  # c_0 = i
    scan_index = torch.empty((b, r + 1), dtype=torch.int64, device=device)
    for i in range(1, p + 1):
        prev = u[i - 1]
        torch.minimum(prev[:, 1:] + 1, prev[:, :-1] + cost_m1[i - 1], out=c[i, :, 1:])
        torch.cummin(c[i], dim=1, out=(u[i], scan_index))
    pred_lens = pred_lens.to(device=device, dtype=torch.int64)
    ref_lens = ref_lens.to(device=device, dtype=torch.int64)
    return u[pred_lens, torch.arange(b, device=device), ref_lens] + ref_lens.to(torch.int32)


def _round_up(n: int, multiple: int = 16) -> int:
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def encode_token_batch(
    preds_tokens: Sequence[Sequence[str]], target_tokens: Sequence[Sequence[str]], device: Optional[torch.device] = None
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Host: tokens to dense int32 ids, padded to widths rounded up to
    multiples of 16 (predictions with -1, references with -2); the four
    arrays reach ``device`` in one copy."""
    vocab: Dict[str, int] = {}

    def ids(tokens: Sequence[str]) -> List[int]:
        return [vocab.setdefault(t, len(vocab)) for t in tokens]

    pred_id_lists = [ids(t) for t in preds_tokens]
    ref_id_lists = [ids(t) for t in target_tokens]
    n_pred, n_ref = len(pred_id_lists), len(ref_id_lists)
    p_width = _round_up(max((len(t) for t in pred_id_lists), default=0))
    r_width = _round_up(max((len(t) for t in ref_id_lists), default=0))
    packed = np.empty(n_pred * p_width + n_ref * r_width + n_pred + n_ref, dtype=np.int32)
    pred_arr = packed[: n_pred * p_width].reshape(n_pred, p_width)
    ref_arr = packed[n_pred * p_width : n_pred * p_width + n_ref * r_width].reshape(n_ref, r_width)
    pred_arr.fill(_PAD)
    ref_arr.fill(_PAD - 1)
    for i, t in enumerate(pred_id_lists):
        pred_arr[i, : len(t)] = t
    for i, t in enumerate(ref_id_lists):
        ref_arr[i, : len(t)] = t
    lens_at = n_pred * p_width + n_ref * r_width
    packed[lens_at : lens_at + n_pred] = [len(t) for t in pred_id_lists]
    packed[lens_at + n_pred :] = [len(t) for t in ref_id_lists]
    flat = torch.from_numpy(packed).to(device)
    pred_ids = flat[: n_pred * p_width].view(n_pred, p_width)
    ref_ids = flat[n_pred * p_width : lens_at].view(n_ref, r_width)
    return pred_ids, flat[lens_at : lens_at + n_pred], ref_ids, flat[lens_at + n_pred :]


def batch_edit_distances(
    preds_tokens: Sequence[Sequence[str]], target_tokens: Sequence[Sequence[str]], device: Optional[torch.device] = None
) -> Tensor:
    """Edit distance of each (prediction, target) token-list pair, on ``device``."""
    if not preds_tokens:
        return torch.zeros((0,), dtype=torch.int32, device=device)
    return edit_distance_batch(*encode_token_batch(preds_tokens, target_tokens, device))
