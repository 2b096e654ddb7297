"""Edit-distance error rates: WER, CER, MER, WIL, WIP (counterpart of
``metrics_tpu/ops/text/error_rates.py``).

All five share the batched Levenshtein scan of
:func:`metrics_tpu_torch.ops.text.helper.batch_edit_distances`, on the
device the caller names (``device=None`` is the current CUDA device). The
states are float32 sums of integer distances and lengths: exact while they
stay below 2**24.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import resolve_device
from metrics_tpu_torch.ops.text.helper import batch_edit_distances

_Corpus = Union[str, List[str]]
_Device = Optional[Union[str, torch.device]]


def _as_list(x: _Corpus) -> List[str]:
    return [x] if isinstance(x, str) else list(x)


def _check_corpus_sizes(preds: List[str], target: List[str]) -> None:
    if len(preds) != len(target):
        raise ValueError(f"Corpus has different size {len(preds)} != {len(target)}")


def _edit_errors(pred_tokens: Sequence[Sequence[str]], tgt_tokens: Sequence[Sequence[str]], device: torch.device) -> Tensor:
    """The corpus's summed edit distance, as a float32 scalar on ``device``."""
    return batch_edit_distances(pred_tokens, tgt_tokens, device).sum(dtype=torch.int32).to(torch.float32)


def _totals(values: Sequence[float], device: torch.device) -> Tuple[Tensor, ...]:
    """Host totals as float32 scalars on ``device``, in one copy."""
    return tuple(torch.tensor([float(v) for v in values], dtype=torch.float32).to(device).unbind(0))


def _word_stats(preds: _Corpus, target: _Corpus, device: torch.device) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The corpus's (edit errors, target words, predicted words, summed max lengths)."""
    preds, target = _as_list(preds), _as_list(target)
    _check_corpus_sizes(preds, target)
    pred_tokens = [p.split() for p in preds]
    tgt_tokens = [t.split() for t in target]
    errors = _edit_errors(pred_tokens, tgt_tokens, device)
    tgt_total, pred_total, max_total = _totals((
        sum(len(t) for t in tgt_tokens),
        sum(len(p) for p in pred_tokens),
        sum(max(len(p), len(t)) for p, t in zip(pred_tokens, tgt_tokens)),
    ), device)
    return errors, tgt_total, pred_total, max_total


def _wer_update(preds: _Corpus, target: _Corpus, device: torch.device) -> Tuple[Tensor, Tensor]:
    errors, tgt_total, _, _ = _word_stats(preds, target, device)
    return errors, tgt_total


def _wer_compute(errors: Tensor, total: Tensor) -> Tensor:
    return errors / total


def word_error_rate(preds: _Corpus, target: _Corpus, device: _Device = None) -> Tensor:
    """WER: word edit distance over reference words.

    Example:
        >>> from metrics_tpu_torch.ops import word_error_rate
        >>> preds = ['this is the prediction', 'there is an other sample']
        >>> target = ['this is the reference', 'there is another one']
        >>> round(float(word_error_rate(preds, target, device="cpu")), 4)
        0.5
    """
    return _wer_compute(*_wer_update(preds, target, resolve_device(device)))


def _cer_update(preds: _Corpus, target: _Corpus, device: torch.device) -> Tuple[Tensor, Tensor]:
    preds, target = _as_list(preds), _as_list(target)
    _check_corpus_sizes(preds, target)
    pred_chars = [list(p) for p in preds]
    tgt_chars = [list(t) for t in target]
    errors = _edit_errors(pred_chars, tgt_chars, device)
    (total,) = _totals((sum(len(t) for t in tgt_chars),), device)
    return errors, total


def _cer_compute(errors: Tensor, total: Tensor) -> Tensor:
    return errors / total


def char_error_rate(preds: _Corpus, target: _Corpus, device: _Device = None) -> Tensor:
    """CER: character edit distance over reference characters.

    Example:
        >>> from metrics_tpu_torch.ops import char_error_rate
        >>> preds = ['this is the prediction', 'there is an other sample']
        >>> target = ['this is the reference', 'there is another one']
        >>> round(float(char_error_rate(preds, target, device="cpu")), 4)
        0.3415
    """
    return _cer_compute(*_cer_update(preds, target, resolve_device(device)))


def _mer_update(preds: _Corpus, target: _Corpus, device: torch.device) -> Tuple[Tensor, Tensor]:
    errors, _, _, max_total = _word_stats(preds, target, device)
    return errors, max_total


def _mer_compute(errors: Tensor, total: Tensor) -> Tensor:
    return errors / total


def match_error_rate(preds: _Corpus, target: _Corpus, device: _Device = None) -> Tensor:
    """MER: edits over the larger of reference and prediction words.

    Example:
        >>> from metrics_tpu_torch.ops import match_error_rate
        >>> preds = ['this is the prediction', 'there is an other sample']
        >>> target = ['this is the reference', 'there is another one']
        >>> round(float(match_error_rate(preds, target, device="cpu")), 4)
        0.4444
    """
    return _mer_compute(*_mer_update(preds, target, resolve_device(device)))


def _wil_update(preds: _Corpus, target: _Corpus, device: torch.device) -> Tuple[Tensor, Tensor, Tensor]:
    errors, tgt_total, pred_total, max_total = _word_stats(preds, target, device)
    return errors - max_total, tgt_total, pred_total


def _wil_compute(errors: Tensor, target_total: Tensor, preds_total: Tensor) -> Tensor:
    return 1 - ((errors / target_total) * (errors / preds_total))


def word_information_lost(preds: _Corpus, target: _Corpus, device: _Device = None) -> Tensor:
    """WIL = 1 - (H / N_ref)(H / N_hyp), H the summed max lengths less the edits.

    Example:
        >>> from metrics_tpu_torch.ops import word_information_lost
        >>> preds = ['this is the prediction', 'there is an other sample']
        >>> target = ['this is the reference', 'there is another one']
        >>> round(float(word_information_lost(preds, target, device="cpu")), 4)
        0.6528
    """
    return _wil_compute(*_wil_update(preds, target, resolve_device(device)))


def _wip_update(preds: _Corpus, target: _Corpus, device: torch.device) -> Tuple[Tensor, Tensor, Tensor]:
    errors, tgt_total, pred_total, max_total = _word_stats(preds, target, device)
    return errors - max_total, tgt_total, pred_total


def _wip_compute(errors: Tensor, target_total: Tensor, preds_total: Tensor) -> Tensor:
    return (errors / target_total) * (errors / preds_total)


def word_information_preserved(preds: _Corpus, target: _Corpus, device: _Device = None) -> Tensor:
    """WIP = (H / N_ref)(H / N_hyp).

    Example:
        >>> from metrics_tpu_torch.ops import word_information_preserved
        >>> preds = ['this is the prediction', 'there is an other sample']
        >>> target = ['this is the reference', 'there is another one']
        >>> round(float(word_information_preserved(preds, target, device="cpu")), 4)
        0.3472
    """
    return _wip_compute(*_wip_update(preds, target, resolve_device(device)))
