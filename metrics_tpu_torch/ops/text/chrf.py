"""chrF / chrF++ score (counterpart of ``metrics_tpu/ops/text/chrf.py``).

The state is three flat float32 vectors of per-order counts (matching,
hypothesis, reference; char orders then word orders), so the metric syncs
with one bucketed sum and the F-beta reduction is a few device operations.
N-gram counting and the choice of the best reference run on the host in
numpy; each update's totals reach the device in one copy. The counts are
integers, so the float32 sums are exact while below 2**24.

This is the eps-smoothing variant of chrF, as in the JAX package
(sacrebleu's ``CHRF(eps_smoothing=True)``).
"""
from __future__ import annotations

import string
from collections import Counter
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import resolve_device
from metrics_tpu_torch.ops.text.helper import _validate_text_inputs

_EPS_SMOOTHING = 1e-16
_PUNCTUATIONS = set(string.punctuation)


def _get_characters(sentence: str, whitespace: bool) -> List[str]:
    if whitespace:
        return list(sentence)
    return list(sentence.strip().replace(" ", ""))


def _separate_word_and_punctuation(word: str) -> List[str]:
    if len(word) == 1:
        return [word]
    if word[-1] in _PUNCTUATIONS:
        return [word[:-1], word[-1]]
    if word[0] in _PUNCTUATIONS:
        return [word[0], word[1:]]
    return [word]


def _get_words_and_punctuation(sentence: str) -> List[str]:
    return sum((_separate_word_and_punctuation(w) for w in sentence.strip().split()), [])


def _ngram_counts(items: Sequence[str], order: int) -> List[Counter]:
    """Counter of n-grams for each n in 1..order."""
    out = []
    for n in range(1, order + 1):
        out.append(Counter(tuple(items[i : i + n]) for i in range(len(items) - n + 1)))
    return out


def _sentence_counts(
    sentence: str, n_char_order: int, n_word_order: int, lowercase: bool, whitespace: bool
) -> Tuple[List[Counter], List[Counter]]:
    if lowercase:
        sentence = sentence.lower()
    char_ngrams = _ngram_counts(_get_characters(sentence, whitespace), n_char_order)
    word_ngrams = _ngram_counts(_get_words_and_punctuation(sentence), n_word_order)
    return char_ngrams, word_ngrams


def _matching(pred: List[Counter], tgt: List[Counter]) -> List[int]:
    return [sum((p & t).values()) for p, t in zip(pred, tgt)]


def _totals(counters: List[Counter]) -> List[int]:
    return [sum(c.values()) for c in counters]


def _fscore_from_counts(matching: Tensor, hyp_total: Tensor, ref_total: Tensor, beta: float) -> Tensor:
    """Per-order F-beta; an order with a zero total contributes 0."""
    zero = torch.zeros((), dtype=matching.dtype, device=matching.device)
    precision = torch.where(hyp_total > 0, matching / torch.clamp(hyp_total, min=1), zero)
    recall = torch.where(ref_total > 0, matching / torch.clamp(ref_total, min=1), zero)
    denom = torch.clamp(beta**2 * precision + recall, min=_EPS_SMOOTHING)
    return (1 + beta**2) * precision * recall / denom


def _np_fscore(matching: np.ndarray, hyp_total: np.ndarray, ref_total: np.ndarray, beta: float) -> np.ndarray:
    """Host twin of :func:`_fscore_from_counts` for the update loop."""
    precision = np.where(hyp_total > 0, matching / np.maximum(hyp_total, 1), 0.0)
    recall = np.where(ref_total > 0, matching / np.maximum(ref_total, 1), 0.0)
    denom = np.maximum(beta**2 * precision + recall, _EPS_SMOOTHING)
    return (1 + beta**2) * precision * recall / denom


def _chrf_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    matching_counts: Tensor,
    hyp_counts: Tensor,
    ref_counts: Tensor,
    n_char_order: int = 6,
    n_word_order: int = 2,
    beta: float = 2.0,
    lowercase: bool = False,
    whitespace: bool = False,
    sentence_scores: Optional[List[Tensor]] = None,
) -> Tuple[Tensor, Tensor, Tensor, Optional[List[Tensor]]]:
    """The count vectors advanced by this batch (length ``n_char_order +
    n_word_order``); with several references the one with the best sentence
    chrF counts. ``sentence_scores`` gets one float32 scalar per sentence."""
    target, preds = _validate_text_inputs(target, preds)
    n = n_char_order + n_word_order
    n_order = float(n)
    match_acc = np.zeros(n, dtype=np.float64)
    hyp_acc = np.zeros(n, dtype=np.float64)
    ref_acc = np.zeros(n, dtype=np.float64)
    best_scores: List[float] = []

    for pred, refs in zip(preds, target):
        p_char, p_word = _sentence_counts(pred, n_char_order, n_word_order, lowercase, whitespace)
        hyp_vec = np.asarray(_totals(p_char) + _totals(p_word), dtype=np.float64)

        best_f = None
        best = None
        for ref in refs:
            r_char, r_word = _sentence_counts(ref, n_char_order, n_word_order, lowercase, whitespace)
            match_vec = np.asarray(_matching(p_char, r_char) + _matching(p_word, r_word), dtype=np.float64)
            ref_vec = np.asarray(_totals(r_char) + _totals(r_word), dtype=np.float64)
            f = float(np.sum(_np_fscore(match_vec, hyp_vec, ref_vec, beta)) / n_order)
            if best_f is None or f > best_f:
                best_f, best = f, (match_vec, ref_vec)

        assert best is not None
        match_acc += best[0]
        hyp_acc += hyp_vec
        ref_acc += best[1]
        best_scores.append(best_f)

    host = np.concatenate([match_acc, hyp_acc, ref_acc])
    if sentence_scores is not None:
        host = np.concatenate([host, np.asarray(best_scores, dtype=np.float64)])
    batch = torch.from_numpy(host.astype(np.float32)).to(matching_counts.device)  # one copy
    if sentence_scores is not None:
        sentence_scores.extend(batch[3 * n :].unbind(0))
    return matching_counts + batch[:n], hyp_counts + batch[n : 2 * n], ref_counts + batch[2 * n : 3 * n], sentence_scores


def _chrf_score_compute(matching_counts: Tensor, hyp_counts: Tensor, ref_counts: Tensor, n_order: float, beta: float) -> Tensor:
    return torch.sum(_fscore_from_counts(matching_counts, hyp_counts, ref_counts, beta)) / n_order


def chrf_score(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    n_char_order: int = 6,
    n_word_order: int = 2,
    beta: float = 2.0,
    lowercase: bool = False,
    whitespace: bool = False,
    return_sentence_level_score: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Corpus chrF (``n_word_order=0``) or chrF++ (``n_word_order=2``).

    Example:
        >>> from metrics_tpu_torch.ops import chrf_score
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat']]
        >>> round(float(chrf_score(preds, target, device="cpu")), 4)
        0.4942
    """
    if not isinstance(n_char_order, int) or n_char_order < 1:
        raise ValueError("Expected argument `n_char_order` to be an integer greater than or equal to 1.")
    if not isinstance(n_word_order, int) or n_word_order < 0:
        raise ValueError("Expected argument `n_word_order` to be an integer greater than or equal to 0.")
    if beta < 0:
        raise ValueError("Expected argument `beta` to be greater than 0.")
    n = n_char_order + n_word_order
    zeros = torch.zeros(n, dtype=torch.float32, device=resolve_device(device))
    sentence_scores: Optional[List[Tensor]] = [] if return_sentence_level_score else None
    matching, hyp, ref, sentence_scores = _chrf_score_update(
        preds, target, zeros, zeros, zeros, n_char_order, n_word_order, beta, lowercase, whitespace, sentence_scores
    )
    score = _chrf_score_compute(matching, hyp, ref, float(n), beta)
    if return_sentence_level_score:
        return score, torch.stack(sentence_scores) if sentence_scores else torch.zeros(0, device=zeros.device)
    return score
