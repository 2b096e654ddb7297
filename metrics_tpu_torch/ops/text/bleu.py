"""BLEU score (counterpart of ``metrics_tpu/ops/text/bleu.py``).

N-gram counting runs on the host (strings); the counts reach the device in
one copy per update, and the precision and brevity-penalty math runs there
over the four accumulated float32 count vectors.
"""
from __future__ import annotations

from collections import Counter
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import resolve_device


def _count_ngram(tokens: Sequence[str], n_gram: int) -> Counter:
    counter: Counter = Counter()
    for n in range(1, n_gram + 1):
        for j in range(len(tokens) - n + 1):
            counter[tuple(tokens[j : j + n])] += 1
    return counter


def _tokenize_fn(sentence: str) -> Sequence[str]:
    return sentence.split()


def _bleu_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    numerator: Tensor,
    denominator: Tensor,
    preds_len: Tensor,
    target_len: Tensor,
    n_gram: int = 4,
    tokenizer: Callable[[str], Sequence[str]] = _tokenize_fn,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The states advanced by the clipped and total n-gram counts and the
    corpus lengths of this batch: (numerator, denominator, preds_len, target_len)."""
    num = [0.0] * n_gram
    den = [0.0] * n_gram
    p_len = 0.0
    t_len = 0.0
    for pred, targets in zip(preds, target):
        pred_tokens = tokenizer(pred) if pred else []
        target_tokens = [tokenizer(t) if t else [] for t in targets]
        p_len += len(pred_tokens)
        len_diffs = [abs(len(pred_tokens) - len(t)) for t in target_tokens]
        t_len += len(target_tokens[len_diffs.index(min(len_diffs))])

        preds_counter = _count_ngram(pred_tokens, n_gram)
        target_counter: Counter = Counter()
        for t in target_tokens:
            target_counter |= _count_ngram(t, n_gram)
        clipped = preds_counter & target_counter
        for ngram, cnt in clipped.items():
            num[len(ngram) - 1] += cnt
        for ngram, cnt in preds_counter.items():
            den[len(ngram) - 1] += cnt

    batch = torch.tensor(num + den + [p_len, t_len], dtype=torch.float32).to(numerator.device)
    return (
        numerator + batch[:n_gram],
        denominator + batch[n_gram : 2 * n_gram],
        preds_len + batch[2 * n_gram],
        target_len + batch[2 * n_gram + 1],
    )


def _bleu_score_compute(
    preds_len: Tensor, target_len: Tensor, numerator: Tensor, denominator: Tensor, n_gram: int = 4, smooth: bool = False
) -> Tensor:
    """Geometric mean of the modified n-gram precisions times the brevity
    penalty; 0 when an order has no match (one read to the host)."""
    if float(torch.min(numerator)) == 0.0:
        return torch.zeros((), dtype=torch.float32, device=numerator.device)
    if smooth:
        precision = (numerator + 1.0) / (denominator + 1.0)
        precision = torch.cat([(numerator[0] / denominator[0]).reshape(1), precision[1:]])
    else:
        precision = numerator / denominator
    geometric_mean = torch.exp(torch.sum(torch.log(precision) / n_gram))
    brevity_penalty = torch.where(preds_len > target_len, torch.ones_like(preds_len), torch.exp(1 - target_len / preds_len))
    return brevity_penalty * geometric_mean


def _zero_states(n_gram: int, device: torch.device) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    zeros = torch.zeros(2 * n_gram + 2, dtype=torch.float32, device=device)
    return zeros[:n_gram], zeros[n_gram : 2 * n_gram], zeros[2 * n_gram], zeros[2 * n_gram + 1]


def bleu_score(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    n_gram: int = 4,
    smooth: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """Corpus BLEU with one or more references per sample.

    Example:
        >>> from metrics_tpu_torch.ops import bleu_score
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> round(float(bleu_score(preds, target, device="cpu")), 4)
        0.7598
    """
    preds = [preds] if isinstance(preds, str) else preds
    target = [[tgt] if isinstance(tgt, str) else tgt for tgt in target]
    if len(preds) != len(target):
        raise ValueError(f"Corpus has different size {len(preds)} != {len(target)}")
    numerator, denominator, preds_len, target_len = _bleu_score_update(
        preds, target, *_zero_states(n_gram, resolve_device(device)), n_gram, _tokenize_fn
    )
    return _bleu_score_compute(preds_len, target_len, numerator, denominator, n_gram, smooth)
