"""ROUGE-N, ROUGE-L and ROUGE-Lsum (Lin 2004, google rouge_scorer semantics);
counterpart of ``metrics_tpu/ops/text/rouge.py``.

Scoring runs on the host; each sentence's precision, recall and F-measure are
float32, as in the JAX package, and an update's scores reach the device in
one copy. ROUGE-Lsum splits sentences with nltk's punkt where its data is
already on the machine (``nltk.data.find``), else with a punctuation regex;
nothing is ever downloaded.
"""
from __future__ import annotations

import re
from collections import Counter
from functools import lru_cache
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import resolve_device
from metrics_tpu_torch.utils.imports import _NLTK_AVAILABLE

ALLOWED_ROUGE_KEYS: Dict[str, Union[int, str]] = {
    "rouge1": 1, "rouge2": 2, "rouge3": 3, "rouge4": 4, "rouge5": 5,
    "rouge6": 6, "rouge7": 7, "rouge8": 8, "rouge9": 9, "rougeL": "L", "rougeLsum": "Lsum",
}
ALLOWED_ACCUMULATE_VALUES = ("avg", "best")
_SCORES = ("precision", "recall", "fmeasure")

Score = Dict[str, np.float32]


@lru_cache(maxsize=1)
def _punkt_available() -> bool:
    """True when nltk and its punkt data are on this machine (a local lookup;
    nothing is downloaded)."""
    if not _NLTK_AVAILABLE:
        return False
    import nltk

    try:
        nltk.data.find("tokenizers/punkt_tab")
    except LookupError:
        return False
    return True


def _split_sentence(x: str) -> Sequence[str]:
    """Sentence split for Lsum: nltk punkt where its data is present, else a
    punctuation regex."""
    x = re.sub("<n>", "", x)  # strip pegasus newline token
    if _punkt_available():
        import nltk

        return nltk.sent_tokenize(x)
    return [s for s in re.split(r"(?<=[.!?])\s+", x.strip()) if s]


def _zero_score() -> Score:
    return dict(precision=np.float32(0.0), recall=np.float32(0.0), fmeasure=np.float32(0.0))


def _compute_metrics(hits_or_lcs: int, pred_len: int, target_len: int) -> Score:
    precision = hits_or_lcs / pred_len
    recall = hits_or_lcs / target_len
    if precision == recall == 0.0:
        return _zero_score()
    fmeasure = 2 * precision * recall / (precision + recall)
    return dict(precision=np.float32(precision), recall=np.float32(recall), fmeasure=np.float32(fmeasure))


def _lcs_table(pred_tokens: Sequence[str], target_tokens: Sequence[str]) -> List[List[int]]:
    lcs = [[0] * (len(pred_tokens) + 1) for _ in range(len(target_tokens) + 1)]
    for i in range(1, len(target_tokens) + 1):
        for j in range(1, len(pred_tokens) + 1):
            if target_tokens[i - 1] == pred_tokens[j - 1]:
                lcs[i][j] = lcs[i - 1][j - 1] + 1
            else:
                lcs[i][j] = max(lcs[i - 1][j], lcs[i][j - 1])
    return lcs


def _lcs(pred_tokens: Sequence[str], target_tokens: Sequence[str]) -> int:
    return _lcs_table(pred_tokens, target_tokens)[-1][-1]


def _backtracked_lcs(lcs_table: List[List[int]], pred_tokens: Sequence[str], target_tokens: Sequence[str]) -> List[int]:
    """Indices (into target) of one longest common subsequence."""
    i, j = len(pred_tokens), len(target_tokens)
    out: List[int] = []
    while i > 0 and j > 0:
        if pred_tokens[i - 1] == target_tokens[j - 1]:
            out.insert(0, j - 1)
            i -= 1
            j -= 1
        elif lcs_table[j][i - 1] > lcs_table[j - 1][i]:
            i -= 1
        else:
            j -= 1
    return out


def _union_lcs(pred_sentences: Sequence[Sequence[str]], target_sentence: Sequence[str]) -> Sequence[str]:
    """Union-LCS of a target sentence against all predicted sentences (Lsum)."""
    indices = set()
    for pred in pred_sentences:
        table = _lcs_table(pred, target_sentence)
        indices.update(_backtracked_lcs(table, pred, target_sentence))
    return [target_sentence[i] for i in sorted(indices)]


def _normalize_and_tokenize_text(
    text: str,
    stemmer: Optional[Any] = None,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
) -> Sequence[str]:
    """Lowercase/alnum normalization with optional Porter stemming (>3 chars)."""
    text = normalizer(text) if callable(normalizer) else re.sub(r"[^a-z0-9]+", " ", text.lower())
    tokens = tokenizer(text) if callable(tokenizer) else re.split(r"\s+", text)
    if stemmer:
        tokens = [stemmer.stem(x) if len(x) > 3 else x for x in tokens]
    return [x for x in tokens if (isinstance(x, str) and len(x) > 0)]


def _rouge_n_score(pred: Sequence[str], target: Sequence[str], n_gram: int) -> Score:
    def _ngrams(tokens: Sequence[str], n: int) -> Counter:
        return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))

    pred_ngrams, target_ngrams = _ngrams(pred, n_gram), _ngrams(target, n_gram)
    pred_len, target_len = sum(pred_ngrams.values()), sum(target_ngrams.values())
    if 0 in (pred_len, target_len):
        return _zero_score()
    hits = sum(min(pred_ngrams[w], target_ngrams[w]) for w in set(pred_ngrams))
    return _compute_metrics(hits, max(pred_len, 1), max(target_len, 1))


def _rouge_l_score(pred: Sequence[str], target: Sequence[str]) -> Score:
    pred_len, target_len = len(pred), len(target)
    if 0 in (pred_len, target_len):
        return _zero_score()
    return _compute_metrics(_lcs(pred, target), pred_len, target_len)


def _rouge_lsum_score(pred: Sequence[Sequence[str]], target: Sequence[Sequence[str]]) -> Score:
    pred_len = sum(map(len, pred))
    target_len = sum(map(len, target))
    if 0 in (pred_len, target_len):
        return _zero_score()

    pred_counts: Counter = Counter()
    target_counts: Counter = Counter()
    for s in pred:
        pred_counts.update(s)
    for s in target:
        target_counts.update(s)

    hits = 0
    for tgt in target:
        for token in _union_lcs(pred, tgt):
            if pred_counts[token] > 0 and target_counts[token] > 0:
                hits += 1
                pred_counts[token] -= 1
                target_counts[token] -= 1
    return _compute_metrics(hits, pred_len, target_len)


def _mean_float32(values: Sequence[np.float32]) -> np.float32:
    """The float32 mean, summed in order then divided, as ``jnp.mean`` does
    over a few values."""
    total = np.float32(0.0)
    for v in values:
        total = np.float32(total + v)
    return np.float32(total / np.float32(len(values)))


def _rouge_score_host(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    rouge_keys_values: List[Union[int, str]],
    accumulate: str,
    stemmer: Optional[Any] = None,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
) -> np.ndarray:
    """Per-sentence float32 (precision, recall, fmeasure) for every key:
    ``(sentences, keys, 3)``, from the best-scoring reference ('best', the
    first reference winning ties) or averaged over references ('avg')."""
    out = np.zeros((len(preds), len(rouge_keys_values), len(_SCORES)), dtype=np.float32)
    for row, (pred_raw, target_raw) in enumerate(zip(preds, target)):
        result_inner: Dict[Union[int, str], Score] = {}
        result_avg: Dict[Union[int, str], List[Score]] = {k: [] for k in rouge_keys_values}
        best_fmeasure = 0.0

        pred = _normalize_and_tokenize_text(pred_raw, stemmer, normalizer, tokenizer)
        if "Lsum" in rouge_keys_values:
            pred_lsum = [
                _normalize_and_tokenize_text(s, stemmer, normalizer, tokenizer) for s in _split_sentence(pred_raw)
            ]

        for tgt_raw in target_raw:
            tgt = _normalize_and_tokenize_text(tgt_raw, stemmer, normalizer, tokenizer)
            if "Lsum" in rouge_keys_values:
                tgt_lsum = [
                    _normalize_and_tokenize_text(s, stemmer, normalizer, tokenizer) for s in _split_sentence(tgt_raw)
                ]

            for key in rouge_keys_values:
                if isinstance(key, int):
                    score = _rouge_n_score(pred, tgt, key)
                elif key == "L":
                    score = _rouge_l_score(pred, tgt)
                else:
                    score = _rouge_lsum_score(pred_lsum, tgt_lsum)
                result_avg[key].append(score)

            if accumulate == "best":
                fmeasure = float(result_avg[rouge_keys_values[0]][-1]["fmeasure"])
                # the first reference wins ties
                if fmeasure > best_fmeasure or not result_inner:
                    best_fmeasure = fmeasure
                    for key in rouge_keys_values:
                        result_inner[key] = result_avg[key][-1]

        for col, key in enumerate(rouge_keys_values):
            if accumulate == "best":
                score = result_inner[key]
            else:
                score = {metric: _mean_float32([s[metric] for s in result_avg[key]]) for metric in _SCORES}
            out[row, col] = [score[metric] for metric in _SCORES]
    return out


def _rouge_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    rouge_keys_values: List[Union[int, str]],
    accumulate: str,
    stemmer: Optional[Any] = None,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
    device: Optional[torch.device] = None,
) -> Dict[str, List[Tensor]]:
    """Each ``rouge{key}_{score}``'s float32 sentence scores, as 0-d tensors
    on ``device`` (one copy for the batch)."""
    host = _rouge_score_host(preds, target, rouge_keys_values, accumulate, stemmer, normalizer, tokenizer)
    batch = torch.from_numpy(host).to(device)
    return {
        f"rouge{key}_{metric}": list(batch[:, col, m].unbind(0))
        for col, key in enumerate(rouge_keys_values)
        for m, metric in enumerate(_SCORES)
    }


def _rouge_score_compute(sentence_results: Dict[str, List[Tensor]], device: Optional[torch.device] = None) -> Dict[str, Tensor]:
    return {
        k: torch.mean(torch.stack(v)) if v else torch.zeros((), dtype=torch.float32, device=device)
        for k, v in sentence_results.items()
    }


def _canonical_corpora(
    preds: Union[str, Sequence[str]], target: Union[str, Sequence[str], Sequence[Sequence[str]]]
) -> Tuple[Sequence[str], Sequence[Sequence[str]]]:
    if isinstance(target, list) and all(isinstance(tgt, str) for tgt in target):
        target = [target] if isinstance(preds, str) else [[tgt] for tgt in target]
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [[target]]
    return preds, target


def _check_rouge_args(use_stemmer: bool, accumulate: str, rouge_keys: Tuple[str, ...]) -> None:
    if use_stemmer and not _NLTK_AVAILABLE:
        raise ModuleNotFoundError("Stemmer requires that `nltk` is installed.")
    if accumulate not in ALLOWED_ACCUMULATE_VALUES:
        raise ValueError(f"Got unknown accumulate value {accumulate}. Expected to be one of {ALLOWED_ACCUMULATE_VALUES}")
    for key in rouge_keys:
        if key not in ALLOWED_ROUGE_KEYS:
            raise ValueError(f"Got unknown rouge key {key}. Expected to be one of {list(ALLOWED_ROUGE_KEYS)}")


def rouge_score(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str], Sequence[Sequence[str]]],
    accumulate: str = "best",
    use_stemmer: bool = False,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
    rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, Tensor]:
    """ROUGE scores: the mean precision, recall and F-measure of each key over
    the sentences.

    Example:
        >>> from metrics_tpu_torch.ops import rouge_score
        >>> scores = rouge_score(['My name is John'], ['Is your name John'], device="cpu")
        >>> round(float(scores['rouge1_fmeasure']), 4)
        0.75
    """
    if not isinstance(rouge_keys, tuple):
        rouge_keys = (rouge_keys,)
    _check_rouge_args(use_stemmer, accumulate, rouge_keys)
    stemmer = None
    if use_stemmer:
        import nltk

        stemmer = nltk.stem.porter.PorterStemmer()
    rouge_keys_values = [ALLOWED_ROUGE_KEYS[k] for k in rouge_keys]
    preds, target = _canonical_corpora(preds, target)
    device = resolve_device(device)
    sentence_results = _rouge_score_update(
        preds, target, rouge_keys_values, accumulate, stemmer, normalizer, tokenizer, device
    )
    # fmeasure, precision, recall: the JAX package's key order
    output = {f"rouge{k}_{metric}": sentence_results[f"rouge{k}_{metric}"]
              for k in rouge_keys_values for metric in ("fmeasure", "precision", "recall")}
    return _rouge_score_compute(output, device)
