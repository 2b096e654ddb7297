"""Extended Edit Distance (Stanchev, Wang & Ney 2019); counterpart of
``metrics_tpu/ops/text/eed.py``.

EED is a character-level CDER-style grid walk with a long-jump operation at
blank positions plus a coverage penalty for repeated visits. Unlike the
Levenshtein-family rates (error_rates.py), the long-jump term makes each DP
cell depend on the whole previous row's minimum at blank columns, so this
implementation keeps the per-sentence host DP loop of the JAX package; each
update's sentence scores reach the device in one copy.
"""
from __future__ import annotations

import re
import unicodedata
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import resolve_device
from metrics_tpu_torch.ops.text.helper import _validate_text_inputs


def _preprocess_en(sentence: str) -> str:
    """English preprocessing per the EED authors' reference pipeline."""
    if not isinstance(sentence, str):
        raise ValueError(f"Only strings allowed during preprocessing step, found {type(sentence)} instead")
    sentence = sentence.rstrip()
    for pattern, replacement in ((".", " ."), ("!", " !"), ("?", " ?"), (",", " ,")):
        sentence = sentence.replace(pattern, replacement)
    for pattern, replacement in (
        (r"\s+", r" "),
        (r"(\d) ([.,]) (\d)", r"\1\2\3"),
        (r"(Dr|Jr|Prof|Rev|Gen|Mr|Mt|Mrs|Ms) .", r"\1."),
    ):
        sentence = re.sub(pattern, replacement, sentence)
    for pattern, replacement in (("e . g .", "e.g."), ("i . e .", "i.e."), ("U . S .", "U.S.")):
        sentence = sentence.replace(pattern, replacement)
    return f" {sentence} "


def _preprocess_ja(sentence: str) -> str:
    if not isinstance(sentence, str):
        raise ValueError(f"Only strings allowed during preprocessing step, found {type(sentence)} instead")
    return unicodedata.normalize("NFKC", sentence.rstrip())


def _eed_function(
    hyp: str,
    ref: str,
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
) -> float:
    """Sentence-level EED in [0, 1], on the host: the grid is one sentence
    pair's characters."""
    import math

    n_visits = [-1] * (len(hyp) + 1)
    row = [1.0] * (len(hyp) + 1)
    row[0] = 0.0
    for w in range(1, len(ref) + 1):
        next_row = [math.inf] * (len(hyp) + 1)
        next_row[0] = row[0] + 1.0
        for i in range(1, len(hyp) + 1):
            next_row[i] = min(
                next_row[i - 1] + deletion,
                row[i - 1] + (0 if hyp[i - 1] == ref[w - 1] else 1),
                row[i] + insertion,
            )
        min_index = next_row.index(min(next_row))
        n_visits[min_index] += 1
        if ref[w - 1] == " ":
            jump = alpha + next_row[min_index]
            next_row = [min(x, jump) for x in next_row]
        row = next_row
    coverage = rho * sum(x if x >= 0 else 1 for x in n_visits)
    return min(1, (row[-1] + coverage) / (float(len(ref)) + coverage))


def _compute_sentence_statistics(
    pred_sentence: str,
    target_sentences: Sequence[str],
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
) -> float:
    """Lowest EED across the references for one hypothesis."""
    return min(_eed_function(pred_sentence, ref, alpha, rho, deletion, insertion) for ref in target_sentences)


def _eed_update(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str = "en",
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
    sentence_eed: Optional[List[Tensor]] = None,
    device: Optional[torch.device] = None,
) -> List[Tensor]:
    """``sentence_eed`` extended by one float32 scalar per sentence, on
    ``device`` (the list's own device when it has entries)."""
    target, preds = _validate_text_inputs(target, preds)
    if language == "en":
        preprocess = _preprocess_en
    elif language == "ja":
        preprocess = _preprocess_ja
    else:
        raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")
    preds = [preprocess(p) for p in preds]
    target = [[preprocess(ref) for ref in refs] for refs in target]

    if sentence_eed is None:
        sentence_eed = []
    if 0 in (len(preds), len(target[0])):
        return sentence_eed
    scores = [_compute_sentence_statistics(pred, refs, alpha, rho, deletion, insertion) for pred, refs in zip(preds, target)]
    batch = torch.from_numpy(np.asarray(scores, dtype=np.float64).astype(np.float32)).to(device)
    sentence_eed.extend(batch.unbind(0))
    return sentence_eed


def _eed_compute(sentence_level_scores: List[Tensor], device: Optional[torch.device] = None) -> Tensor:
    if len(sentence_level_scores) == 0:
        return torch.zeros((), dtype=torch.float32, device=device)
    return torch.mean(torch.stack(sentence_level_scores))


def extended_edit_distance(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str = "en",
    return_sentence_level_score: bool = False,
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
    device: Optional[Union[str, torch.device]] = None,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Corpus EED: the mean sentence EED.

    Example:
        >>> from metrics_tpu_torch.ops import extended_edit_distance
        >>> preds = ['this is the prediction', 'there is an other sample']
        >>> target = ['this is the reference', 'there is another one']
        >>> round(float(extended_edit_distance(preds, target, device="cpu")), 4)
        0.3031
    """
    for name, val in (("alpha", alpha), ("rho", rho), ("deletion", deletion), ("insertion", insertion)):
        if not isinstance(val, float) or val < 0:
            raise ValueError(f"Expected argument `{name}` to be a non-negative float")
    device = resolve_device(device)
    sentence_scores = _eed_update(preds, target, language, alpha, rho, deletion, insertion, device=device)
    score = _eed_compute(sentence_scores, device)
    if return_sentence_level_score:
        return score, torch.stack(sentence_scores) if sentence_scores else torch.zeros(0, device=device)
    return score
