"""SQuAD exact match and F1 (Rajpurkar et al. 2016, the official evaluation's
semantics); counterpart of ``metrics_tpu/ops/text/squad.py``.

Scoring runs on the host; the summed F1 and exact match (float32) and the
question count (int32) reach the device once per update.
"""
from __future__ import annotations

import re
import string
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import resolve_device
from metrics_tpu_torch.utils.prints import rank_zero_warn

PREDS_TYPE = Union[Dict[str, Any], List[Dict[str, Any]]]
TARGETS_TYPE = Union[Dict[str, Any], List[Dict[str, Any]]]

SQuAD_FORMAT = {
    "answers": {"answer_start": [1], "text": ["This is a test text"]},
    "context": "This is a test context.",
    "id": "1",
    "question": "Is this a test?",
    "title": "train test",
}


def _normalize_text(s: str) -> str:
    """Lowercase, strip punctuation/articles/extra whitespace."""
    s = re.sub(r"\b(a|an|the)\b", " ", "".join(ch for ch in s.lower() if ch not in set(string.punctuation)))
    return " ".join(s.split())


def _get_tokens(s: str) -> List[str]:
    return _normalize_text(s).split() if s else []


def _compute_f1_score(predicted_answer: str, target_answer: str) -> float:
    target_tokens = _get_tokens(target_answer)
    predicted_tokens = _get_tokens(predicted_answer)
    common = Counter(target_tokens) & Counter(predicted_tokens)
    num_same = sum(common.values())
    if len(target_tokens) == 0 or len(predicted_tokens) == 0:
        return float(target_tokens == predicted_tokens)
    if num_same == 0:
        return 0.0
    precision = num_same / len(predicted_tokens)
    recall = num_same / len(target_tokens)
    return 2 * precision * recall / (precision + recall)


def _compute_exact_match_score(prediction: str, ground_truth: str) -> float:
    return float(_normalize_text(prediction) == _normalize_text(ground_truth))


def _metric_max_over_ground_truths(metric_fn: Callable[[str, str], float], prediction: str, ground_truths: List[str]) -> float:
    return max(metric_fn(prediction, truth) for truth in ground_truths)


def _squad_input_check(preds: PREDS_TYPE, targets: TARGETS_TYPE) -> Tuple[Dict[str, str], List[Dict[str, Any]]]:
    """Validate and convert inputs to the article/paragraph/qas format."""
    if isinstance(preds, dict):
        preds = [preds]
    if isinstance(targets, dict):
        targets = [targets]
    for pred in preds:
        if "prediction_text" not in pred or "id" not in pred:
            raise KeyError(
                "Expected keys in a single prediction are 'prediction_text' and 'id'."
                "Please make sure that 'prediction_text' maps to the answer string and 'id' maps to the key string."
            )
    for target in targets:
        if "answers" not in target or "id" not in target:
            raise KeyError(
                "Expected keys in a single target are 'answers' and 'id'."
                "Please make sure that 'answers' maps to a `SQuAD` format dictionary and 'id' maps to the key string.\n"
                f"SQuAD Format: {SQuAD_FORMAT}"
            )
        if "text" not in target["answers"]:
            raise KeyError(
                "Expected the 'answers' dict to contain a 'text' key. "
                "Please make sure that 'answer' maps to a `SQuAD` format dictionary.\n"
                f"SQuAD Format: {SQuAD_FORMAT}"
            )
    preds_dict = {p["id"]: p["prediction_text"] for p in preds}
    targets_dict = [
        {"paragraphs": [{"qas": [{"answers": [{"text": t} for t in tgt["answers"]["text"]], "id": tgt["id"]} for tgt in targets]}]}
    ]
    return preds_dict, targets_dict


def _squad_update(
    preds: Dict[str, str], target: List[Dict[str, Any]], device: Optional[torch.device] = None
) -> Tuple[Tensor, Tensor, Tensor]:
    """Summed F1 and exact match (float32) and the question count (int32)."""
    f1 = 0.0
    exact_match = 0.0
    total = 0
    for article in target:
        for paragraph in article["paragraphs"]:
            for qa in paragraph["qas"]:
                total += 1
                if qa["id"] not in preds:
                    rank_zero_warn(f"Unanswered question {qa['id']} will receive score 0.")
                    continue
                ground_truths = [x["text"] for x in qa["answers"]]
                pred = preds[qa["id"]]
                exact_match += _metric_max_over_ground_truths(_compute_exact_match_score, pred, ground_truths)
                f1 += _metric_max_over_ground_truths(_compute_f1_score, pred, ground_truths)
    scores = torch.tensor([f1, exact_match], dtype=torch.float32).to(device)
    return scores[0], scores[1], torch.tensor(total, dtype=torch.int32).to(device)


def _squad_compute(f1: Tensor, exact_match: Tensor, total: Tensor) -> Dict[str, Tensor]:
    return {"exact_match": 100.0 * exact_match / total, "f1": 100.0 * f1 / total}


def squad(preds: PREDS_TYPE, target: TARGETS_TYPE, device: Optional[Union[str, torch.device]] = None) -> Dict[str, Tensor]:
    """SQuAD exact match and F1 over prediction and target dicts.

    Example:
        >>> from metrics_tpu_torch.ops import squad
        >>> preds = [{"prediction_text": "1976", "id": "56e10a3be3433e1400422b22"}]
        >>> target = [{"answers": {"answer_start": [97], "text": ["1976"]}, "id": "56e10a3be3433e1400422b22"}]
        >>> {k: round(float(v), 1) for k, v in squad(preds, target, device="cpu").items()}
        {'exact_match': 100.0, 'f1': 100.0}
    """
    preds_dict, target_dict = _squad_input_check(preds, target)
    f1, exact_match, total = _squad_update(preds_dict, target_dict, resolve_device(device))
    return _squad_compute(f1, exact_match, total)
