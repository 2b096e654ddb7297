"""Translation Edit Rate (Snover et al. 2006, tercom semantics); counterpart
of ``metrics_tpu/ops/text/ter.py``.

TER = (word edits + phrase shifts) / average reference length, where the
greedy shift loop repeatedly applies the shift that most reduces the beam
Levenshtein distance. The shift heuristics (span limits, candidate caps,
ranking tuple) follow the published tercom behavior so scores agree with
sacrebleu, which the tests use as the oracle. The search is inherently
sequential and runs on the host (a data-dependent loop over candidate
shifts), as in the JAX package; only the two float32 sums and the final
ratio live on the device.
"""
from __future__ import annotations

import re
from functools import lru_cache
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import resolve_device
from metrics_tpu_torch.ops.text.helper import _validate_text_inputs

_MAX_SHIFT_SIZE = 10
_MAX_SHIFT_DIST = 50
_MAX_SHIFT_CANDIDATES = 1000
_BEAM_WIDTH = 25
_INT_INF = int(1e16)

# trace ops: 'm' match, 's' substitute, 'd' delete hyp word, 'i' insert ref word


class _TercomTokenizer:
    """Tercom normalizer: lowercase by default, with optional western and
    asian normalization and punctuation removal."""

    _ASIAN_PUNCT = r"([、。〈-】〔-〟｡-･・])"
    _FULL_WIDTH_PUNCT = r"([．，？：；！＂（）])"

    def __init__(
        self,
        normalize: bool = False,
        no_punctuation: bool = False,
        lowercase: bool = True,
        asian_support: bool = False,
    ) -> None:
        self.normalize = normalize
        self.no_punctuation = no_punctuation
        self.lowercase = lowercase
        self.asian_support = asian_support

    @lru_cache(maxsize=2**16)
    def __call__(self, sentence: str) -> str:
        if not sentence:
            return ""
        if self.lowercase:
            sentence = sentence.lower()
        if self.normalize:
            sentence = self._normalize_general_and_western(sentence)
            if self.asian_support:
                sentence = self._normalize_asian(sentence)
        if self.no_punctuation:
            sentence = re.sub(r"[\.,\?:;!\"\(\)]", "", sentence)
            if self.asian_support:
                sentence = re.sub(self._ASIAN_PUNCT, "", sentence)
                sentence = re.sub(self._FULL_WIDTH_PUNCT, "", sentence)
        return " ".join(sentence.split())

    @staticmethod
    def _normalize_general_and_western(sentence: str) -> str:
        sentence = f" {sentence} "
        for pattern, replacement in (
            (r"\n-", ""),
            (r"\n", " "),
            (r"&quot;", '"'),
            (r"&amp;", "&"),
            (r"&lt;", "<"),
            (r"&gt;", ">"),
            (r"([{-~[-` -&(-+:-@/])", r" \1 "),
            (r"'s ", r" 's "),
            (r"'s$", r" 's"),
            (r"([^0-9])([\.,])", r"\1 \2 "),
            (r"([\.,])([^0-9])", r" \1 \2"),
            (r"([0-9])(-)", r"\1 \2 "),
        ):
            sentence = re.sub(pattern, replacement, sentence)
        return sentence

    @classmethod
    def _normalize_asian(cls, sentence: str) -> str:
        for block in (
            r"([一-鿿㐀-䶿])",
            r"([㇀-㇯⺀-⻿])",
            r"([㌀-㏿豈-﫿︰-﹏])",
            r"([㈀-㼢])",
        ):
            sentence = re.sub(block, r" \1 ", sentence)
        sentence = re.sub(cls._ASIAN_PUNCT, r" \1 ", sentence)
        sentence = re.sub(cls._FULL_WIDTH_PUNCT, r" \1 ", sentence)
        return sentence


def _beam_edit_distance(hyp: List[str], ref: List[str]) -> Tuple[int, str]:
    """Beam-limited Levenshtein between hypothesis and reference words with an
    operation trace, matching tercom's beam and tie-breaking (prefer
    match/substitute, then delete, then insert)."""
    h_len, r_len = len(hyp), len(ref)
    # dp[i][j] = (cost, op) for hyp[:i] vs ref[:j]
    dp = [[(_INT_INF, "?")] * (r_len + 1) for _ in range(h_len + 1)]
    dp[0] = [(j, "i") for j in range(r_len + 1)]
    dp[0][0] = (0, "?")
    length_ratio = r_len / h_len if hyp else 1.0
    beam = max(_BEAM_WIDTH, int(length_ratio / 2 + _BEAM_WIDTH)) if _BEAM_WIDTH < length_ratio / 2 else _BEAM_WIDTH

    for i in range(1, h_len + 1):
        pseudo_diag = int(i * length_ratio)
        min_j = max(0, pseudo_diag - beam)
        max_j = r_len + 1 if i == h_len else min(r_len + 1, pseudo_diag + beam)
        for j in range(min_j, max_j):
            if j == 0:
                dp[i][j] = (dp[i - 1][j][0] + 1, "d")
                continue
            sub_cost = 0 if hyp[i - 1] == ref[j - 1] else 1
            sub_op = "m" if sub_cost == 0 else "s"
            best = (dp[i - 1][j - 1][0] + sub_cost, sub_op)
            if dp[i - 1][j][0] + 1 < best[0]:
                best = (dp[i - 1][j][0] + 1, "d")
            if dp[i][j - 1][0] + 1 < best[0]:
                best = (dp[i][j - 1][0] + 1, "i")
            dp[i][j] = best

    # backtrack
    trace: List[str] = []
    i, j = h_len, r_len
    while i > 0 or j > 0:
        op = dp[i][j][1]
        trace.append(op)
        if op in ("m", "s"):
            i, j = i - 1, j - 1
        elif op == "d":
            i -= 1
        elif op == "i":
            j -= 1
        else:  # beam cut corner: fall back to deletion/insertion
            if i > 0:
                i -= 1
            else:
                j -= 1
    return dp[h_len][r_len][0], "".join(reversed(trace))


def _trace_to_alignment(trace: str) -> Tuple[Dict[int, int], List[int], List[int]]:
    """Map the edit trace to ref-position -> hyp-position alignments and
    per-position error indicators."""
    hyp_pos = ref_pos = -1
    alignments: Dict[int, int] = {}
    hyp_errors: List[int] = []
    ref_errors: List[int] = []
    for op in trace:
        if op == "m":
            hyp_pos += 1
            ref_pos += 1
            alignments[ref_pos] = hyp_pos
            hyp_errors.append(0)
            ref_errors.append(0)
        elif op == "s":
            hyp_pos += 1
            ref_pos += 1
            alignments[ref_pos] = hyp_pos
            hyp_errors.append(1)
            ref_errors.append(1)
        elif op == "d":  # hyp word with no ref counterpart
            hyp_pos += 1
            hyp_errors.append(1)
        else:  # 'i': ref word missing from hyp
            ref_pos += 1
            alignments[ref_pos] = hyp_pos
            ref_errors.append(1)
    return alignments, hyp_errors, ref_errors


def _find_shifted_pairs(hyp: List[str], ref: List[str]) -> Iterator[Tuple[int, int, int]]:
    """Yield (hyp_start, ref_start, length) for matching word spans."""
    for hyp_start in range(len(hyp)):
        for ref_start in range(len(ref)):
            if abs(ref_start - hyp_start) > _MAX_SHIFT_DIST:
                continue
            for length in range(1, _MAX_SHIFT_SIZE):
                if hyp[hyp_start + length - 1] != ref[ref_start + length - 1]:
                    break
                yield hyp_start, ref_start, length
                if len(hyp) == hyp_start + length or len(ref) == ref_start + length:
                    break


def _perform_shift(words: List[str], start: int, length: int, target: int) -> List[str]:
    """Move ``words[start:start+length]`` so it lands at position ``target``."""
    if target < start:
        return words[:target] + words[start : start + length] + words[target:start] + words[start + length :]
    if target > start + length:
        return words[:start] + words[start + length : target] + words[start : start + length] + words[target:]
    return words[:start] + words[start + length : length + target] + words[start : start + length] + words[length + target :]


def _shift_words(
    hyp: List[str], ref: List[str], checked_candidates: int
) -> Tuple[int, List[str], int]:
    """One round of the greedy shift search: best (most distance-reducing)
    candidate shift per tercom's ranking."""
    edit_distance, trace = _beam_edit_distance(hyp, ref)
    alignments, hyp_errors, ref_errors = _trace_to_alignment(trace)

    best: Optional[Tuple[int, int, int, int, List[str]]] = None
    for hyp_start, ref_start, length in _find_shifted_pairs(hyp, ref):
        # skip unless the hyp span is wrong where it is AND the ref span is
        # wrong at the target position, and never shift into the span itself
        if sum(hyp_errors[hyp_start : hyp_start + length]) == 0:
            continue
        if sum(ref_errors[ref_start : ref_start + length]) == 0:
            continue
        if hyp_start <= alignments[ref_start] < hyp_start + length:
            continue

        prev_idx = -1
        for offset in range(-1, length):
            if ref_start + offset == -1:
                idx = 0
            elif ref_start + offset in alignments:
                idx = alignments[ref_start + offset] + 1
            else:
                break
            if idx == prev_idx:
                continue
            prev_idx = idx
            shifted = _perform_shift(hyp, hyp_start, length, idx)
            candidate = (
                edit_distance - _beam_edit_distance(shifted, ref)[0],
                length,
                -hyp_start,
                -idx,
                shifted,
            )
            checked_candidates += 1
            if best is None or candidate > best:
                best = candidate
        if checked_candidates >= _MAX_SHIFT_CANDIDATES:
            break

    if best is None:
        return 0, hyp, checked_candidates
    return best[0], best[4], checked_candidates


def _translation_edit_rate(hyp_words: List[str], ref_words: List[str]) -> int:
    """Edits (shifts + Levenshtein) to turn hypothesis into reference."""
    if len(ref_words) == 0:
        return len(hyp_words)
    num_shifts = 0
    checked_candidates = 0
    input_words = hyp_words
    while True:
        delta, new_input, checked_candidates = _shift_words(input_words, ref_words, checked_candidates)
        if checked_candidates >= _MAX_SHIFT_CANDIDATES or delta <= 0:
            break
        num_shifts += 1
        input_words = new_input
    edit_distance, _ = _beam_edit_distance(input_words, ref_words)
    return num_shifts + edit_distance


def _compute_sentence_statistics(hyp_words: List[str], ref_corpus: List[List[str]]) -> Tuple[float, float]:
    """(best edits over references, average reference length)."""
    ref_lengths = 0.0
    best_num_edits = float(_INT_INF)
    for ref_words in ref_corpus:
        num_edits = _translation_edit_rate(hyp_words, ref_words)
        ref_lengths += len(ref_words)
        best_num_edits = min(best_num_edits, float(num_edits))
    return best_num_edits, ref_lengths / len(ref_corpus)


def _ter_update(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    tokenizer: _TercomTokenizer,
    total_num_edits: Tensor,
    total_tgt_length: Tensor,
    sentence_ter: Optional[List[Tensor]] = None,
) -> Tuple[Tensor, Tensor, Optional[List[Tensor]]]:
    """The two sums advanced by this batch, accumulated on the host in
    float64 from the states' values as the JAX package does (two reads),
    then one copy back; ``sentence_ter`` gets one float32 scalar a sentence."""
    target, preds = _validate_text_inputs(target, preds)
    edits_acc = float(total_num_edits)
    length_acc = float(total_tgt_length)
    scores: List[float] = []
    for pred, refs in zip(preds, target):
        pred_words = tokenizer(pred.rstrip()).split()
        ref_words = [tokenizer(ref.rstrip()).split() for ref in refs]
        num_edits, tgt_length = _compute_sentence_statistics(pred_words, ref_words)
        edits_acc += num_edits
        length_acc += tgt_length
        scores.append(_score_from_statistics(num_edits, tgt_length))
    host = np.asarray([edits_acc, length_acc] + (scores if sentence_ter is not None else []), dtype=np.float64)
    batch = torch.from_numpy(host.astype(np.float32)).to(total_num_edits.device)
    if sentence_ter is not None:
        sentence_ter.extend(batch[2:].unbind(0))
    return batch[0], batch[1], sentence_ter


def _score_from_statistics(num_edits: float, tgt_length: float) -> float:
    if tgt_length > 0 and num_edits > 0:
        return num_edits / tgt_length
    if tgt_length == 0 and num_edits > 0:
        return 1.0
    return 0.0


def _ter_compute(total_num_edits: Tensor, total_tgt_length: Tensor) -> Tensor:
    one = torch.ones((), dtype=total_num_edits.dtype, device=total_num_edits.device)
    return torch.where(
        total_tgt_length > 0,
        total_num_edits / torch.clamp(total_tgt_length, min=1e-16),
        torch.where(total_num_edits > 0, one, torch.zeros_like(one)),
    )


def translation_edit_rate(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    normalize: bool = False,
    no_punctuation: bool = False,
    lowercase: bool = True,
    asian_support: bool = False,
    return_sentence_level_score: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Corpus TER.

    Example:
        >>> from metrics_tpu_torch.ops import translation_edit_rate
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> round(float(translation_edit_rate(preds, target, device="cpu")), 4)
        0.1538
    """
    for name, val in (("normalize", normalize), ("no_punctuation", no_punctuation),
                      ("lowercase", lowercase), ("asian_support", asian_support)):
        if not isinstance(val, bool):
            raise ValueError(f"Expected argument `{name}` to be of type boolean")
    tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
    sentence_ter: Optional[List[Tensor]] = [] if return_sentence_level_score else None
    zero = torch.zeros((), dtype=torch.float32, device=resolve_device(device))
    total_num_edits, total_tgt_length, sentence_ter = _ter_update(preds, target, tokenizer, zero, zero, sentence_ter)
    score = _ter_compute(total_num_edits, total_tgt_length)
    if return_sentence_level_score:
        return score, torch.stack(sentence_ter) if sentence_ter else torch.zeros(0, device=zero.device)
    return score
