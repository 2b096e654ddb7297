"""SacreBLEU: BLEU over standard mteval tokenizers (counterpart of
``metrics_tpu/ops/text/sacre_bleu.py``): ``none``, ``13a``, ``zh``, ``intl``
and ``char``.

The tokenizers implement the published mteval-v13a / v14-international specs
(Post 2018, "A Call for Clarity in Reporting BLEU Scores"); unicode-property
rules are expressed via :mod:`unicodedata` categories since the stdlib ``re``
lacks ``\\p{...}`` classes.
"""
from __future__ import annotations

import re
import unicodedata
from typing import ClassVar, Dict, Optional, Sequence, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import resolve_device
from metrics_tpu_torch.ops.text.bleu import _bleu_score_compute, _bleu_score_update, _zero_states

AVAILABLE_TOKENIZERS = ("none", "13a", "zh", "intl", "char")


# sacrebleu's zh tokenizer splits on more than ideographs: full-width ASCII,
# CJK punctuation, radicals, strokes, bopomofo etc.
_UCODE_RANGES = (
    (0x3400, 0x4DB5),   # CJK Unified Ideographs Extension A
    (0x4E00, 0x9FA5),   # CJK Unified Ideographs
    (0x9FA6, 0x9FBB),   # CJK Unified Ideographs, release 4.1
    (0xF900, 0xFA2D),   # CJK Compatibility Ideographs
    (0xFA30, 0xFA6A),   # CJK Compatibility Ideographs, release 3.2
    (0xFA70, 0xFAD9),   # CJK Compatibility Ideographs, release 4.1
    (0x20000, 0x2A6D6), # CJK Unified Ideographs Extension B
    (0x2F800, 0x2FA1D), # CJK Compatibility Supplement
    (0xFF00, 0xFFEF),   # full-width ASCII & punctuation, half-width kana/hangul
    (0x2E80, 0x2EFF),   # CJK Radicals Supplement
    (0x3000, 0x303F),   # CJK punctuation marks
    (0x31C0, 0x31EF),   # CJK strokes
    (0x2F00, 0x2FDF),   # Kangxi Radicals
    (0x2FF0, 0x2FFF),   # Chinese character structure
    (0x3100, 0x312F),   # phonetic symbols
    (0x31A0, 0x31BF),   # phonetic symbols (Taiwanese and Hakka expansion)
    (0xFE10, 0xFE1F),
    (0xFE30, 0xFE4F),
    (0x2600, 0x26FF),
    (0x2700, 0x27BF),
    (0x3200, 0x32FF),
    (0x3300, 0x33FF),
)


def _is_chinese_char(char: str) -> bool:
    cp = ord(char)
    return any(lo <= cp <= hi for lo, hi in _UCODE_RANGES)


class _SacreBLEUTokenizer:
    """Line -> token list for each supported scheme."""

    _REGEX_13A = (
        (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),  # non .,- punctuation
        (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),  # . , unless preceded by a digit
        (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),  # . , unless followed by a digit
        (re.compile(r"([0-9])(-)"), r"\1 \2 "),  # dash preceded by a digit
    )

    _TOKENIZE_FN: ClassVar[Dict[str, str]] = {
        "none": "_tokenize_base",
        "13a": "_tokenize_13a",
        "zh": "_tokenize_zh",
        "intl": "_tokenize_international",
        "char": "_tokenize_char",
    }

    def __init__(self, tokenize: str = "13a", lowercase: bool = False) -> None:
        if tokenize not in self._TOKENIZE_FN:
            raise ValueError(f"Unsupported tokenizer {tokenize!r}, expected one of {AVAILABLE_TOKENIZERS}")
        self.tokenize_fn = getattr(self, self._TOKENIZE_FN[tokenize])
        self.lowercase = lowercase

    def __call__(self, line: str) -> Sequence[str]:
        tokenized = self.tokenize_fn(line)
        return (tokenized.lower() if self.lowercase else tokenized).split()

    @classmethod
    def _tokenize_regex(cls, line: str) -> str:
        for pattern, replacement in cls._REGEX_13A:
            line = pattern.sub(replacement, line)
        return " ".join(line.split())

    @classmethod
    def _tokenize_base(cls, line: str) -> str:
        return line

    @classmethod
    def _tokenize_13a(cls, line: str) -> str:
        line = line.replace("<skipped>", "")
        line = line.replace("-\n", "")
        line = line.replace("\n", " ")
        if "&" in line:
            line = line.replace("&quot;", '"').replace("&amp;", "&").replace("&lt;", "<").replace("&gt;", ">")
        return cls._tokenize_regex(f" {line} ")

    @classmethod
    def _tokenize_zh(cls, line: str) -> str:
        line = line.strip()
        out = []
        for char in line:
            if _is_chinese_char(char):
                out.append(f" {char} ")
            else:
                out.append(char)
        return cls._tokenize_regex("".join(out))

    @classmethod
    def _tokenize_international(cls, line: str) -> str:
        # mteval-v14: split unicode punctuation unless adjacent to a digit; split symbols
        out = []
        for i, char in enumerate(line):
            cat = unicodedata.category(char)
            if cat.startswith("P"):
                # split unless flanked by digits (matching the \P{N}\p{P} / \p{P}\P{N} rules)
                prev_nondigit = i > 0 and not unicodedata.category(line[i - 1]).startswith("N")
                next_nondigit = i + 1 < len(line) and not unicodedata.category(line[i + 1]).startswith("N")
                if prev_nondigit or next_nondigit:
                    out.append(f" {char} ")
                    continue
            if cat.startswith("S"):
                out.append(f" {char} ")
                continue
            out.append(char)
        return " ".join("".join(out).split())

    @classmethod
    def _tokenize_char(cls, line: str) -> str:
        return " ".join(char for char in line)


def sacre_bleu_score(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    n_gram: int = 4,
    smooth: bool = False,
    tokenize: str = "13a",
    lowercase: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """SacreBLEU corpus score.

    Example:
        >>> from metrics_tpu_torch.ops import sacre_bleu_score
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> round(float(sacre_bleu_score(preds, target, device="cpu")), 4)
        0.7598
    """
    if len(preds) != len(target):
        raise ValueError(f"Corpus has different size {len(preds)} != {len(target)}")
    tokenizer = _SacreBLEUTokenizer(tokenize, lowercase)
    numerator, denominator, preds_len, target_len = _bleu_score_update(
        preds, target, *_zero_states(n_gram, resolve_device(device)), n_gram, tokenizer
    )
    return _bleu_score_compute(preds_len, target_len, numerator, denominator, n_gram, smooth)
