"""BLEUScore and SacreBLEUScore (counterpart of ``metrics_tpu/text/bleu.py``):
two ``(n_gram,)`` float32 count vectors and two length scalars, all summed
across ranks."""
from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.ops.text.bleu import _bleu_score_compute, _bleu_score_update, _tokenize_fn
from metrics_tpu_torch.ops.text.sacre_bleu import AVAILABLE_TOKENIZERS, _SacreBLEUTokenizer


class BLEUScore(Metric):
    """Corpus BLEU.

    Example:
        >>> from metrics_tpu_torch import BLEUScore
        >>> preds = ["the cat is on the mat"]
        >>> target = [["there is a cat on the mat", "a cat is on the mat"]]
        >>> bleu = BLEUScore(device="cpu")
        >>> bleu.update(preds, target)
        >>> round(float(bleu.compute()), 4)
        0.7598
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True

    def __init__(self, n_gram: int = 4, smooth: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.n_gram = n_gram
        self.smooth = smooth
        self.tokenizer = _tokenize_fn
        self.add_state("preds_len", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("target_len", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("numerator", default=torch.zeros(n_gram), dist_reduce_fx="sum")
        self.add_state("denominator", default=torch.zeros(n_gram), dist_reduce_fx="sum")

    def update(self, preds: Sequence[str], target: Sequence[Sequence[str]]) -> None:  # type: ignore[override]
        preds = [preds] if isinstance(preds, str) else preds
        target = [[tgt] if isinstance(tgt, str) else tgt for tgt in target]
        if len(preds) != len(target):
            raise ValueError(f"Corpus has different size {len(preds)} != {len(target)}")
        self.numerator, self.denominator, self.preds_len, self.target_len = _bleu_score_update(
            preds, target, self.numerator, self.denominator, self.preds_len, self.target_len,
            self.n_gram, self.tokenizer,
        )

    def compute(self) -> Tensor:
        return _bleu_score_compute(
            self.preds_len, self.target_len, self.numerator, self.denominator, self.n_gram, self.smooth
        )


class SacreBLEUScore(BLEUScore):
    """Corpus BLEU over the mteval tokenizers (``13a`` by default).

    Example:
        >>> from metrics_tpu_torch import SacreBLEUScore
        >>> preds = ["the cat is on the mat"]
        >>> target = [["there is a cat on the mat", "a cat is on the mat"]]
        >>> sacre_bleu = SacreBLEUScore(device="cpu")
        >>> sacre_bleu.update(preds, target)
        >>> round(float(sacre_bleu.compute()), 4)
        0.7598
    """

    def __init__(
        self,
        n_gram: int = 4,
        smooth: bool = False,
        tokenize: str = "13a",
        lowercase: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(n_gram=n_gram, smooth=smooth, **kwargs)
        if tokenize not in AVAILABLE_TOKENIZERS:
            raise ValueError(f"Argument `tokenize` expected to be one of {AVAILABLE_TOKENIZERS} but got {tokenize}.")
        self.tokenizer = _SacreBLEUTokenizer(tokenize, lowercase)
