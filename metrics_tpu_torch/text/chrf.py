"""CHRFScore (counterpart of ``metrics_tpu/text/chrf.py``): three
``(n_char_order + n_word_order,)`` float32 count vectors summed across ranks,
and with ``return_sentence_level_score`` a ``cat`` list of sentence scores."""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.ops.text.chrf import _chrf_score_compute, _chrf_score_update


class CHRFScore(Metric):
    """chrF and chrF++.

    Example:
        >>> from metrics_tpu_torch import CHRFScore
        >>> preds = ["the cat is on the mat"]
        >>> target = [["there is a cat on the mat"]]
        >>> chrf = CHRFScore(device="cpu")
        >>> chrf.update(preds, target)
        >>> round(float(chrf.compute()), 4)
        0.4942
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True

    def __init__(
        self,
        n_char_order: int = 6,
        n_word_order: int = 2,
        beta: float = 2.0,
        lowercase: bool = False,
        whitespace: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(n_char_order, int) or n_char_order < 1:
            raise ValueError("Expected argument `n_char_order` to be an integer greater than or equal to 1.")
        if not isinstance(n_word_order, int) or n_word_order < 0:
            raise ValueError("Expected argument `n_word_order` to be an integer greater than or equal to 0.")
        if beta < 0:
            raise ValueError("Expected argument `beta` to be greater than 0.")
        self.n_char_order = n_char_order
        self.n_word_order = n_word_order
        self.beta = beta
        self.lowercase = lowercase
        self.whitespace = whitespace
        self.return_sentence_level_score = return_sentence_level_score
        self.n_order = float(n_char_order + n_word_order)

        n = n_char_order + n_word_order
        self.add_state("matching_counts", default=torch.zeros(n), dist_reduce_fx="sum")
        self.add_state("hyp_counts", default=torch.zeros(n), dist_reduce_fx="sum")
        self.add_state("ref_counts", default=torch.zeros(n), dist_reduce_fx="sum")
        if self.return_sentence_level_score:
            self.add_state("sentence_chrf_score", default=[], dist_reduce_fx="cat")

    def update(self, preds: Sequence[str], target: Sequence[Sequence[str]]) -> None:  # type: ignore[override]
        sentence_scores: Optional[List[Tensor]] = [] if self.return_sentence_level_score else None
        self.matching_counts, self.hyp_counts, self.ref_counts, sentence_scores = _chrf_score_update(
            preds, target, self.matching_counts, self.hyp_counts, self.ref_counts,
            self.n_char_order, self.n_word_order, self.beta, self.lowercase, self.whitespace, sentence_scores,
        )
        if sentence_scores is not None:
            self.sentence_chrf_score = self.sentence_chrf_score + sentence_scores

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        score = _chrf_score_compute(self.matching_counts, self.hyp_counts, self.ref_counts, self.n_order, self.beta)
        if self.return_sentence_level_score:
            return score, _stack_or_empty(self.sentence_chrf_score, self.device)
        return score


def _stack_or_empty(values: List[Tensor], device: torch.device) -> Tensor:
    return torch.stack(values) if values else torch.zeros(0, device=device)
