"""TranslationEditRate (counterpart of ``metrics_tpu/text/ter.py``): float32
edit and length sums, and with ``return_sentence_level_score`` a ``cat`` list
of sentence scores."""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.ops.text.ter import _TercomTokenizer, _ter_compute, _ter_update
from metrics_tpu_torch.text.chrf import _stack_or_empty


class TranslationEditRate(Metric):
    """TER.

    Example:
        >>> from metrics_tpu_torch import TranslationEditRate
        >>> preds = ["the cat is on the mat"]
        >>> target = [["there is a cat on the mat", "a cat is on the mat"]]
        >>> ter = TranslationEditRate(device="cpu")
        >>> ter.update(preds, target)
        >>> round(float(ter.compute()), 4)
        0.1538
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
        normalize: bool = False,
        no_punctuation: bool = False,
        lowercase: bool = True,
        asian_support: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        for name, val in (("normalize", normalize), ("no_punctuation", no_punctuation),
                          ("lowercase", lowercase), ("asian_support", asian_support)):
            if not isinstance(val, bool):
                raise ValueError(f"Expected argument `{name}` to be of type boolean")
        self.tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
        self.return_sentence_level_score = return_sentence_level_score
        self.add_state("total_num_edits", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total_tgt_length", default=torch.tensor(0.0), dist_reduce_fx="sum")
        if self.return_sentence_level_score:
            self.add_state("sentence_ter", default=[], dist_reduce_fx="cat")

    def update(self, preds: Union[str, Sequence[str]], target: Sequence[Union[str, Sequence[str]]]) -> None:  # type: ignore[override]
        sentence_ter: Optional[List[Tensor]] = [] if self.return_sentence_level_score else None
        self.total_num_edits, self.total_tgt_length, sentence_ter = _ter_update(
            preds, target, self.tokenizer, self.total_num_edits, self.total_tgt_length, sentence_ter
        )
        if sentence_ter is not None:
            self.sentence_ter = self.sentence_ter + sentence_ter

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        score = _ter_compute(self.total_num_edits, self.total_tgt_length)
        if self.return_sentence_level_score:
            return score, _stack_or_empty(self.sentence_ter, self.device)
        return score
