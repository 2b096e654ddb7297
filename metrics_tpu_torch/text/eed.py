"""ExtendedEditDistance (counterpart of ``metrics_tpu/text/eed.py``): a ``cat``
list of float32 sentence scores; compute is their mean."""
from __future__ import annotations

from typing import Any, Sequence, Tuple, Union

from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.ops.text.eed import _eed_compute, _eed_update
from metrics_tpu_torch.text.chrf import _stack_or_empty


class ExtendedEditDistance(Metric):
    """EED.

    Example:
        >>> from metrics_tpu_torch import ExtendedEditDistance
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> eed = ExtendedEditDistance(device="cpu")
        >>> eed.update(preds, target)
        >>> round(float(eed.compute()), 4)
        0.3031
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
        language: str = "en",
        return_sentence_level_score: bool = False,
        alpha: float = 2.0,
        rho: float = 0.3,
        deletion: float = 0.2,
        insertion: float = 1.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if language not in ("en", "ja"):
            raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")
        self.language = language
        self.return_sentence_level_score = return_sentence_level_score
        for name, val in (("alpha", alpha), ("rho", rho), ("deletion", deletion), ("insertion", insertion)):
            if not isinstance(val, float) or val < 0:
                raise ValueError(f"Expected argument `{name}` to be a non-negative float")
        self.alpha = alpha
        self.rho = rho
        self.deletion = deletion
        self.insertion = insertion
        self.add_state("sentence_eed", default=[], dist_reduce_fx="cat")

    def update(self, preds: Union[str, Sequence[str]], target: Sequence[Union[str, Sequence[str]]]) -> None:  # type: ignore[override]
        self.sentence_eed = _eed_update(
            preds, target, self.language, self.alpha, self.rho, self.deletion, self.insertion,
            list(self.sentence_eed), self.device,
        )

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        average = _eed_compute(self.sentence_eed, self.device)
        if self.return_sentence_level_score:
            return average, _stack_or_empty(self.sentence_eed, self.device)
        return average
