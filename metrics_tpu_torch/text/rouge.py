"""ROUGEScore (counterpart of ``metrics_tpu/text/rouge.py``): one ``cat`` list
state of float32 sentence scores per rouge key and score; compute is their
mean. With ``use_stemmer`` it needs nltk; nothing is ever downloaded."""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.ops.text.rouge import (
    ALLOWED_ROUGE_KEYS,
    _canonical_corpora,
    _check_rouge_args,
    _rouge_score_compute,
    _rouge_score_update,
)


class ROUGEScore(Metric):
    """ROUGE-N, ROUGE-L and ROUGE-Lsum.

    Example:
        >>> from metrics_tpu_torch import ROUGEScore
        >>> rouge = ROUGEScore(device="cpu")
        >>> rouge.update(["My name is John"], ["Is your name John"])
        >>> round(float(rouge.compute()["rouge1_fmeasure"]), 4)
        0.75
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True

    def __init__(
        self,
        use_stemmer: bool = False,
        normalizer: Optional[Callable[[str], str]] = None,
        tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
        accumulate: str = "best",
        rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(rouge_keys, tuple):
            rouge_keys = (rouge_keys,)
        _check_rouge_args(use_stemmer, accumulate, rouge_keys)
        self.rouge_keys = rouge_keys
        self.rouge_keys_values = [ALLOWED_ROUGE_KEYS[k] for k in rouge_keys]
        self.use_stemmer = use_stemmer
        self.normalizer = normalizer
        self.tokenizer = tokenizer
        self.accumulate = accumulate
        self.stemmer = self._make_stemmer()

        for rouge_key in self.rouge_keys:
            for score in ["fmeasure", "precision", "recall"]:
                self.add_state(f"{rouge_key}_{score}", default=[], dist_reduce_fx="cat")

    def _make_stemmer(self) -> Optional[Any]:
        if not self.use_stemmer:
            return None
        import nltk

        return nltk.stem.porter.PorterStemmer()

    def update(self, preds: Union[str, Sequence[str]], target: Union[str, Sequence[str], Sequence[Sequence[str]]]) -> None:  # type: ignore[override]
        preds, target = _canonical_corpora(preds, target)
        output = _rouge_score_update(
            preds, target, self.rouge_keys_values, self.accumulate, self.stemmer, self.normalizer, self.tokenizer,
            self.device,
        )
        for name, scores in output.items():
            setattr(self, name, getattr(self, name) + scores)

    def compute(self) -> Dict[str, Tensor]:
        update_output = {
            f"rouge{k}_{tp}": getattr(self, f"rouge{k}_{tp}")
            for k in self.rouge_keys_values
            for tp in ["fmeasure", "precision", "recall"]
        }
        return _rouge_score_compute(update_output, self.device)

    def __getstate__(self) -> Dict[str, Any]:
        state = super().__getstate__()
        state.pop("stemmer", None)  # a PorterStemmer does not pickle cleanly
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        super().__setstate__(state)
        self.stemmer = self._make_stemmer()
