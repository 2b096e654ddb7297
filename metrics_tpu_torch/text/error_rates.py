"""Error-rate text modules: WordErrorRate, CharErrorRate, MatchErrorRate,
WordInfoLost, WordInfoPreserved (counterpart of
``metrics_tpu/text/error_rates.py``).

Every state is a float32 scalar sum of integers, summed across ranks. The
edit distances run on the metric's device
(:func:`metrics_tpu_torch.ops.text.helper.edit_distance_batch`).
"""
from __future__ import annotations

from typing import Any, List, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.ops.text.error_rates import (
    _cer_compute,
    _cer_update,
    _mer_compute,
    _mer_update,
    _wer_compute,
    _wer_update,
    _wil_compute,
    _wil_update,
    _wip_compute,
    _wip_update,
)

_Corpus = Union[str, List[str]]


class WordErrorRate(Metric):
    """Word error rate.

    Example:
        >>> from metrics_tpu_torch import WordErrorRate
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> wer = WordErrorRate(device="cpu")
        >>> wer.update(preds, target)
        >>> round(float(wer.compute()), 4)
        0.5
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: _Corpus, target: _Corpus) -> None:  # type: ignore[override]
        errors, total = _wer_update(preds, target, self.device)
        self.errors = self.errors + errors
        self.total = self.total + total

    def compute(self) -> Tensor:
        return _wer_compute(self.errors, self.total)


class CharErrorRate(Metric):
    """Character error rate.

    Example:
        >>> from metrics_tpu_torch import CharErrorRate
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> cer = CharErrorRate(device="cpu")
        >>> cer.update(preds, target)
        >>> round(float(cer.compute()), 4)
        0.3415
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: _Corpus, target: _Corpus) -> None:  # type: ignore[override]
        errors, total = _cer_update(preds, target, self.device)
        self.errors = self.errors + errors
        self.total = self.total + total

    def compute(self) -> Tensor:
        return _cer_compute(self.errors, self.total)


class MatchErrorRate(Metric):
    """Match error rate.

    Example:
        >>> from metrics_tpu_torch import MatchErrorRate
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> mer = MatchErrorRate(device="cpu")
        >>> mer.update(preds, target)
        >>> round(float(mer.compute()), 4)
        0.4444
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: _Corpus, target: _Corpus) -> None:  # type: ignore[override]
        errors, total = _mer_update(preds, target, self.device)
        self.errors = self.errors + errors
        self.total = self.total + total

    def compute(self) -> Tensor:
        return _mer_compute(self.errors, self.total)


class WordInfoLost(Metric):
    """Word information lost.

    Example:
        >>> from metrics_tpu_torch import WordInfoLost
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> wil = WordInfoLost(device="cpu")
        >>> wil.update(preds, target)
        >>> round(float(wil.compute()), 4)
        0.6528
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("target_total", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("preds_total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: _Corpus, target: _Corpus) -> None:  # type: ignore[override]
        errors, target_total, preds_total = _wil_update(preds, target, self.device)
        self.errors = self.errors + errors
        self.target_total = self.target_total + target_total
        self.preds_total = self.preds_total + preds_total

    def compute(self) -> Tensor:
        return _wil_compute(self.errors, self.target_total, self.preds_total)


class WordInfoPreserved(Metric):
    """Word information preserved.

    Example:
        >>> from metrics_tpu_torch import WordInfoPreserved
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> wip = WordInfoPreserved(device="cpu")
        >>> wip.update(preds, target)
        >>> round(float(wip.compute()), 4)
        0.3472
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("target_total", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("preds_total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: _Corpus, target: _Corpus) -> None:  # type: ignore[override]
        errors, target_total, preds_total = _wip_update(preds, target, self.device)
        self.errors = self.errors + errors
        self.target_total = self.target_total + target_total
        self.preds_total = self.preds_total + preds_total

    def compute(self) -> Tensor:
        return _wip_compute(self.errors, self.target_total, self.preds_total)
