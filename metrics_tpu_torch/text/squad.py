"""SQuAD module (counterpart of ``metrics_tpu/text/squad.py``): float32 F1 and
exact-match sums and an int32 question count."""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.ops.text.squad import PREDS_TYPE, TARGETS_TYPE, _squad_compute, _squad_input_check, _squad_update


class SQuAD(Metric):
    """SQuAD exact match and F1.

    Example:
        >>> from metrics_tpu_torch import SQuAD
        >>> preds = [{"prediction_text": "1976", "id": "56e10a3be3433e1400422b22"}]
        >>> target = [{"answers": {"answer_start": [97], "text": ["1976"]}, "id": "56e10a3be3433e1400422b22"}]
        >>> squad = SQuAD(device="cpu")
        >>> squad.update(preds, target)
        >>> {k: round(float(v), 1) for k, v in squad.compute().items()}
        {'exact_match': 100.0, 'f1': 100.0}
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("f1_score", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("exact_match", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: PREDS_TYPE, target: TARGETS_TYPE) -> None:  # type: ignore[override]
        preds_dict, target_dict = _squad_input_check(preds, target)
        f1, exact_match, total = _squad_update(preds_dict, target_dict, self.device)
        self.f1_score = self.f1_score + f1
        self.exact_match = self.exact_match + exact_match
        self.total = self.total + total

    def compute(self) -> Dict[str, Tensor]:
        return _squad_compute(self.f1_score, self.exact_match, self.total)
