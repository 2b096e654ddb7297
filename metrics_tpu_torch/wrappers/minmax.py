"""Min/max tracking wrapper (counterpart of ``metrics_tpu/wrappers/minmax.py``)."""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric


class MinMaxMetric(Metric):
    """Track the min and max of a base metric's compute over time.

    ``min_val`` and ``max_val`` are registered states (reduced ``min`` and
    ``max`` across ranks), so ``reset``, snapshots and sync cover them. The
    wrapper lives on its base metric's device unless ``device`` says
    otherwise.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy, MinMaxMetric
        >>> wrapped = MinMaxMetric(Accuracy(device="cpu"))
        >>> wrapped.update(torch.tensor([1, 0, 1, 1]), torch.tensor([1, 1, 1, 1]))
        >>> {k: round(float(v), 2) for k, v in wrapped.compute().items()}
        {'raw': 0.75, 'max': 0.75, 'min': 0.75}
        >>> wrapped.update(torch.tensor([1, 1, 1, 1]), torch.tensor([1, 1, 1, 1]))
        >>> {k: round(float(v), 2) for k, v in wrapped.compute().items()}
        {'raw': 0.88, 'max': 0.88, 'min': 0.75}
    """

    full_state_update: bool = True

    def __init__(self, base_metric: Metric, **kwargs: Any) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of `metrics_tpu_torch.Metric` but received {base_metric}"
            )
        kwargs.setdefault("device", base_metric.device)
        super().__init__(**kwargs)
        self._base_metric = base_metric
        self.add_state("min_val", torch.tensor(float("inf")), dist_reduce_fx="min")
        self.add_state("max_val", torch.tensor(float("-inf")), dist_reduce_fx="max")

    def update(self, *args: Any, **kwargs: Any) -> None:  # type: ignore[override]
        self._base_metric.update(*args, **kwargs)

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Tensor]:
        """The batch value, with the batch's value folded into the tracked
        bounds: the forward snapshot restores the registered bounds, so the
        fold is explicit."""
        val = super().forward(*args, **kwargs)
        self.min_val = torch.minimum(self.min_val, val["min"])
        self.max_val = torch.maximum(self.max_val, val["max"])
        self._forward_cache = {"raw": val["raw"], "min": self.min_val, "max": self.max_val}
        return self._forward_cache

    def compute(self) -> Dict[str, Tensor]:
        val = self._base_metric.compute()
        if not self._is_suitable_val(val):
            raise RuntimeError(f"Returned value from base metric should be a float or scalar tensor, but got {val}.")
        as_state = torch.as_tensor(val, dtype=torch.float32, device=self.device)
        self.max_val = torch.where(self.max_val < val, as_state, self.max_val)
        self.min_val = torch.where(self.min_val > val, as_state, self.min_val)
        return {"raw": val, "max": self.max_val, "min": self.min_val}

    @staticmethod
    def _is_suitable_val(val: Any) -> bool:
        if isinstance(val, (int, float)):
            return True
        if isinstance(val, Tensor):
            return val.numel() == 1
        return False

    def reset(self) -> None:
        super().reset()
        self._base_metric.reset()
