"""Per-class dict output wrapper (counterpart of ``metrics_tpu/wrappers/classwise.py``)."""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from torch import Tensor

from metrics_tpu_torch.core.metric import Metric


class ClasswiseWrapper(Metric):
    """Unroll an ``average=None`` metric's output into a per-class dict keyed
    ``f"{lower class name}_{label or index}"``. The wrapper lives on its
    metric's device unless ``device`` says otherwise.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy, ClasswiseWrapper
        >>> wrapped = ClasswiseWrapper(Accuracy(num_classes=3, average=None, device="cpu"), labels=["a", "b", "c"])
        >>> wrapped.update(torch.tensor([0, 1, 2, 0]), torch.tensor([0, 1, 1, 0]))
        >>> {k: round(float(v), 2) for k, v in wrapped.compute().items()}
        {'accuracy_a': 1.0, 'accuracy_b': 0.5, 'accuracy_c': 0.0}
    """

    full_state_update: Optional[bool] = True

    def __init__(self, metric: Metric, labels: Optional[List[str]] = None, **kwargs: Any) -> None:
        if not isinstance(metric, Metric):
            raise ValueError(f"Expected argument `metric` to be an instance of `metrics_tpu_torch.Metric` but got {metric}")
        if labels is not None and not (isinstance(labels, list) and all(isinstance(lab, str) for lab in labels)):
            raise ValueError(f"Expected argument `labels` to either be `None` or a list of strings but got {labels}")
        kwargs.setdefault("device", metric.device)
        super().__init__(**kwargs)
        self.metric = metric
        self.labels = labels

    def _convert(self, x: Tensor) -> Dict[str, Tensor]:
        name = self.metric.__class__.__name__.lower()
        if self.labels is None:
            return {f"{name}_{i}": val for i, val in enumerate(x)}
        return {f"{name}_{lab}": val for lab, val in zip(self.labels, x)}

    def update(self, *args: Any, **kwargs: Any) -> None:  # type: ignore[override]
        self.metric.update(*args, **kwargs)

    def compute(self) -> Dict[str, Tensor]:
        return self._convert(self.metric.compute())

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Tensor]:
        # the inner forward advances the inner metric: the wrapper's cache and
        # update count follow it, or compute() would return a stale value
        self._computed = None
        self._update_count += 1
        self._forward_cache = self._convert(self.metric(*args, **kwargs))
        return self._forward_cache

    def reset(self) -> None:
        super().reset()
        self.metric.reset()
