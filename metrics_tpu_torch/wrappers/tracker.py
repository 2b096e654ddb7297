"""Track a metric or collection over timesteps (counterpart of ``metrics_tpu/wrappers/tracker.py``)."""
from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, List, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.core.collections import MetricCollection
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _host(values: Tensor) -> np.ndarray:
    return values.detach().to(device="cpu", dtype=torch.float64).numpy()


class MetricTracker:
    """Keeps one copy of the base metric (or collection) per ``increment()``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy, MetricTracker
        >>> tracker = MetricTracker(Accuracy(num_classes=3, device="cpu"))
        >>> for epoch_preds in ([0, 1, 1], [0, 1, 2]):
        ...     tracker.increment()
        ...     tracker.update(torch.tensor(epoch_preds), torch.tensor([0, 1, 2]))
        >>> [round(float(v), 4) for v in tracker.compute_all()]
        [0.6667, 1.0]
        >>> best, step = tracker.best_metric(return_step=True)
        >>> round(float(best), 2), step
        (1.0, 1)
    """

    def __init__(self, metric: Union[Metric, MetricCollection], maximize: Union[bool, List[bool]] = True) -> None:
        if not isinstance(metric, (Metric, MetricCollection)):
            raise TypeError(
                "Metric arg need to be an instance of a metrics_tpu_torch"
                f" `Metric` or `MetricCollection` but got {metric}"
            )
        self._base_metric = metric
        self._metrics: List[Union[Metric, MetricCollection]] = []
        if not isinstance(maximize, (bool, list)):
            raise ValueError("Argument `maximize` should either be a single bool or list of bool")
        if isinstance(maximize, list):
            if not isinstance(metric, MetricCollection):
                raise ValueError("Argument `maximize` can only be a list when `metric` is a MetricCollection")
            if len(maximize) != len(metric):
                raise ValueError("The len of argument `maximize` should match the length of the metric collection")
        self.maximize = maximize
        self._increment_called = False

    @property
    def n_steps(self) -> int:
        return len(self._metrics)

    def increment(self) -> None:
        """Start a new timestep."""
        self._increment_called = True
        self._metrics.append(deepcopy(self._base_metric))
        self._metrics[-1].reset()

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        self._check_for_increment("forward")
        return self._metrics[-1](*args, **kwargs)

    __call__ = forward

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._check_for_increment("update")
        self._metrics[-1].update(*args, **kwargs)

    def compute(self) -> Any:
        self._check_for_increment("compute")
        return self._metrics[-1].compute()

    def compute_all(self) -> Union[Tensor, Dict[str, Tensor]]:
        """Every timestep's compute, stacked."""
        self._check_for_increment("compute_all")
        res = [metric.compute() for metric in self._metrics]
        if isinstance(self._base_metric, MetricCollection):
            keys = res[0].keys()
            return {k: torch.stack([torch.as_tensor(r[k]) for r in res], dim=0) for k in keys}
        return torch.stack([torch.as_tensor(r) for r in res], dim=0)

    def reset(self) -> None:
        self._metrics[-1].reset()

    def reset_all(self) -> None:
        for metric in self._metrics:
            metric.reset()

    def best_metric(
        self, return_step: bool = False
    ) -> Union[float, Tuple[float, int], Dict[str, float], Tuple[Dict[str, float], Dict[str, int]]]:
        """The best value over time (``nanargmax`` or ``nanargmin`` per
        ``maximize``); with ``return_step`` the pair ``(value, step)``."""
        res = self.compute_all()
        if isinstance(res, dict):
            maximize = self.maximize if isinstance(self.maximize, list) else [self.maximize] * len(res)
            value, idx = {}, {}
            for i, (k, v) in enumerate(res.items()):
                v = _host(v)
                fn = np.nanargmax if maximize[i] else np.nanargmin
                try:
                    best_i = int(fn(v))
                except ValueError:
                    rank_zero_warn(f"Encountered all-nan values in metric {k}; returning None")
                    value[k], idx[k] = None, None
                    continue
                value[k] = float(v[best_i])
                idx[k] = best_i
            return (value, idx) if return_step else value
        v = _host(res)
        fn = np.nanargmax if self.maximize else np.nanargmin
        try:
            best_i = int(fn(v))
        except ValueError:
            rank_zero_warn("Encountered all-nan values; returning None")
            return (None, None) if return_step else None
        return (float(v[best_i]), best_i) if return_step else float(v[best_i])

    def _check_for_increment(self, method: str) -> None:
        if not self._increment_called:
            raise ValueError(f"`{method}` cannot be called before `.increment()` has been called")
