"""Sum-state regression metrics: MSE, MAE, MSLE, MAPE, SMAPE, WMAPE
(counterpart of ``metrics_tpu/regression/basic.py``).

Each keeps a float32 error sum and an int32 count (WMAPE: two float32 sums).
"""
from __future__ import annotations

from typing import Any

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.ops.regression.basic import (
    _mean_absolute_error_compute,
    _mean_absolute_error_update,
    _mean_absolute_percentage_error_compute,
    _mean_absolute_percentage_error_update,
    _mean_squared_error_compute,
    _mean_squared_error_update,
    _mean_squared_log_error_compute,
    _mean_squared_log_error_update,
    _symmetric_mean_absolute_percentage_error_update,
    _weighted_mean_absolute_percentage_error_compute,
    _weighted_mean_absolute_percentage_error_update,
)


class MeanSquaredError(Metric):
    """MSE, or RMSE with ``squared=False``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanSquaredError
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> mse = MeanSquaredError(device="cpu")
        >>> mse.update(preds, target)
        >>> round(float(mse.compute()), 4)
        0.375
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, squared: bool = True, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.squared = squared
        self.num_outputs = num_outputs
        shape = (num_outputs,) if num_outputs > 1 else ()
        self.add_state("sum_squared_error", default=torch.zeros(shape), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        sum_squared_error, n_obs = _mean_squared_error_update(preds, target, self.num_outputs)
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.total = self.total + n_obs

    def compute(self) -> Tensor:
        return _mean_squared_error_compute(self.sum_squared_error, self.total, squared=self.squared)


class MeanAbsoluteError(Metric):
    """MAE.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanAbsoluteError
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> mae = MeanAbsoluteError(device="cpu")
        >>> mae.update(preds, target)
        >>> round(float(mae.compute()), 4)
        0.5
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        sum_abs_error, n_obs = _mean_absolute_error_update(preds, target)
        self.sum_abs_error = self.sum_abs_error + sum_abs_error
        self.total = self.total + n_obs

    def compute(self) -> Tensor:
        return _mean_absolute_error_compute(self.sum_abs_error, self.total)


class MeanSquaredLogError(Metric):
    """MSLE.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanSquaredLogError
        >>> target = torch.tensor([2.5, 5.0, 4.0, 8.0])
        >>> preds = torch.tensor([3.0, 5.0, 2.5, 7.0])
        >>> msle = MeanSquaredLogError(device="cpu")
        >>> msle.update(preds, target)
        >>> round(float(msle.compute()), 4)
        0.0397
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_squared_log_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        sum_squared_log_error, n_obs = _mean_squared_log_error_update(preds, target)
        self.sum_squared_log_error = self.sum_squared_log_error + sum_squared_log_error
        self.total = self.total + n_obs

    def compute(self) -> Tensor:
        return _mean_squared_log_error_compute(self.sum_squared_log_error, self.total)


class MeanAbsolutePercentageError(Metric):
    """MAPE.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanAbsolutePercentageError
        >>> target = torch.tensor([1.0, 10.0, 1e6])
        >>> preds = torch.tensor([0.9, 15.0, 1.2e6])
        >>> mape = MeanAbsolutePercentageError(device="cpu")
        >>> mape.update(preds, target)
        >>> round(float(mape.compute()), 4)
        0.2667
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_per_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        sum_abs_per_error, num_obs = _mean_absolute_percentage_error_update(preds, target)
        self.sum_abs_per_error = self.sum_abs_per_error + sum_abs_per_error
        self.total = self.total + num_obs

    def compute(self) -> Tensor:
        return _mean_absolute_percentage_error_compute(self.sum_abs_per_error, self.total)


class SymmetricMeanAbsolutePercentageError(Metric):
    """SMAPE.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SymmetricMeanAbsolutePercentageError
        >>> preds = torch.tensor([0.0, 1.0, 2.0, 3.0])
        >>> target = torch.tensor([0.5, 1.0, 2.5, 3.0])
        >>> smape = SymmetricMeanAbsolutePercentageError(device="cpu")
        >>> smape.update(preds, target)
        >>> round(float(smape.compute()), 4)
        0.5556
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_per_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        sum_abs_per_error, num_obs = _symmetric_mean_absolute_percentage_error_update(preds, target)
        self.sum_abs_per_error = self.sum_abs_per_error + sum_abs_per_error
        self.total = self.total + num_obs

    def compute(self) -> Tensor:
        return self.sum_abs_per_error / self.total


class WeightedMeanAbsolutePercentageError(Metric):
    """WMAPE.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import WeightedMeanAbsolutePercentageError
        >>> preds = torch.tensor([0.0, 1.0, 2.0, 3.0])
        >>> target = torch.tensor([0.5, 1.0, 2.5, 3.0])
        >>> wmape = WeightedMeanAbsolutePercentageError(device="cpu")
        >>> wmape.update(preds, target)
        >>> round(float(wmape.compute()), 4)
        0.1429
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("sum_scale", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        sum_abs_error, sum_scale = _weighted_mean_absolute_percentage_error_update(preds, target)
        self.sum_abs_error = self.sum_abs_error + sum_abs_error
        self.sum_scale = self.sum_scale + sum_scale

    def compute(self) -> Tensor:
        return _weighted_mean_absolute_percentage_error_compute(self.sum_abs_error, self.sum_scale)
