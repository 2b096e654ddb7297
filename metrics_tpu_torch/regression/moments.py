"""Moment-state regression metrics: Pearson, Spearman, R2, ExplainedVariance
(counterpart of ``metrics_tpu/regression/moments.py``).

PearsonCorrCoef keeps its six running moments with ``dist_reduce_fx=None``:
a sync stacks every rank's moments on a leading axis, and ``compute()``
merges them with :func:`_final_aggregation` in rank order. Spearman keeps
its rows in ``cat`` states (lists, or buffers under ``buffer_capacity``).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.ops.regression.moments import (
    _explained_variance_compute,
    _explained_variance_update,
    _pearson_corrcoef_compute,
    _pearson_corrcoef_update,
    _r2_score_compute,
    _r2_score_update,
    _spearman_corrcoef_compute,
    _spearman_corrcoef_update,
)
from metrics_tpu_torch.utils.checks import _check_arg_choice
from metrics_tpu_torch.utils.data import append_cat, dim_zero_cat


def _final_aggregation(
    means_x: Tensor, means_y: Tensor, vars_x: Tensor, vars_y: Tensor, corrs_xy: Tensor, nbs: Tensor
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Merge per-rank running moments into global ones, pairwise in rank
    order (the loop runs once per rank)."""
    mx1, my1, vx1, vy1, cxy1, n1 = means_x[0], means_y[0], vars_x[0], vars_y[0], corrs_xy[0], nbs[0]
    for i in range(1, len(means_x)):
        mx2, my2, vx2, vy2, cxy2, n2 = means_x[i], means_y[i], vars_x[i], vars_y[i], corrs_xy[i], nbs[i]
        nb = n1 + n2
        mean_x = (n1 * mx1 + n2 * mx2) / nb
        mean_y = (n1 * my1 + n2 * my2) / nb

        element_x1 = (n1 + 1) * mean_x - n1 * mx1
        vx1 = vx1 + (element_x1 - mx1) * (element_x1 - mean_x) - (element_x1 - mean_x) ** 2
        element_x2 = (n2 + 1) * mean_x - n2 * mx2
        vx2 = vx2 + (element_x2 - mx2) * (element_x2 - mean_x) - (element_x2 - mean_x) ** 2
        var_x = vx1 + vx2

        element_y1 = (n1 + 1) * mean_y - n1 * my1
        vy1 = vy1 + (element_y1 - my1) * (element_y1 - mean_y) - (element_y1 - mean_y) ** 2
        element_y2 = (n2 + 1) * mean_y - n2 * my2
        vy2 = vy2 + (element_y2 - my2) * (element_y2 - mean_y) - (element_y2 - mean_y) ** 2
        var_y = vy1 + vy2

        cxy1 = cxy1 + (element_x1 - mx1) * (element_y1 - mean_y) - (element_x1 - mean_x) * (element_y1 - mean_y)
        cxy2 = cxy2 + (element_x2 - mx2) * (element_y2 - mean_y) - (element_x2 - mean_x) * (element_y2 - mean_y)
        corr_xy = cxy1 + cxy2

        mx1, my1, vx1, vy1, cxy1, n1 = mean_x, mean_y, var_x, var_y, corr_xy, nb
    return vx1, vy1, cxy1, n1


class PearsonCorrCoef(Metric):
    """Pearson correlation from running moments.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import PearsonCorrCoef
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> pearson = PearsonCorrCoef(device="cpu")
        >>> pearson.update(preds, target)
        >>> round(float(pearson.compute()), 4)
        0.9849
    """

    is_differentiable = True
    higher_is_better = None
    full_state_update = True

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        # None: the ranks' moments are stacked and merged by _final_aggregation
        # (a sum would be wrong for means and co-moments)
        for name in ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total"):
            self.add_state(name, default=torch.tensor(0.0), dist_reduce_fx=None)

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total = _pearson_corrcoef_update(
            preds, target, self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total
        )

    def compute(self) -> Tensor:
        if self.mean_x.numel() > 1:  # stacked by a sync of several ranks
            var_x, var_y, corr_xy, n_total = _final_aggregation(
                self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total
            )
        else:
            var_x, var_y, corr_xy, n_total = self.var_x, self.var_y, self.corr_xy, self.n_total
        return _pearson_corrcoef_compute(var_x, var_y, corr_xy, n_total)


class SpearmanCorrCoef(Metric):
    """Spearman rank correlation over every row seen.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SpearmanCorrCoef
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> spearman = SpearmanCorrCoef(device="cpu")
        >>> spearman.update(preds, target)
        >>> round(float(spearman.compute()), 4)
        1.0
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        preds, target = _spearman_corrcoef_update(preds, target)
        self.preds = append_cat(self.preds, preds)
        self.target = append_cat(self.target, target)

    def compute(self) -> Tensor:
        return _spearman_corrcoef_compute(dim_zero_cat(self.preds), dim_zero_cat(self.target))


class R2Score(Metric):
    """R², optionally adjusted, over one or several outputs.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import R2Score
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> r2 = R2Score(device="cpu")
        >>> r2.update(preds, target)
        >>> round(float(r2.compute()), 4)
        0.9486
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(self, num_outputs: int = 1, adjusted: int = 0, multioutput: str = "uniform_average", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_outputs = num_outputs
        if adjusted < 0 or not isinstance(adjusted, int):
            raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")
        self.adjusted = adjusted
        _check_arg_choice(multioutput, "multioutput", ("raw_values", "uniform_average", "variance_weighted"))
        self.multioutput = multioutput

        shape = (num_outputs,) if num_outputs > 1 else ()
        self.add_state("sum_squared_error", default=torch.zeros(shape), dist_reduce_fx="sum")
        self.add_state("sum_error", default=torch.zeros(shape), dist_reduce_fx="sum")
        self.add_state("residual", default=torch.zeros(shape), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        sum_squared_obs, sum_obs, rss, n_obs = _r2_score_update(preds, target)
        self.sum_squared_error = self.sum_squared_error + sum_squared_obs
        self.sum_error = self.sum_error + sum_obs
        self.residual = self.residual + rss
        self.total = self.total + n_obs

    def compute(self) -> Tensor:
        return _r2_score_compute(
            self.sum_squared_error, self.sum_error, self.residual, self.total, self.adjusted, self.multioutput
        )


class ExplainedVariance(Metric):
    """Explained variance over one or several outputs.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ExplainedVariance
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> ev = ExplainedVariance(device="cpu")
        >>> ev.update(preds, target)
        >>> round(float(ev.compute()), 4)
        0.9572
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(self, multioutput: str = "uniform_average", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_arg_choice(multioutput, "multioutput", ("raw_values", "uniform_average", "variance_weighted"))
        self.multioutput = multioutput
        self.add_state("sum_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("sum_squared_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("sum_target", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("sum_squared_target", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:  # type: ignore[override]
        n_obs, sum_error, sum_squared_error, sum_target, sum_squared_target = _explained_variance_update(preds, target)
        self.total = self.total + n_obs
        self.sum_error = self.sum_error + sum_error
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.sum_target = self.sum_target + sum_target
        self.sum_squared_target = self.sum_squared_target + sum_squared_target

    def compute(self) -> Tensor:
        return _explained_variance_compute(
            self.total, self.sum_error, self.sum_squared_error, self.sum_target, self.sum_squared_target, self.multioutput
        )
