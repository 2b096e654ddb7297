"""Per-output metric clones (counterpart of ``metrics_tpu/wrappers/multioutput.py``)."""
from __future__ import annotations

from copy import deepcopy
from typing import Any, List, Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.utils.data import apply_to_collection


def _get_nan_indices(*tensors: Tensor) -> Tensor:
    """(N,) bool: the rows where any of ``tensors`` holds a NaN."""
    if len(tensors) == 0:
        raise ValueError("Must pass at least one tensor as argument")
    sentinel = tensors[0]
    nan_idxs = torch.zeros(len(sentinel), dtype=torch.bool, device=sentinel.device)
    for tensor in tensors:
        nan_idxs = nan_idxs | torch.isnan(tensor.reshape(len(sentinel), -1)).any(dim=1)
    return nan_idxs


class MultioutputWrapper(Metric):
    """One clone of a base metric per output along ``output_dim``.

    With ``remove_nans`` the rows where any input of an output holds a NaN
    are dropped before that output's update; which rows survive is read back
    to the host (one read per output and update), so the wrapper runs eager.
    It lives on its base metric's device unless ``device`` says otherwise.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanSquaredError, MultioutputWrapper
        >>> target = torch.tensor([[1.0, 10.0], [2.0, 20.0]])
        >>> preds = torch.tensor([[1.0, 11.0], [2.0, 22.0]])
        >>> mse = MultioutputWrapper(MeanSquaredError(device="cpu"), num_outputs=2)
        >>> mse.update(preds, target)
        >>> [round(float(v), 2) for v in mse.compute()]
        [0.0, 2.5]
    """

    is_differentiable = False

    def __init__(
        self,
        base_metric: Metric,
        num_outputs: int,
        output_dim: int = -1,
        remove_nans: bool = True,
        squeeze_outputs: bool = True,
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("device", base_metric.device)
        super().__init__(**kwargs)
        self.metrics = [deepcopy(base_metric) for _ in range(num_outputs)]
        self.output_dim = output_dim
        self.remove_nans = remove_nans
        self.squeeze_outputs = squeeze_outputs

    def _get_args_kwargs_by_output(self, *args: Tensor, **kwargs: Tensor) -> List[Tuple]:
        """Each output's column of every tensor input, NaN rows dropped and
        the output axis squeezed as configured."""
        args_kwargs_by_output = []
        for i in range(len(self.metrics)):
            selected_args = apply_to_collection(args, Tensor, lambda t: t.narrow(self.output_dim, i, 1))
            selected_kwargs = apply_to_collection(kwargs, Tensor, lambda t: t.narrow(self.output_dim, i, 1))
            if self.remove_nans:
                tensors = [t for t in list(selected_args) + list(selected_kwargs.values()) if isinstance(t, Tensor)]
                if tensors:
                    keep = torch.nonzero(~_get_nan_indices(*tensors)).squeeze(1)  # the one read to the host
                    selected_args = [t.index_select(0, keep) if isinstance(t, Tensor) else t for t in selected_args]
                    selected_kwargs = {
                        k: (t.index_select(0, keep) if isinstance(t, Tensor) else t) for k, t in selected_kwargs.items()
                    }
            if self.squeeze_outputs:
                selected_args = [t.squeeze(self.output_dim) if isinstance(t, Tensor) else t for t in selected_args]
                selected_kwargs = {
                    k: (t.squeeze(self.output_dim) if isinstance(t, Tensor) else t) for k, t in selected_kwargs.items()
                }
            args_kwargs_by_output.append((selected_args, selected_kwargs))
        return args_kwargs_by_output

    def update(self, *args: Any, **kwargs: Any) -> None:  # type: ignore[override]
        reshaped = self._get_args_kwargs_by_output(*args, **kwargs)
        for metric, (selected_args, selected_kwargs) in zip(self.metrics, reshaped):
            metric.update(*selected_args, **selected_kwargs)

    def compute(self) -> Tensor:
        return torch.stack([torch.as_tensor(m.compute()) for m in self.metrics], dim=0)

    def forward(self, *args: Any, **kwargs: Any) -> Optional[Tensor]:
        # the per-output forwards advance the clones: drop the wrapper's cache
        self._computed = None
        self._update_count += 1
        reshaped = self._get_args_kwargs_by_output(*args, **kwargs)
        results = [
            metric(*selected_args, **selected_kwargs)
            for metric, (selected_args, selected_kwargs) in zip(self.metrics, reshaped)
        ]
        if any(r is None for r in results):
            self._forward_cache = None
            return None
        self._forward_cache = torch.stack([torch.as_tensor(r) for r in results], dim=0)
        return self._forward_cache

    def reset(self) -> None:
        super().reset()
        for m in self.metrics:
            m.reset()
