"""Aggregators with a NaN strategy: SumMetric, MeanMetric, MaxMetric,
MinMetric and CatMetric, and the sketch aggregators Quantile, Median,
DistinctCount and HeavyHitters (counterpart of ``metrics_tpu/aggregation.py``).

NaNs are masked, not filtered: a masked entry takes the reduction's identity
and weight 0, so every update keeps static shapes and is captured. The
strategy's raise, warning and CatMetric's row filter read a value back, so
they run where the JAX package's ``_is_concrete`` holds: eager, not in a
captured step (``utils.checks._capturing``). A captured CatMetric therefore
keeps a NaN row with the imputed 0.0 where an eager one drops it, as the JAX
package's compiled and eager updates do.

The sketch aggregators keep a fixed-size
:class:`~metrics_tpu_torch.sketches.MergeableSketch` state under the
``"sketch"`` reduction tag, whatever the stream's length; their inserts are
captured like any other update. CatMetric's buffer is shardable along the
sample axis (``shard_state``); its sharded compute gathers the blocks as its
result.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.core.buffers import CatBuffer, ShardedCatBuffer
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.sketches import DyadicCountMinSketch, HyperLogLogSketch, QuantileSketch
from metrics_tpu_torch.utils.checks import _capturing
from metrics_tpu_torch.utils.data import append_cat, dim_zero_cat
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _as_float32(x: Union[float, Tensor, np.ndarray, List], device: torch.device) -> Tensor:
    """``jnp.asarray(x, float32)``; a Python number becomes a fill on the
    device (no host-to-device copy inside a captured step)."""
    if isinstance(x, Tensor):
        return x.to(torch.float32)
    if isinstance(x, (int, float)):
        return torch.full((), float(x), dtype=torch.float32, device=device)
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


class BaseAggregator(Metric):
    """Base of the simple aggregators: one ``value`` state and a NaN strategy,
    ``"error"``, ``"warn"``, ``"ignore"`` or a float to impute."""

    value: Union[Tensor, List[Tensor], CatBuffer]
    is_differentiable = None
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        fn: str,
        default_value: Union[Tensor, List],
        nan_strategy: Union[str, float] = "error",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        allowed_nan_strategy = ("error", "warn", "ignore")
        if nan_strategy not in allowed_nan_strategy and not isinstance(nan_strategy, float):
            raise ValueError(
                f"Arg `nan_strategy` should either be a float or one of {allowed_nan_strategy} but got {nan_strategy}."
            )
        self.nan_strategy = nan_strategy
        # a list aggregator (CatMetric) becomes a buffer under buffer_capacity,
        # shardable along the sample axis; the dense running aggregates stay
        # replicated
        shard_axis = 0 if isinstance(default_value, list) and self.buffer_capacity is not None else None
        self.add_state("value", default=default_value, dist_reduce_fx=fn, shard_axis=shard_axis)

    def _cast_and_nan_check_input(
        self, x: Union[float, Tensor], weight: Union[float, Tensor, None] = None
    ) -> Tuple[Tensor, Tensor]:
        """Cast to float32 and apply the NaN strategy by masking: returns
        ``(x, weight)``, a NaN position with weight 0 and an imputed value."""
        x = _as_float32(x, self.device)
        weight = torch.ones_like(x) if weight is None else _as_float32(weight, x.device).expand(x.shape)
        nans = torch.isnan(x) | torch.isnan(weight)
        if self.nan_strategy == "error":
            if not _capturing() and bool(nans.any()):
                raise RuntimeError("Encountered `nan` values in tensor")
        elif self.nan_strategy in ("ignore", "warn"):
            if self.nan_strategy == "warn" and not _capturing() and bool(nans.any()):
                rank_zero_warn("Encountered `nan` values in tensor. Will be removed.", UserWarning)
            x = torch.where(nans, 0.0, x)
            weight = torch.where(nans, 0.0, weight)
        else:
            x = torch.where(nans, float(self.nan_strategy), x)
            weight = torch.where(torch.isnan(weight), float(self.nan_strategy), weight)
        return x, weight

    def update(self, value: Union[float, Tensor]) -> None:  # type: ignore[override]
        pass

    def compute(self) -> Tensor:
        return self.value


class MaxMetric(BaseAggregator):
    """Running maximum.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MaxMetric
        >>> metric = MaxMetric(device="cpu")
        >>> metric.update(1.0)
        >>> metric.update(torch.tensor([2.0, 3.0]))
        >>> float(metric.compute())
        3.0
    """

    full_state_update = True

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("max", torch.tensor(-torch.inf), nan_strategy, **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:  # type: ignore[override]
        value, weight = self._cast_and_nan_check_input(value)
        if value.numel():  # a masked entry has weight 0: -inf there
            masked = torch.where(weight > 0, value, -torch.inf)
            self.value = torch.maximum(self.value, masked.max())


class MinMetric(BaseAggregator):
    """Running minimum.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MinMetric
        >>> metric = MinMetric(device="cpu")
        >>> metric.update(torch.tensor([2.0, 1.0]))
        >>> metric.update(torch.tensor(3.0))
        >>> float(metric.compute())
        1.0
    """

    full_state_update = True

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("min", torch.tensor(torch.inf), nan_strategy, **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:  # type: ignore[override]
        value, weight = self._cast_and_nan_check_input(value)
        if value.numel():
            masked = torch.where(weight > 0, value, torch.inf)
            self.value = torch.minimum(self.value, masked.min())


class SumMetric(BaseAggregator):
    """Running sum.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SumMetric
        >>> metric = SumMetric(device="cpu")
        >>> metric.update(1.0)
        >>> metric.update(torch.tensor([2.0, 3.0]))
        >>> float(metric.compute())
        6.0
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("sum", torch.tensor(0.0), nan_strategy, **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:  # type: ignore[override]
        value, weight = self._cast_and_nan_check_input(value)
        if value.numel():
            self.value = self.value + torch.where(weight > 0, value, 0.0).sum()


class CatMetric(BaseAggregator):
    """Every value seen, concatenated; a ``buffer_capacity`` keeps them in a
    :class:`~metrics_tpu_torch.core.buffers.CatBuffer`, whose update is
    captured.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import CatMetric
        >>> metric = CatMetric(device="cpu")
        >>> metric.update(torch.tensor([1.0, 2.0]))
        >>> metric.update(torch.tensor(3.0))
        >>> metric.compute().tolist()
        [1.0, 2.0, 3.0]
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("cat", [], nan_strategy, **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:  # type: ignore[override]
        value, weight = self._cast_and_nan_check_input(value)
        if value.numel() and self.nan_strategy in ("ignore", "warn") and not _capturing():
            keep = weight > 0
            if not bool(keep.all()):
                value = torch.atleast_1d(value)[keep.reshape(-1)]
        if value.numel():
            self.value = append_cat(self.value, value)

    def compute(self) -> Tensor:
        if isinstance(self.value, CatBuffer):
            return self.value.to_array() if self.value else torch.zeros((0,), device=self.device)
        if isinstance(self.value, list) and self.value:
            return dim_zero_cat(self.value)
        return self.value

    def compute_sharded_state(self, state: Dict[str, Any], group: Any) -> Tensor:
        value = state["value"]
        if isinstance(value, ShardedCatBuffer):
            # the gather of the blocks is the result-sized collective here:
            # it ticks "all_gather", never "reshard"
            value = value.gather(group)
        return value.to_array() if value else torch.zeros((0,), device=self.device)


class MeanMetric(BaseAggregator):
    """Weighted running mean.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanMetric
        >>> mean = MeanMetric(device="cpu")
        >>> mean.update(1.0)
        >>> mean.update(torch.tensor([2.0, 3.0]))
        >>> round(float(mean.compute()), 4)
        2.0
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("sum", torch.tensor(0.0), nan_strategy, **kwargs)
        self.add_state("weight", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, value: Union[float, Tensor], weight: Union[float, Tensor] = 1.0) -> None:  # type: ignore[override]
        value, weight = self._cast_and_nan_check_input(value, weight)
        if value.numel() == 0:
            return
        self.value = self.value + (value * weight).sum()
        self.weight = self.weight + weight.sum()

    def compute(self) -> Tensor:
        return self.value / self.weight


# --------------------------------------------------------------------------- #
# sketch-backed aggregators: bounded-memory approximate metrics over
# unbounded streams. Each declares its sketch's error bound as the state's
# sync tolerance, as the JAX package does.
# --------------------------------------------------------------------------- #
class Quantile(Metric):
    """Streaming quantile(s) from a fixed-size mergeable sketch.

    Keeps a :class:`~metrics_tpu_torch.sketches.QuantileSketch` (about 40 KB
    at the defaults, whatever the stream's length); ranks are exact and the
    returned values carry a relative error of at most ``relative_accuracy``.

    Args:
        q: quantile(s) in [0, 1]: a scalar result for a scalar ``q``, a
            vector for a sequence.
        num_buckets / relative_accuracy / min_magnitude: the sketch's layout.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Quantile
        >>> metric = Quantile(q=0.5, device="cpu")
        >>> metric.update(torch.arange(1, 101, dtype=torch.float32))
        >>> round(float(metric.compute()), 1)
        49.9
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    sketch: QuantileSketch

    def __init__(
        self,
        q: Union[float, Sequence[float]] = 0.5,
        num_buckets: int = 2048,
        relative_accuracy: float = 0.01,
        min_magnitude: float = 1e-8,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self._scalar_q = not isinstance(q, (list, tuple))
        qs = (float(q),) if self._scalar_q else tuple(float(v) for v in q)
        if not qs or not all(0.0 <= v <= 1.0 for v in qs):
            raise ValueError(f"Expected argument `q` to be probabilities in [0, 1] but got {q}")
        self.q = qs
        self.add_state(
            "sketch",
            default=QuantileSketch(num_buckets=num_buckets, relative_accuracy=relative_accuracy,
                                   min_magnitude=min_magnitude, device=self.device),
            dist_reduce_fx="sketch",
            persistent=True,
            sync_tolerance=float(relative_accuracy),
        )

    def update(self, value: Union[float, Tensor]) -> None:  # type: ignore[override]
        self.sketch = self.sketch.insert(value)

    def compute(self) -> Tensor:
        out = self.sketch.quantile(self.q)
        return out[0] if self._scalar_q else out

    def error_bound(self) -> Dict[str, Any]:
        """The sketch's declared accuracy contract."""
        return self.sketch.error_bound()


class Median(Quantile):
    """Streaming median: :class:`Quantile` pinned at ``q=0.5``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Median
        >>> metric = Median(device="cpu")
        >>> metric.update(torch.tensor([1.0, 9.0, 2.0]))
        >>> round(float(metric.compute()), 2)
        1.99
    """

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(q=0.5, **kwargs)


class DistinctCount(Metric):
    """Approximate distinct count over a key stream (HyperLogLog).

    State is ``2**precision`` int32 registers merged by elementwise max;
    relative standard error ``1.04 / sqrt(2**precision)`` (about 1.6% at the
    default ``precision=12``, 16 KB).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import DistinctCount
        >>> metric = DistinctCount(device="cpu")
        >>> metric.update(torch.tensor([1, 2, 3, 2, 1]))
        >>> round(float(metric.compute()))
        3
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    sketch: HyperLogLogSketch

    def __init__(self, precision: int = 12, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        sk = HyperLogLogSketch(precision=precision, device=self.device)
        self.add_state(
            "sketch", default=sk, dist_reduce_fx="sketch", persistent=True,
            sync_tolerance=float(sk.error_bound()["value"]),
        )

    def update(self, value: Tensor) -> None:  # type: ignore[override]
        self.sketch = self.sketch.insert(value)

    def compute(self) -> Tensor:
        return self.sketch.estimate()

    def error_bound(self) -> Dict[str, Any]:
        """The sketch's declared accuracy contract."""
        return self.sketch.error_bound()


class HeavyHitters(Metric):
    """Keys above a frequency threshold, from a dyadic count-min hierarchy.

    ``compute()`` walks the dyadic tree on the host (a data-dependent
    descent), so the metric keeps off the compiled compute
    (``compiled_compute=False`` by default), as in the JAX package; the
    update is captured (one ``index_add`` per dyadic level).

    Returns ``{"keys": int32[max_hitters], "counts": int32[max_hitters]}``
    on the metric's device, sorted by descending estimated count and padded
    with ``-1`` / ``0`` (int32 as the JAX package returns them with 64-bit
    types off).

    Args:
        threshold: report keys with estimated frequency ``>= threshold *
            total`` (count-min never understates, so no true hitter is lost).
        max_hitters: fixed result length.
        domain_bits / width / depth: the sketch's shape.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import HeavyHitters
        >>> metric = HeavyHitters(threshold=0.4, max_hitters=2, device="cpu")
        >>> metric.update(torch.tensor([7, 7, 7, 5, 7]))
        >>> [int(k) for k in metric.compute()["keys"]]
        [7, -1]
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    sketch: DyadicCountMinSketch

    def __init__(
        self,
        threshold: float = 0.01,
        max_hitters: int = 16,
        domain_bits: int = 16,
        width: int = 1024,
        depth: int = 4,
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("compiled_compute", False)  # the host descent
        super().__init__(**kwargs)
        if not 0.0 < threshold <= 1.0:
            raise ValueError(f"Expected argument `threshold` in (0, 1] but got {threshold}")
        if max_hitters < 1:
            raise ValueError(f"Expected argument `max_hitters` to be >= 1 but got {max_hitters}")
        self.threshold = float(threshold)
        self.max_hitters = int(max_hitters)
        sk = DyadicCountMinSketch(domain_bits=domain_bits, width=width, depth=depth, device=self.device)
        self.add_state(
            "sketch", default=sk, dist_reduce_fx="sketch", persistent=True,
            sync_tolerance=float(sk.error_bound()["value"]),
        )

    def update(self, value: Tensor, weight: Optional[Tensor] = None) -> None:  # type: ignore[override]
        self.sketch = self.sketch.insert(value, weight)

    def compute(self) -> Dict[str, Tensor]:
        keys, counts = self.sketch.heavy_hitters(self.threshold, self.max_hitters)
        both = torch.from_numpy(np.stack([keys, counts]).astype(np.int32)).to(self.device)
        return {"keys": both[0], "counts": both[1]}

    def error_bound(self) -> Dict[str, Any]:
        """The sketch's declared accuracy contract."""
        return self.sketch.error_bound()
