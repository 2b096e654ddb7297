"""Deterministic log-bucketed quantile sketch (counterpart of
``metrics_tpu/sketches/quantile.py``, DDSketch lineage).

Integer bucket counts merged by ``+``, min/max trackers merged by
``min``/``max``: a commutative monoid, so ranks are exact and only the value
returned for a rank is approximate, within ``relative_accuracy``. For
``gamma = relative_accuracy`` and ``ratio = (1+g)/(1-g)``, a magnitude maps to
bucket ``floor(log(|x|/min_magnitude) / log(ratio))``; positives and negatives
have their own buckets, ``|x| < min_magnitude`` counts as zero, and
out-of-range magnitudes clip to the edge buckets.

The bucket index is float32 ``log`` in the JAX package's expression order,
with the divisors as device tensors (a CUDA division by a host scalar
multiplies by its reciprocal, which rounds differently). XLA's, torch's CPU
and CUDA's ``log`` may still differ by an ulp, so a value within an ulp of a
bucket boundary can land one bucket over; the tests count such values.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.sketches.base import MergeableSketch, _device, as_input, device_constant, register_sketch

__all__ = ["QuantileSketch"]


@register_sketch
class QuantileSketch(MergeableSketch):
    """Fixed-size mergeable quantile sketch over a float stream.

    Args:
        num_buckets: log-spaced buckets per sign (state is ``2*num_buckets``
            int32 counters plus four scalars).
        relative_accuracy: ``gamma``; returned quantile values satisfy
            ``|q_hat - q_true| <= gamma * |q_true|`` for in-range data.
        min_magnitude: values below this magnitude count as zero.
        device: where the components live (CUDA unless another is named).
    """

    sketch_fields = (
        ("pos", "sum"),
        ("neg", "sum"),
        ("zero", "sum"),
        ("count", "sum"),
        ("vmin", "min"),
        ("vmax", "max"),
    )
    config_attrs = ("num_buckets", "relative_accuracy", "min_magnitude")

    def __init__(
        self,
        num_buckets: int = 2048,
        relative_accuracy: float = 0.01,
        min_magnitude: float = 1e-8,
        device: Optional[Union[str, torch.device]] = None,
    ):
        if not 0.0 < relative_accuracy < 1.0:
            raise ValueError("relative_accuracy must be in (0, 1)")
        if num_buckets < 2:
            raise ValueError("num_buckets must be >= 2")
        self.num_buckets = int(num_buckets)
        self.relative_accuracy = float(relative_accuracy)
        self.min_magnitude = float(min_magnitude)
        for fname, value in self.fresh(_device(device)).items():
            setattr(self, fname, value)

    # ------------------------------------------------------------------ #
    def fresh(self, device: Optional[torch.device] = None) -> Dict[str, Tensor]:
        b, dev = self.num_buckets, _device(device)
        return {
            "pos": torch.zeros((b,), dtype=torch.int32, device=dev),
            "neg": torch.zeros((b,), dtype=torch.int32, device=dev),
            "zero": torch.zeros((), dtype=torch.int32, device=dev),
            "count": torch.zeros((), dtype=torch.int32, device=dev),
            "vmin": torch.full((), math.inf, dtype=torch.float32, device=dev),
            "vmax": torch.full((), -math.inf, dtype=torch.float32, device=dev),
        }

    @property
    def _log_ratio(self) -> float:
        g = self.relative_accuracy
        return math.log((1.0 + g) / (1.0 - g))

    # ------------------------------------------------------------------ #
    def bucket_index(self, x: Tensor) -> Tensor:
        """(n,) int64 bucket of each float32 value's magnitude, as
        :meth:`insert` computes it (an entry that is not finite gets 0; its
        increment is 0 anyway)."""
        min_mag = torch.full((), self.min_magnitude, dtype=torch.float32, device=x.device)
        log_ratio = torch.full((), self._log_ratio, dtype=torch.float32, device=x.device)
        idx = torch.floor(torch.log(torch.maximum(torch.abs(x), min_mag) / min_mag) / log_ratio)
        return torch.nan_to_num(idx, nan=0.0, posinf=0.0, neginf=0.0).clamp(0, self.num_buckets - 1).to(torch.int64)

    def insert(self, values: Any) -> "QuantileSketch":
        """Pure insert of a batch; non-finite entries are dropped."""
        dev = self.pos.device
        x = as_input(values, dev).reshape(-1).to(torch.float32)
        if x.numel() == 0:
            return self
        finite = torch.isfinite(x)
        small = torch.abs(x) < torch.full((), self.min_magnitude, dtype=torch.float32, device=dev)
        idx = self.bucket_index(x)
        is_pos = (finite & ~small & (x > 0)).to(torch.int32)
        is_neg = (finite & ~small & (x < 0)).to(torch.int32)
        is_zero = (finite & small).to(torch.int32)
        return self.replace(
            pos=self.pos.index_add(0, idx, is_pos),
            neg=self.neg.index_add(0, idx, is_neg),
            zero=self.zero + torch.sum(is_zero, dtype=torch.int32),
            count=self.count + torch.sum(finite, dtype=torch.int32),
            vmin=torch.minimum(self.vmin, torch.amin(torch.where(finite, x, math.inf))),
            vmax=torch.maximum(self.vmax, torch.amax(torch.where(finite, x, -math.inf))),
        )

    def _representatives(self) -> Tensor:
        """Value axis for the ordered cdf: most-negative .. zero .. most-
        positive, geometric bucket midpoints (float64 on the host, then
        float32, as in the JAX package)."""
        b = self.num_buckets
        mids = self.min_magnitude * np.exp((np.arange(b, dtype=np.float64) + 0.5) * self._log_ratio)
        reps = np.concatenate([-mids[::-1], [0.0], mids]).astype(np.float32)
        return device_constant(reps, torch.float32, self.pos.device)

    def _ordered_counts(self) -> Tensor:
        """Counts aligned with ``_representatives`` (length 2B+1)."""
        return torch.cat([torch.flip(self.neg, (0,)), self.zero[None], self.pos]).to(torch.int32)

    def quantile(self, q: Any) -> Tensor:
        """Nearest-rank quantile(s); NaN when the sketch is empty.

        ``q`` is a probability or a sequence of them in [0, 1] (Python
        numbers, made into a device constant once), or a float32 tensor.
        """
        dev = self.pos.device
        if isinstance(q, Tensor):
            q = as_input(q, dev).to(torch.float32)
        else:
            q = device_constant(np.asarray(q, dtype=np.float32), torch.float32, dev)
        cdf = torch.cumsum(self._ordered_counts(), dim=0, dtype=torch.int32)
        total = cdf[-1]
        # nearest-rank (1-based): rank = ceil(q * total), clipped into range
        rank = torch.clamp(torch.ceil(q * total.to(torch.float32)), min=1.0)
        k = torch.searchsorted(cdf, rank.to(torch.int32), side="left")
        v = self._representatives()[torch.clamp(k, 0, 2 * self.num_buckets)]
        v = torch.minimum(torch.maximum(v, self.vmin), self.vmax)
        return torch.where(total > 0, v, math.nan)

    def error_bound(self) -> Dict[str, Any]:
        ratio = (1.0 + self.relative_accuracy) / (1.0 - self.relative_accuracy)
        return {
            "kind": "relative_value_error",
            "value": self.relative_accuracy,
            "rank_exact": True,
            "range": (self.min_magnitude, self.min_magnitude * ratio ** self.num_buckets),
        }
