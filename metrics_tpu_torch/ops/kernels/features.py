"""pow2-bucketed batched feature extraction (Inception, LPIPS): torch code,
not a kernel (counterpart of ``metrics_tpu/ops/kernels/features.py``).

An inference feature extractor is row-independent: the feature row of image
``i`` does not depend on the other images of the batch. So a ragged stream
of update batches can be padded with zero rows to the next power of two and
sliced back, and the forward sees at most log2(N) batch sizes. Networks
assert the contract with ``row_independent = True``; a callable carrying
``row_independent = False`` is never wrapped.

While the compiled engines probe or capture a step (``utils.checks.
_capturing``) the wrapper passes the batch through as it is: the engine owns
shape bucketing there, as a JAX tracer does. Every forward the wrapper
dispatches is recorded in the heavy-kernel registry as the JAX wrapper
records it (``feature_extract``, ``impl="torch"``, ``bucket_width`` the pow2
bucket); :func:`feature_extract_counts` reads those series since the last
:func:`reset_feature_extract_counts`.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from metrics_tpu_torch.observability.instruments import REGISTRY
from metrics_tpu_torch.ops import kernels as _kernels
from metrics_tpu_torch.utils.checks import _capturing

__all__ = ["BucketedFeatureExtractor", "feature_extract_counts", "maybe_bucketed", "reset_feature_extract_counts"]

# the series' cumulative bucket counts when the counts were last reset
_BASELINE: List[int] = []


def _width_counts() -> Tuple[int, ...]:
    """The cumulative counts of ``feature_extract``'s bucket-width
    histogram, the total last (0s before its first dispatch; nothing is
    registered here)."""
    counts = {s.labels["le"]: int(s.value) for s in REGISTRY.samples()
              if s.name == "metrics_tpu_heavy_kernel_bucket_width_bucket" and s.labels.get("kernel") == "feature_extract"}
    return (*(counts.get(repr(le), 0) for le in _kernels._WIDTH_BUCKETS), counts.get("+Inf", 0))


def feature_extract_counts() -> Dict[str, Any]:
    """The forwards the wrappers dispatched since the last reset, and how many
    at each bucket width: a view of the registry's
    ``metrics_tpu_heavy_kernel_bucket_width{kernel="feature_extract"}``
    histogram (every width is a power of two, so each has a bucket of its
    own)."""
    now = _width_counts()
    base = _BASELINE or (0,) * len(now)
    if now[-1] < base[-1]:  # the registry was cleared since the reset
        base = (0,) * len(now)
    delta = [n - b for n, b in zip(now, base)]
    widths, below = {}, 0
    for le, cumulative in zip(_kernels._WIDTH_BUCKETS, delta[:-1]):
        if cumulative > below:
            widths[int(le)] = cumulative - below
        below = cumulative
    if delta[-1] > below:  # wider than the last bucket
        widths[float("inf")] = delta[-1] - below
    return {"forwards": delta[-1], "widths": widths}


def reset_feature_extract_counts() -> None:
    """Count from zero again (the registry's series keep their totals)."""
    _BASELINE[:] = _width_counts()


def _slice_back(out: Any, n: int, bucket: int) -> Any:
    if isinstance(out, torch.Tensor):
        return out[:n] if out.ndim >= 1 and out.shape[0] == bucket else out
    if isinstance(out, (list, tuple)):
        return type(out)(_slice_back(o, n, bucket) for o in out)
    if isinstance(out, dict):
        return {k: _slice_back(v, n, bucket) for k, v in out.items()}
    return out


class BucketedFeatureExtractor:
    """Pad batched inputs to the next pow2 bucket, run ``fn``, slice back.

    Transparent while an engine probes or captures and for batches already
    a power of two. Every positional tensor that shares the leading batch
    size is padded (LPIPS takes two image batches).
    """

    row_independent = True

    def __init__(self, fn: Callable, kernel: str = "feature_extract") -> None:
        self._fn = fn
        self._kernel = kernel
        self.__wrapped__ = fn

    def __getattr__(self, name: str) -> Any:
        # num_features and friends come from the wrapped extractor
        return getattr(self.__dict__["_fn"], name)

    def __call__(self, *arrays: Any) -> Any:
        if not arrays or _capturing():
            return self._fn(*arrays)
        first = arrays[0]
        if not isinstance(first, torch.Tensor) or first.ndim == 0:
            return self._fn(*arrays)
        n = first.shape[0]
        bucket = _kernels.next_pow2(n)
        if bucket == n:
            _kernels.dispatched(self._kernel, False, bucket)
            return self._fn(*arrays)
        padded = [
            torch.cat([a, a.new_zeros((bucket - n, *a.shape[1:]))])
            if isinstance(a, torch.Tensor) and a.ndim >= 1 and a.shape[0] == n else a
            for a in arrays
        ]
        out = self._fn(*padded)
        _kernels.dispatched(self._kernel, False, bucket)
        return _slice_back(out, n, bucket)


def maybe_bucketed(fn: Callable, enabled: bool) -> Callable:
    """``fn`` in a :class:`BucketedFeatureExtractor` when ``enabled`` and
    ``fn`` does not opt out with ``row_independent = False``."""
    if not enabled or fn is None:
        return fn
    if getattr(fn, "row_independent", True) is False:
        return fn
    if isinstance(fn, BucketedFeatureExtractor):
        return fn
    return BucketedFeatureExtractor(fn)
