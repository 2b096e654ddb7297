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
shape bucketing there, as a JAX tracer does. One plain counter keeps the
forwards this wrapper dispatched and their bucket widths
(:func:`feature_extract_counts`); the JAX package's dispatch telemetry is
not ported.
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Callable, Dict

import torch

from metrics_tpu_torch.ops import kernels as _kernels
from metrics_tpu_torch.utils.checks import _capturing

__all__ = ["BucketedFeatureExtractor", "feature_extract_counts", "maybe_bucketed", "reset_feature_extract_counts"]

_FORWARDS = Counter()  # bucket width -> forwards


def feature_extract_counts() -> Dict[str, Any]:
    """The forwards the wrappers dispatched, and how many at each bucket width."""
    return {"forwards": sum(_FORWARDS.values()), "widths": dict(sorted(_FORWARDS.items()))}


def reset_feature_extract_counts() -> None:
    _FORWARDS.clear()


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

    def __init__(self, fn: Callable) -> None:
        self._fn = fn
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
        _FORWARDS[bucket] += 1
        if bucket == n:
            return self._fn(*arrays)
        padded = [
            torch.cat([a, a.new_zeros((bucket - n, *a.shape[1:]))])
            if isinstance(a, torch.Tensor) and a.ndim >= 1 and a.shape[0] == n else a
            for a in arrays
        ]
        return _slice_back(self._fn(*padded), n, bucket)


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
