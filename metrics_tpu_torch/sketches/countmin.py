"""Count-min frequency sketch and the dyadic heavy-hitters hierarchy
(counterpart of ``metrics_tpu/sketches/countmin.py``).

``CountMinSketch`` keeps a ``(depth, width)`` int32 counter grid, sum-merged;
a point query overestimates by at most ``2N/width`` with probability
``1 - 2**-depth``. Row ``r`` hashes ``fmix32(key ^ seed_r)`` with the JAX
package's seed schedule; ``width`` is a power of two, so the slot is a mask.

``DyadicCountMinSketch`` stacks one count-min per dyadic level of a bounded
integer key domain, so heavy hitters are found by a host descent over
prefixes (``heavy_hitters``); the insert stays capturable. Each level's
counts go in with one int32 ``index_add_`` through the flattened
``row * width + slot`` index: never summed into int64.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.sketches.base import MergeableSketch, _device, as_input, device_constant, register_sketch
from metrics_tpu_torch.sketches.hll import MASK32, canonical_u32, fmix32

__all__ = ["CountMinSketch", "DyadicCountMinSketch"]

# fixed per-row seed schedule (golden-ratio odd constants; the level folds in)
_SEED0 = 0x9E3779B1


def _row_seeds(depth: int, level: int = 0) -> np.ndarray:
    return np.asarray(
        [(_SEED0 * (2 * r + 1) + 0x7F4A7C15 * level) & 0xFFFFFFFF for r in range(depth)],
        dtype=np.uint32,
    )


def _weights(keys: Tensor, weights: Any) -> Tensor:
    """int32 weight per key: 1 each by default, else ``weights`` flattened
    and broadcast to the keys."""
    if weights is None:
        return torch.ones(keys.shape, dtype=torch.int32, device=keys.device)
    w = as_input(weights, keys.device).reshape(-1).to(torch.int32)
    return torch.broadcast_to(w, keys.shape)


def _slots(keys: Tensor, seeds: np.ndarray, width: int) -> Tensor:
    """(depth, n) int64 slot indices of uint32 keys (carried in int64)."""
    s = device_constant(seeds.astype(np.int64), torch.int64, keys.device)
    return fmix32(keys[None, :] ^ s[:, None]) & (width - 1)


def _add_rows(counts: Tensor, slots: Tensor, w: Tensor) -> Tensor:
    """``counts`` (depth, width) int32 with ``w`` added at each row's slots:
    one int32 ``index_add`` over the flattened grid."""
    depth, width = counts.shape
    rows = torch.arange(depth, device=counts.device)[:, None] * width
    flat = (rows + slots).reshape(-1)
    src = torch.broadcast_to(w[None, :], slots.shape).reshape(-1)
    return counts.reshape(-1).index_add(0, flat, src).reshape(depth, width)


@register_sketch
class CountMinSketch(MergeableSketch):
    """Fixed-size mergeable frequency sketch over integer/float keys.

    Args:
        width: slots per row (power of two).
        depth: independent hash rows.
        device: where the counters live (CUDA unless another is named).
    """

    sketch_fields = (("counts", "sum"), ("total", "sum"))
    config_attrs = ("width", "depth")

    def __init__(self, width: int = 2048, depth: int = 4, device: Optional[Union[str, torch.device]] = None):
        width, depth = int(width), int(depth)
        if width < 2 or width & (width - 1):
            raise ValueError("width must be a power of two >= 2")
        if not 1 <= depth <= 16:
            raise ValueError("depth must be in [1, 16]")
        self.width = width
        self.depth = depth
        dev = _device(device)
        self.counts = torch.zeros((depth, width), dtype=torch.int32, device=dev)
        self.total = torch.zeros((), dtype=torch.int32, device=dev)

    # ------------------------------------------------------------------ #
    def insert(self, keys: Any, weights: Any = None) -> "CountMinSketch":
        """Pure insert; ``weights`` defaults to 1 per key (int32)."""
        k = canonical_u32(keys, self.counts.device)
        if k.numel() == 0:
            return self
        w = _weights(k, weights)
        counts = _add_rows(self.counts, _slots(k, _row_seeds(self.depth), self.width), w)
        return self.replace(counts=counts, total=self.total + torch.sum(w, dtype=torch.int32))

    def query(self, keys: Any) -> Tensor:
        """Estimated counts (int32, one per key); never understates."""
        k = canonical_u32(keys, self.counts.device)
        slots = _slots(k, _row_seeds(self.depth), self.width)
        rows = torch.arange(self.depth, device=k.device)[:, None]
        return torch.amin(self.counts[rows, slots], dim=0)

    def error_bound(self) -> Dict[str, Any]:
        return {
            "kind": "additive_count_error",
            "value": 2.0 / self.width,  # x total inserted weight
            "confidence": 1.0 - 2.0 ** (-self.depth),
            "one_sided": True,
        }


@register_sketch
class DyadicCountMinSketch(MergeableSketch):
    """Dyadic count-min hierarchy over a bounded integer key domain.

    Args:
        domain_bits: keys live in ``[0, 2**domain_bits)`` (wider inputs are
            masked); one count-min level per bit enables heavy-hitter descent.
        width / depth: per-level count-min shape.
        device: where the counters live (CUDA unless another is named).
    """

    sketch_fields = (("counts", "sum"), ("total", "sum"))
    config_attrs = ("domain_bits", "width", "depth")

    def __init__(
        self, domain_bits: int = 16, width: int = 1024, depth: int = 4,
        device: Optional[Union[str, torch.device]] = None,
    ):
        domain_bits, width, depth = int(domain_bits), int(width), int(depth)
        if not 1 <= domain_bits <= 28:
            raise ValueError("domain_bits must be in [1, 28]")
        if width < 2 or width & (width - 1):
            raise ValueError("width must be a power of two >= 2")
        if not 1 <= depth <= 16:
            raise ValueError("depth must be in [1, 16]")
        self.domain_bits = domain_bits
        self.width = width
        self.depth = depth
        dev = _device(device)
        self.counts = torch.zeros((domain_bits, depth, width), dtype=torch.int32, device=dev)
        self.total = torch.zeros((), dtype=torch.int32, device=dev)

    # ------------------------------------------------------------------ #
    def insert(self, keys: Any, weights: Any = None) -> "DyadicCountMinSketch":
        """Pure insert of integer keys (masked into the domain)."""
        k = canonical_u32(keys, self.counts.device) & ((1 << self.domain_bits) - 1)
        if k.numel() == 0:
            return self
        w = _weights(k, weights)
        # level l holds prefixes of length l+1 (level domain_bits-1 = full keys)
        levels = [
            _add_rows(self.counts[level], _slots(k >> (self.domain_bits - 1 - level),
                                                 _row_seeds(self.depth, level + 1), self.width), w)
            for level in range(self.domain_bits)
        ]
        return self.replace(counts=torch.stack(levels), total=self.total + torch.sum(w, dtype=torch.int32))

    def _prefix_count(self, counts: np.ndarray, level: int, prefix: int) -> int:
        seeds = _row_seeds(self.depth, level + 1)
        est = None
        for r in range(self.depth):
            h = (int(prefix) ^ int(seeds[r])) & MASK32
            h ^= h >> 16
            h = (h * 0x85EBCA6B) & MASK32
            h ^= h >> 13
            h = (h * 0xC2B2AE35) & MASK32
            h ^= h >> 16
            c = int(counts[level, r, h & (self.width - 1)])
            est = c if est is None else min(est, c)
        return int(est)

    def heavy_hitters(self, threshold: float = 0.01, max_hitters: int = 16) -> Tuple[np.ndarray, np.ndarray]:
        """Keys whose estimated frequency is ``>= threshold * total``.

        A host-side dyadic descent (one copy of the counters to the host).
        Returns ``(keys, counts)`` as int64 numpy arrays sorted by
        descending count, padded with ``-1`` / ``0`` up to ``max_hitters``.
        """
        counts = self.counts.cpu().numpy()
        total = int(self.total)
        keys: List[Tuple[int, int]] = []
        if total > 0:
            cut = max(1, int(np.ceil(threshold * total)))
            frontier = [(0, 0), (0, 1)]  # (level, prefix)
            while frontier:
                level, prefix = frontier.pop()
                est = self._prefix_count(counts, level, prefix)
                if est < cut:
                    continue
                if level == self.domain_bits - 1:
                    keys.append((prefix, est))
                else:
                    frontier.append((level + 1, prefix << 1))
                    frontier.append((level + 1, (prefix << 1) | 1))
        keys.sort(key=lambda kv: (-kv[1], kv[0]))
        keys = keys[:max_hitters]
        out_k = np.full((max_hitters,), -1, dtype=np.int64)
        out_c = np.zeros((max_hitters,), dtype=np.int64)
        for i, (kk, cc) in enumerate(keys):
            out_k[i] = kk
            out_c[i] = cc
        return out_k, out_c

    def error_bound(self) -> Dict[str, Any]:
        return {
            "kind": "additive_count_error",
            "value": 2.0 / self.width,
            "confidence": 1.0 - 2.0 ** (-self.depth),
            "one_sided": True,
            "levels": self.domain_bits,
        }
