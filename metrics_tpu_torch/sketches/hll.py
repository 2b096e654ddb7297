"""HyperLogLog distinct-count sketch (counterpart of ``metrics_tpu/sketches/hll.py``).

State is ``m = 2**precision`` int32 registers merged by elementwise ``max``.
Keys are canonicalised to uint32 (integers modulo 2**32; floats through
their float32 bit pattern with ``-0.0`` folded into ``+0.0``) and mixed with
the murmur3 fmix32 finalizer; the top ``precision`` hash bits pick the
register, the leading-zero rank of the rest updates it.

torch has few uint32 kernels and shifts int32 arithmetically, so the port
carries every uint32 value in int64, in ``[0, 2**32)``: shifts are then
logical, and each multiply splits the value into 16-bit halves so that no
product leaves int64's range before it is masked back to 32 bits. The bits
are the JAX package's (held bit for bit in the tests).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.sketches.base import MergeableSketch, _device, as_input, register_sketch

__all__ = ["HyperLogLogSketch", "fmix32", "canonical_u32"]

MASK32 = 0xFFFFFFFF


def _mul32(h: Tensor, c: int) -> Tensor:
    """``(h * c) mod 2**32`` for int64 ``h`` in [0, 2**32) and a constant
    ``c`` < 2**32, with no intermediate beyond 2**49."""
    lo = (h & 0xFFFF) * c
    hi = ((h >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & MASK32


def fmix32(h: Tensor) -> Tensor:
    """murmur3 32-bit finalizer on uint32 values carried in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def canonical_u32(values: Any, device: Optional[torch.device] = None) -> Tensor:
    """Canonical uint32 key view (int64 in [0, 2**32)) of an int, bool or
    float array, flattened. Integers keep their low 32 bits (the JAX
    package truncates int64 keys to int32 first, which keeps the same bits);
    floats are rounded to float32 and bit-cast. With ``device``, a tensor
    on another device raises."""
    x = (torch.as_tensor(values) if device is None else as_input(values, device)).reshape(-1)
    if x.is_floating_point():
        xf = x.to(torch.float32)
        xf = torch.where(xf == 0.0, torch.zeros((), dtype=torch.float32, device=xf.device), xf)  # -0.0 -> +0.0
        return xf.view(torch.int32).to(torch.int64) & MASK32
    return x.to(torch.int64) & MASK32


def _clz32(h: Tensor) -> Tensor:
    """Leading zeros of each uint32 (32 for zero), int32: the exact
    shift chain of the JAX package."""
    n = torch.zeros(h.shape, dtype=torch.int32, device=h.device)
    for shift in (16, 8, 4, 2, 1):
        move = (h >> (32 - shift)) == 0
        n = n + move.to(torch.int32) * shift
        h = torch.where(move, (h << shift) & MASK32, h)
    return torch.where(h == 0, torch.full((), 32, dtype=torch.int32, device=h.device), n)


@register_sketch
class HyperLogLogSketch(MergeableSketch):
    """Fixed-size mergeable distinct-count sketch.

    Args:
        precision: register-index bits; ``m = 2**precision`` registers.
        device: where the registers live (CUDA unless another is named).
    """

    sketch_fields = (("registers", "max"),)
    config_attrs = ("precision",)

    def __init__(self, precision: int = 12, device: Optional[Union[str, torch.device]] = None):
        if not 4 <= int(precision) <= 18:
            raise ValueError("precision must be in [4, 18]")
        self.precision = int(precision)
        self.registers = torch.zeros((1 << self.precision,), dtype=torch.int32, device=_device(device))

    # ------------------------------------------------------------------ #
    def insert(self, values: Any) -> "HyperLogLogSketch":
        """Pure insert of a batch of hashable keys (int or float arrays)."""
        k = canonical_u32(values, self.registers.device)
        if k.numel() == 0:  # a shape, known on the host
            return self
        h = fmix32(k)
        p = self.precision
        idx = h >> (32 - p)
        # rank of the remaining (32-p)-bit suffix: leading zeros + 1, capped
        rho = torch.clamp(_clz32((h << p) & MASK32) + 1, max=32 - p + 1)
        regs = self.registers.scatter_reduce(0, idx, rho, reduce="amax", include_self=True)
        return self.replace(registers=regs)

    def estimate(self) -> Tensor:
        """Cardinality estimate (float32 scalar) with the standard small- and
        large-range corrections."""
        m = float(1 << self.precision)
        if m == 16:
            alpha = 0.673
        elif m == 32:
            alpha = 0.697
        elif m == 64:
            alpha = 0.709
        else:
            alpha = 0.7213 / (1.0 + 1.079 / m)
        dev = self.registers.device
        f32 = lambda v: torch.full((), v, dtype=torch.float32, device=dev)  # noqa: E731
        regs = self.registers.to(torch.float32)
        inv_sum = torch.sum(torch.exp2(-regs))
        raw = f32(np.float32(alpha * m * m)) / inv_sum
        zeros = torch.sum((self.registers == 0).to(torch.float32))
        # linear counting when the raw estimate is small and registers remain
        # empty; 32-bit hash-collision correction at the very top of the range
        small = f32(m) * torch.log(f32(m) / torch.clamp(zeros, min=1.0))
        two32 = f32(2.0 ** 32)
        large = -two32 * torch.log1p(-torch.clamp(raw / two32, max=0.999999))
        est = torch.where((raw <= 2.5 * m) & (zeros > 0), small, torch.where(raw > two32 / 30.0, large, raw))
        return est.to(torch.float32)

    def error_bound(self) -> Dict[str, Any]:
        m = 1 << self.precision
        return {"kind": "relative_std_error", "value": 1.04 / math.sqrt(m)}
