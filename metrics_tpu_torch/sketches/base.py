"""Mergeable sketch base (counterpart of ``metrics_tpu/sketches/base.py``).

A :class:`MergeableSketch` is a small bundle of tensors on one device (the
*components*) plus static Python config. Every component carries an
elementwise reduction (``"sum"``/``"max"``/``"min"``), and ``merge`` applies
those reductions component by component: a commutative, associative monoid,
so merging shards in any order is bitwise identical. The sync layer splits a
sketch leaf into its components, sends each through the existing
``(reduction, dtype)`` buckets and reassembles it; the compiled engines
flatten it into its components the same way (``core/engine.py``).

Components live on CUDA unless the constructor names another device (the
port's rule for metric state, ``core.metric.resolve_device``), and an input
tensor on another device than the sketch's raises instead of being copied.

Subclasses declare ``sketch_fields`` (ordered ``(component_name,
reduction)`` pairs, the flatten order) and ``config_attrs`` (ordered static
attribute names, also the checkpoint config payload). Inserts and queries
are pure: they return new sketches or tensors, read nothing back to the host
and build no tensor from host memory, so a CUDA graph can capture them.

Where the JAX package registers each class as a pytree node, the port
registers it in :data:`SKETCH_CLASSES` only; the engines' flattener knows
sketches by :func:`is_sketch`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Type, Union

import numpy as np
import torch
from torch import Tensor

__all__ = ["MergeableSketch", "register_sketch", "SKETCH_CLASSES", "is_sketch"]

# name -> class; a checkpoint decoder resolves ``sketch_class`` through this
# registry, so a restore never unpickles arbitrary code
SKETCH_CLASSES: Dict[str, Type["MergeableSketch"]] = {}

_VALID_REDUCTIONS = ("sum", "max", "min")

# host-made constants (seeds, representatives, probabilities) on each device,
# made once: a copy from host memory cannot run inside a graph capture
_CONSTANTS: Dict[Tuple, Tensor] = {}


def device_constant(values: Union[Sequence, np.ndarray], dtype: torch.dtype, device: torch.device) -> Tensor:
    """``torch.as_tensor(values, dtype, device)``, made once per (values,
    dtype, device) and shared; callers must not write into it."""
    arr = np.asarray(values)
    key = (arr.tobytes(), arr.dtype.str, arr.shape, dtype, torch.device(device))
    out = _CONSTANTS.get(key)
    if out is None:
        out = _CONSTANTS[key] = torch.as_tensor(arr, device=device).to(dtype)
    return out


def register_sketch(cls: Type["MergeableSketch"]) -> Type["MergeableSketch"]:
    """Class decorator: check the component reductions and register the
    class in ``SKETCH_CLASSES``."""
    for fname, fred in cls.sketch_fields:
        if fred not in _VALID_REDUCTIONS:
            raise ValueError(
                f"{cls.__name__}.{fname}: sketch component reduction must be "
                f"one of {_VALID_REDUCTIONS}, got {fred!r}"
            )
    SKETCH_CLASSES[cls.__name__] = cls
    return cls


def is_sketch(val: Any) -> bool:
    """True when ``val`` is a MergeableSketch instance (a duck-typed marker,
    so low-level modules can test without importing this package)."""
    return getattr(val, "_is_mergeable_sketch", False) is True


class MergeableSketch:
    """Base class for fixed-size mergeable sketch states."""

    _is_mergeable_sketch = True

    # subclasses override
    sketch_fields: Tuple[Tuple[str, str], ...] = ()
    config_attrs: Tuple[str, ...] = ()

    # ------------------------------------------------------------------ #
    # flattening (the engines' and the sync's view)
    # ------------------------------------------------------------------ #
    def config(self) -> Tuple:
        """The static config in ``config_attrs`` order (hashable)."""
        return tuple(getattr(self, a) for a in self.config_attrs)

    @classmethod
    def _from_parts(cls, config: Tuple, components: Sequence[Tensor]) -> "MergeableSketch":
        """A sketch of ``config`` holding ``components`` in field order."""
        obj = object.__new__(cls)
        for a, v in zip(cls.config_attrs, config):
            object.__setattr__(obj, a, v)
        for (fname, _), c in zip(cls.sketch_fields, components):
            object.__setattr__(obj, fname, c)
        return obj

    # ------------------------------------------------------------------ #
    # component access
    # ------------------------------------------------------------------ #
    def components(self) -> Dict[str, Tensor]:
        """``{component_name: tensor}`` in declared order."""
        return {fname: getattr(self, fname) for fname, _ in self.sketch_fields}

    def component_reductions(self) -> Tuple[Tuple[str, str], ...]:
        return self.sketch_fields

    def replace(self, **components: Tensor) -> "MergeableSketch":
        """New sketch with the given components swapped in (config shared)."""
        unknown = set(components) - {f for f, _ in self.sketch_fields}
        if unknown:
            raise ValueError(f"unknown sketch components: {sorted(unknown)}")
        return self._from_parts(
            self.config(), [components.get(fname, getattr(self, fname)) for fname, _ in self.sketch_fields]
        )

    def config_dict(self) -> Dict[str, Any]:
        """Static config as plain Python scalars (checkpoint meta payload)."""
        out: Dict[str, Any] = {}
        for a in self.config_attrs:
            v = getattr(self, a)
            out[a] = float(v) if isinstance(v, float) else int(v)
        return out

    @classmethod
    def from_config(
        cls, config: Dict[str, Any], device: Optional[Union[str, torch.device]] = None
    ) -> "MergeableSketch":
        """Fresh (empty) sketch for a checkpoint-decoded config dict, on
        ``device`` (CUDA unless another is named)."""
        return cls(**config, device=device)

    @property
    def device(self) -> torch.device:
        return getattr(self, self.sketch_fields[0][0]).device

    def to(self, device: Union[str, torch.device]) -> "MergeableSketch":
        """The same sketch with every component on ``device``."""
        return self.replace(**{f: v.to(device) for f, v in self.components().items()})

    def clone(self) -> "MergeableSketch":
        """A copy whose components share no memory with this sketch's."""
        return self.replace(**{f: v.clone() for f, v in self.components().items()})

    # ------------------------------------------------------------------ #
    # monoid
    # ------------------------------------------------------------------ #
    def merge(self, other: "MergeableSketch") -> "MergeableSketch":
        """Commutative elementwise merge; bitwise order-invariant."""
        if type(other) is not type(self):
            raise TypeError(f"cannot merge {type(self).__name__} with {type(other).__name__}")
        if tuple(other.config_dict().items()) != tuple(self.config_dict().items()):
            raise ValueError(
                f"cannot merge {type(self).__name__} sketches with different "
                f"configs: {self.config_dict()} vs {other.config_dict()}"
            )
        merged: Dict[str, Tensor] = {}
        for fname, fred in self.sketch_fields:
            a, b = getattr(self, fname), getattr(other, fname)
            if fred == "sum":
                merged[fname] = a + b
            elif fred == "max":
                merged[fname] = torch.maximum(a, b)
            else:
                merged[fname] = torch.minimum(a, b)
        return self.replace(**merged)

    # ------------------------------------------------------------------ #
    # introspection
    # ------------------------------------------------------------------ #
    @property
    def state_nbytes(self) -> int:
        """Total component bytes: fixed for a given config, whatever was inserted."""
        return sum(v.numel() * v.element_size() for v in self.components().values())

    def error_bound(self) -> Dict[str, Any]:
        """Declared accuracy contract (subclasses override)."""
        return {}

    def __repr__(self) -> str:
        cfg = ", ".join(f"{k}={v}" for k, v in self.config_dict().items())
        return f"{type(self).__name__}({cfg}, nbytes={self.state_nbytes})"


def _device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """A sketch's device: CUDA unless ``device`` names another; raises
    without a card, as metric state does."""
    from metrics_tpu_torch.core.metric import resolve_device  # core.metric imports this module

    return resolve_device(device)


def as_input(values: Any, device: torch.device) -> Tensor:
    """``values`` as a tensor on the sketch's ``device``: host data (numbers,
    lists, arrays) is copied there; a tensor on another device raises, as a
    metric's inputs do."""
    if isinstance(values, Tensor):
        if values.device != device:
            raise ValueError(f"the sketch lives on {device}, but an input lies on {values.device}")
        return values
    return torch.as_tensor(values, device=device)
