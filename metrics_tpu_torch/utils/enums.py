"""Case-insensitive string enums (``EnumStr``, ``DataType``, ``AverageMethod``,
``MDMCAverageMethod``).

Counterpart of ``metrics_tpu/utils/enums.py``; the port keeps its own copy so
that it never imports the JAX package.
"""
from __future__ import annotations

from enum import Enum
from typing import Optional


class EnumStr(str, Enum):
    """String enum with case/space-insensitive ``from_str`` lookup."""

    @classmethod
    def from_str(cls, value: str) -> Optional["EnumStr"]:
        norm = lambda s: s.lower().replace(" ", "_")
        try:
            me = [e for e in cls if norm(e.value) == norm(value)]
            return me[0]
        except IndexError:
            return None

    def __eq__(self, other: object) -> bool:  # type: ignore[override]
        if other is None:
            return False
        if isinstance(other, Enum):
            other = other.value
        return self.value.lower() == str(other).lower()

    def __hash__(self) -> int:
        return hash(self.value.lower())


class DataType(EnumStr):
    """Type of an input as determined by the classification format machine."""

    BINARY = "binary"
    MULTILABEL = "multi-label"
    MULTICLASS = "multi-class"
    MULTIDIM_MULTICLASS = "multi-dim multi-class"


class AverageMethod(EnumStr):
    """Averaging strategy over per-class scores."""

    MICRO = "micro"
    MACRO = "macro"
    WEIGHTED = "weighted"
    NONE = "none"
    SAMPLES = "samples"


class MDMCAverageMethod(EnumStr):
    """How to handle the extra sample dimension of multi-dim multi-class inputs."""

    GLOBAL = "global"
    SAMPLEWISE = "samplewise"

