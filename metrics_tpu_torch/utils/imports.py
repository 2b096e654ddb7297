"""Availability probes for optional dependencies.

The port's own copy of ``package_available`` and the flags it reads; the
JAX package keeps its own in ``metrics_tpu/utils/imports.py``. A probe finds
a package without importing it, so an optional dependency is imported only
where it is used.
"""
from __future__ import annotations

import importlib.util
from functools import lru_cache


@lru_cache()
def package_available(name: str) -> bool:
    """True if ``name`` is importable (a probe only: nothing is imported)."""
    try:
        return importlib.util.find_spec(name) is not None
    except (ModuleNotFoundError, ValueError):
        return False


_TRANSFORMERS_AVAILABLE = package_available("transformers")
_NLTK_AVAILABLE = package_available("nltk")
_REGEX_AVAILABLE = package_available("regex")
