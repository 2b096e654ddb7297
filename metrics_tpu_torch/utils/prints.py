"""Process-zero-gated logging (counterpart of ``metrics_tpu/utils/prints.py``).

The rank comes from an initialised ``torch.distributed`` process group, else
from the ``RANK`` environment variable, else 0.
"""
from __future__ import annotations

import functools
import logging
import os
import warnings
from typing import Any, Callable

import torch.distributed as dist

log = logging.getLogger("metrics_tpu_torch")


def _get_rank() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", 0))


def rank_zero_only(fn: Callable) -> Callable:
    """Call ``fn`` only on rank 0."""

    @functools.wraps(fn)
    def wrapped(*args: Any, **kwargs: Any) -> Any:
        if _get_rank() == 0:
            return fn(*args, **kwargs)
        return None

    return wrapped


@rank_zero_only
def rank_zero_warn(message: str, category: type = UserWarning, stacklevel: int = 3) -> None:
    warnings.warn(message, category, stacklevel=stacklevel)


@rank_zero_only
def rank_zero_info(message: str) -> None:
    log.info(message)


@rank_zero_only
def rank_zero_debug(message: str) -> None:
    log.debug(message)
