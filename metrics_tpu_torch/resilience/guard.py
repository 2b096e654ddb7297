"""Opt-in non-finite state guard at the update/sync/compute boundaries.

Counterpart of ``metrics_tpu/resilience/guard.py``. A NaN that slips into
accumulated metric state poisons every later ``compute()``. This guard
checks state for non-finite values at the facade boundaries (after each
``update()``, after ``sync()``, and on the ``compute()`` result) under one
of three policies:

* ``"raise"``: raise :class:`NonFiniteStateError` naming the bad leaves;
* ``"warn"``: ``rank_zero_warn`` and count, state untouched;
* ``"quarantine"``: at the **update** boundary, roll the state back to its
  pre-update snapshot (the poisoned batch is dropped and counted); at the
  sync and compute boundaries, where there is no batch to drop, as
  ``"warn"``.

Off by default and **opt-in for a reason**: the check reads from the card.
Where the JAX package reads every leaf to the host, the port reduces every
float leaf with ``torch.isfinite(...).all()`` on the state's device and
reads the flags back once per boundary (once per device the leaves live
on). It never reads inside a CUDA-graph capture or an engine's step
(``torch.cuda.is_current_stream_capturing()`` and the engines' capturing
flag play the part of the JAX package's trace check). The snapshot the
update boundary keeps holds the state's tensors, so the engines' alias
guard refuses in-place updates while the guard is armed: the documented
cost of arming it. The disabled path is one flag read at each site.

Every trip increments ``metrics_tpu_guard_nonfinite_total{owner,where,policy}``
and emits a ``guard/nonfinite`` tracer instant.
"""
from __future__ import annotations

import contextlib
import math
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from metrics_tpu_torch.observability import tracer as _otrace
from metrics_tpu_torch.observability.instruments import REGISTRY as _REGISTRY
from metrics_tpu_torch.utils.exceptions import MetricsUserError
from metrics_tpu_torch.utils.prints import rank_zero_warn

POLICIES = ("raise", "warn", "quarantine")

_ENV_FLAG = "METRICS_TPU_GUARD"  # set to a policy name to arm at import


class NonFiniteStateError(MetricsUserError):
    """Non-finite values crossed a guarded boundary under policy='raise'."""

    def __init__(self, owner: str, where: str, leaves: List[str]) -> None:
        super().__init__(
            f"non-finite values in {owner} at the {where} boundary: "
            f"{', '.join(leaves)} (guard policy 'raise')"
        )
        self.owner = owner
        self.where = where
        self.leaves = leaves


active: bool = False
_policy: str = "warn"
_lock = threading.Lock()


def guard_policy() -> Optional[str]:
    """The armed policy, or ``None`` while the guard is off."""
    return _policy if active else None


def set_guard(policy: Optional[str]) -> None:
    """Arm the guard with a policy, or disarm with ``None``."""
    global active, _policy
    if policy is not None and policy not in POLICIES:
        raise ValueError(f"unknown guard policy {policy!r}; expected one of {POLICIES}")
    with _lock:
        if policy is None:
            active = False
        else:
            _policy = policy
            active = True


@contextlib.contextmanager
def guarded(policy: str = "warn"):
    """Arm the guard for the block; restores the prior state on exit."""
    prev = guard_policy()
    set_guard(policy)
    try:
        yield
    finally:
        set_guard(prev)


def capturing() -> bool:
    """True inside an engine's step or a CUDA-graph capture, where a read
    from the card is not allowed: the guard checks nothing there."""
    from metrics_tpu_torch.utils.checks import _capturing

    if _capturing():
        return True
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _float_leaves(tree: Any, prefix: str, out: List[Tuple[str, Any]]) -> None:
    """``(name, leaf)`` for the float leaves of ``tree``: tensors and python
    floats, through dicts, lists, tuples and the engines' containers (a
    ``CatBuffer`` is its data, count and flag; a sketch its components)."""
    from metrics_tpu_torch.core.engine import tree_leaves

    if isinstance(tree, dict):
        for name, val in tree.items():
            _float_leaves(val, f"{prefix}{name}", out)
        return
    for i, leaf in enumerate(tree_leaves(tree)):
        if (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()) or isinstance(leaf, float):
            out.append((prefix if prefix else f"leaf[{i}]", leaf))


def nonfinite_leaves(tree: Any, prefix: str = "") -> List[str]:
    """Names of float leaves in ``tree`` holding any non-finite value.

    A dict is walked by name (a leaf is named by its key path); any other
    value is taken apart like an engine's state tree. Each float tensor
    reduces to one flag on its device, and the flags are read to the host
    once per device. Callers gate on :data:`active`.
    """
    leaves: List[Tuple[str, Any]] = []
    _float_leaves(tree, prefix, leaves)
    ok = [True] * len(leaves)
    by_device: Dict[torch.device, List[int]] = {}
    for i, (_, leaf) in enumerate(leaves):
        if isinstance(leaf, float):
            ok[i] = math.isfinite(leaf)
        elif leaf.numel():
            by_device.setdefault(leaf.device, []).append(i)
    for index in by_device.values():
        flags = torch.stack([torch.isfinite(leaves[i][1]).all() for i in index]).tolist()
        for i, flag in zip(index, flags):
            ok[i] = flag
    return [name for (name, _), good in zip(leaves, ok) if not good]


def inspect(owner: str, where: str, tree: Any) -> bool:
    """Check ``tree`` at a boundary; returns True when the caller should roll
    back (quarantine at the update boundary). Callers gate on :data:`active`
    and check nothing while :func:`capturing`.
    """
    bad = nonfinite_leaves(tree)
    if not bad:
        return False
    pol = _policy
    _REGISTRY.counter(
        "guard_nonfinite_total",
        "Non-finite state detections at guarded boundaries.",
        owner=owner, where=where, policy=pol,
    ).inc()
    if _otrace.active:
        _otrace.emit_instant(
            "guard/nonfinite", "guard", owner=owner, where=where,
            policy=pol, leaves=list(bad),
        )
    if pol == "raise":
        raise NonFiniteStateError(owner, where, bad)
    quarantined = pol == "quarantine" and where == "update"
    rank_zero_warn(
        f"metrics_tpu guard: non-finite values in {owner} at the {where} "
        f"boundary ({', '.join(bad)}); "
        + ("update quarantined (state rolled back)." if quarantined
           else f"policy={pol!r}, state left as-is.")
    )
    return quarantined


def _env_autostart() -> None:
    val = os.environ.get(_ENV_FLAG, "").strip().lower()
    if val in POLICIES:
        set_guard(val)


_env_autostart()
