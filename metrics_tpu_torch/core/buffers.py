"""Fixed-capacity device buffers for ``cat`` states.

Counterpart of ``metrics_tpu/core/buffers.py``. A ``CatBuffer`` is a
``(capacity, *item)`` tensor on the metric's device with two 0-d tensors
beside it: ``count`` (int32, the true number of rows appended) and
``overflowed`` (bool, sticky). These three are what a compiled engine
carries through a captured step (``core/engine.py``), as the JAX package
carries the three leaves of its pytree.

The host keeps an exact mirror of both (``len(buf)``, ``buf.overflow_seen``):
every append's row count is a shape, which the host knows, so neither
``len()`` nor ``to_array()`` nor the overflow warning reads the device.
The engines add each captured step's row count to the mirror at every
replay. Only a gather, whose counts arrive in a collective, reads them back.

Two kinds of append, as in the JAX package:

- **Eager** appends (outside a compiled step) write in place into the rows
  past the count and grow the buffer geometrically (doubling, zero-filled)
  when it would overflow. Because appends write in place, ``copy()`` clones.
- **Captured** appends (inside a compiled step: ``utils.checks._capturing()``)
  cannot grow. The write offset is ``count`` clamped into
  ``[0, capacity - n]``, as ``lax.dynamic_update_slice`` clamps it, and is
  read from device memory (an ``index_copy_`` at ``clamp(count) + arange(n)``).
  So on overflow the last ``n`` rows are overwritten; a batch larger than the
  buffer is cut to ``capacity`` rows first. ``count`` keeps the true total and
  ``overflowed`` is set before the write, sticky: ``to_array()`` then raises.

``merge`` and ``gather`` compact with one stable sort of an integer key that
moves the valid rows to the front.

A :class:`ShardedCatBuffer` is one rank's block of a sample-sharded buffer
(``Metric.shard_state`` of a state declared ``shard_axis=0``): rank ``r``
of ``width`` holds rows ``[r * capacity / width, (r + 1) * capacity / width)``
of one global buffer, whose ``count`` and sticky ``overflowed`` every rank
holds alike. Appends go through the metric's sharded update, which gathers
each update's rows from every rank and keeps its own.

Example:
    >>> import torch
    >>> from metrics_tpu_torch.core.buffers import CatBuffer
    >>> buf = CatBuffer.empty(capacity=4)
    >>> buf.append(torch.tensor([1.0, 2.0]))
    >>> buf.append(torch.tensor([3.0]))
    >>> len(buf)
    3
    >>> buf.to_array().tolist()
    [1.0, 2.0, 3.0]
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _capturing
from metrics_tpu_torch.utils.exceptions import MetricsUserError, Uncapturable

__all__ = ["CatBuffer", "ShardedCatBuffer"]


class _InPlace(threading.local):
    depth = 0


_in_place = _InPlace()


@contextmanager
def writes_in_place() -> Iterator[None]:
    """The body of a captured update step: its state buffers are the step's
    own static buffers, so ``Metric.update_state`` appends into them instead
    of into copies (the engine's in-place state, the JAX package's donation)."""
    _in_place.depth += 1
    try:
        yield
    finally:
        _in_place.depth -= 1


def in_place_writes() -> bool:
    return _in_place.depth > 0


def _scalar(value: Union[int, bool], dtype: torch.dtype, device: Optional[torch.device]) -> Tensor:
    # a fill, not a copy from the host: no synchronisation on the card
    return torch.full((), value, dtype=dtype, device=device)


class CatBuffer:
    """Preallocated ``(capacity, *item_shape)`` buffer with a fill count.

    The item shape and dtype are fixed by the first append, or at creation
    when ``item_shape`` is given. ``count`` and ``overflowed`` are 0-d device
    tensors; ``len()`` and :attr:`overflow_seen` are their host mirrors.
    """

    def __init__(
        self, data: Optional[Tensor], count: int = 0, capacity: Optional[int] = None,
        device: Optional[Union[str, torch.device]] = None, overflowed: bool = False,
    ) -> None:
        if data is None and (capacity is None or capacity <= 0):
            raise ValueError(f"An unmaterialized CatBuffer needs a positive capacity, got {capacity}")
        where = data.device if data is not None else (torch.device(device) if device is not None else None)
        self._init(
            data, _scalar(int(count), torch.int32, where), _scalar(bool(overflowed), torch.bool, where),
            int(count), bool(overflowed), capacity,
        )
        # an unmaterialized buffer made without a device takes its first append's
        self._device = where

    def _init(self, data: Optional[Tensor], count: Tensor, overflowed: Tensor, n: int, over: bool,
              capacity: Optional[int]) -> None:
        self.data = data
        self.count = count
        self.overflowed = overflowed
        self._n = n  # host mirror of count
        self._over = over  # host mirror of overflowed
        self._capacity = None if data is not None else int(capacity)
        self._device: Optional[torch.device] = count.device

    @classmethod
    def _from_parts(cls, data: Optional[Tensor], count: Tensor, overflowed: Tensor, n: int = 0,
                    over: bool = False, capacity: Optional[int] = None) -> "CatBuffer":
        """A buffer over existing tensors (no copy), with the given mirrors."""
        obj = object.__new__(cls)
        obj._init(data, count, overflowed, n, over, capacity)
        return obj

    @property
    def capacity(self) -> int:
        """Row capacity: ``data.shape[0]`` once materialized."""
        return self.data.shape[0] if self.data is not None else self._capacity

    @property
    def device(self) -> Optional[torch.device]:
        return self.data.device if self.data is not None else self._device

    @property
    def overflow_seen(self) -> bool:
        """Host mirror of ``overflowed``: a captured append went past the
        capacity (sticky)."""
        return self._over

    # ------------------------------------------------------------ creation --
    @classmethod
    def empty(
        cls, capacity: int, item_shape: Optional[Sequence[int]] = None, dtype: Optional[torch.dtype] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> "CatBuffer":
        """Unmaterialized buffer (item shape fixed by the first append), or a
        materialized zero buffer (float32 unless ``dtype`` says otherwise)
        when ``item_shape`` is given."""
        if item_shape is None:
            return cls(None, 0, capacity, device)
        data = torch.zeros((capacity, *(item_shape or ())), dtype=dtype or torch.float32, device=device)
        return cls(data, 0)

    @classmethod
    def from_array(cls, values: Tensor, capacity: Optional[int] = None) -> "CatBuffer":
        values = torch.atleast_1d(torch.as_tensor(values))
        n = values.shape[0]
        capacity = max(capacity or 0, n, 1)
        data = torch.zeros((capacity, *values.shape[1:]), dtype=values.dtype, device=values.device)
        data[:n] = values
        return cls(data, n)

    def copy(self) -> "CatBuffer":
        """An independent buffer: the tensors are cloned, since appends write in place."""
        new = CatBuffer._from_parts(
            None if self.data is None else self.data.clone(), self.count.clone(), self.overflowed.clone(),
            self._n, self._over, self._capacity,
        )
        new._device = self._device
        return new

    def _alias(self) -> "CatBuffer":
        """A new buffer object over the same tensors (see :func:`writes_in_place`)."""
        new = CatBuffer._from_parts(self.data, self.count, self.overflowed, self._n, self._over, self._capacity)
        new._device = self._device
        return new

    def to(self, device: Union[str, torch.device]) -> "CatBuffer":
        return CatBuffer._from_parts(
            None if self.data is None else self.data.to(device), self.count.to(device), self.overflowed.to(device),
            self._n, self._over, self._capacity,
        )

    # ------------------------------------------------------------- queries --
    @property
    def materialized(self) -> bool:
        return self.data is not None

    @property
    def item_shape(self) -> Optional[Tuple[int, ...]]:
        return None if self.data is None else tuple(self.data.shape[1:])

    def valid_mask(self) -> Tensor:
        """(capacity,) bool, True for filled rows (all True after an overflow)."""
        return torch.arange(self.capacity, device=self.device) < self.count.clamp(max=self.capacity)

    def __bool__(self) -> bool:
        if _capturing():
            return self.materialized  # conservatively non-empty in a captured step, as under a JAX trace
        return self.materialized and self._n > 0

    def __len__(self) -> int:
        if _capturing():
            # a captured step would freeze the count it read
            raise Uncapturable("len(CatBuffer) is a host value that a captured step cannot carry")
        return self._n

    def to_array(self) -> Tensor:
        """The valid prefix ``data[:count]``. Not inside a compiled step (its
        shape depends on the count)."""
        if not self.materialized:
            raise MetricsUserError("CatBuffer is empty: no state has been appended yet.")
        if _capturing():
            raise Uncapturable(
                "CatBuffer.to_array() has a data-dependent shape and cannot run in a captured step. "
                "Call compute() outside the compiled step (the fixed-shape buffer state itself is captured)."
            )
        if self._n > self.capacity or self._over:
            raise MetricsUserError(
                f"CatBuffer overflow: more samples were appended (count={self._n}) than its capacity "
                f"({self.capacity}) held at the time, inside a compiled program (which cannot grow "
                "buffers); the overflowing appends overwrote the buffer tail. Raise "
                "`buffer_capacity` to at least the per-device total sample count, or accumulate "
                "eagerly (eager appends grow the buffer automatically)."
            )
        return self.data[: self._n]

    # ----------------------------------------------------------- mutation --
    def _grow_to(self, needed: int) -> None:
        new_cap = self.capacity
        while new_cap < needed:
            new_cap *= 2
        if new_cap != self.capacity:
            grown = torch.zeros((new_cap, *self.data.shape[1:]), dtype=self.data.dtype, device=self.data.device)
            grown[: self.capacity] = self.data
            self.data = grown

    def append(self, x: Tensor) -> None:
        """Append a batch (rows of ``x`` along dim 0; a scalar is one row):
        growing the buffer when eager, at a clamped offset when captured."""
        x = torch.atleast_1d(torch.as_tensor(x, device=self.device))
        n = x.shape[0]
        if self.data is None:
            self.count, self.overflowed = self.count.to(x.device), self.overflowed.to(x.device)
            self.data = torch.zeros((self.capacity, *x.shape[1:]), dtype=x.dtype, device=x.device)
            self._capacity = None  # capacity now tracks data.shape[0]
        elif tuple(x.shape[1:]) != tuple(self.data.shape[1:]):
            raise MetricsUserError(
                f"CatBuffer item shape mismatch: buffer holds items of shape {tuple(self.data.shape[1:])}, "
                f"got a batch of items of shape {tuple(x.shape[1:])}. Buffered cat states need a uniform "
                "per-item shape; pad inputs to a static shape first."
            )
        if not _capturing():
            self._grow_to(self._n + n)
            self.data[self._n : self._n + n] = x
        else:
            capacity = self.capacity
            # static shapes: the write clamps, so flag the corruption first
            self.overflowed = self.overflowed | (self.count + n > capacity)
            self._over = self._over or self._n + n > capacity
            if n > capacity:  # a single batch larger than the whole buffer
                x = x[:capacity]
            m = x.shape[0]
            start = self.count.clamp(0, capacity - m).to(torch.int64)
            self.data.index_copy_(0, start + torch.arange(m, device=self.device), x.to(self.data.dtype))
        self.count = self.count + n
        self._n += n

    def __add__(self, other: Union["CatBuffer", List[Tensor]]) -> "CatBuffer":
        if isinstance(other, CatBuffer):
            return self.merge(other)
        new = self.copy()
        for v in other:
            new.append(v)
        return new

    def merge(self, other: "CatBuffer") -> "CatBuffer":
        """A new buffer holding this buffer's valid rows, then ``other``'s
        (the ``merge_states`` cat branch). Eager and without an overflow, an
        append (capacity stays geometric); else a concatenation compacted by
        one sort (capacities add)."""
        if not other.materialized:
            return self.copy()
        if not self.materialized:
            return other.copy()
        if not (_capturing() or self._over or other._over):
            new = self.copy()
            new.append(other.to_array())
            return new
        data = torch.cat([self.data, other.data.to(self.data.dtype)])
        valid = torch.cat([self.valid_mask(), other.valid_mask()])
        return self._compact(
            data, valid, self._n + other._n, self._over or other._over,
            self.count + other.count, self.overflowed | other.overflowed,
        )

    # -------------------------------------------------------------- gather --
    @staticmethod
    def _compact(data: Tensor, valid: Tensor, n: int, over: bool, count: Optional[Tensor] = None,
                 overflowed: Optional[Tensor] = None) -> "CatBuffer":
        """Stable-move the valid rows to the front (one sort of an int8 key);
        the capacity stays ``data.shape[0]``. ``count``/``overflowed`` default
        to the host values ``n``/``over``."""
        order = torch.argsort((~valid).to(torch.int8), stable=True)
        if count is None:
            count = _scalar(n, torch.int32, data.device)
        if overflowed is None:
            overflowed = _scalar(over, torch.bool, data.device)
        return CatBuffer._from_parts(data[order], count, overflowed, n, over)

    def gather(self, group) -> "CatBuffer":
        """All-gather across the ranks of ``group`` into one compacted
        buffer: the rows of rank 0, then rank 1, and so on."""
        if not self.materialized:
            raise MetricsUserError("Cannot gather an empty CatBuffer (no appends before sync).")
        from metrics_tpu_torch.parallel.sync import _sync_bucketed_catbuffers  # sync imports this module

        return _sync_bucketed_catbuffers([("buffer", self)], group)["buffer"]

    # -------------------------------------------------------------- dunder --
    def __repr__(self) -> str:
        shape = None if self.data is None else tuple(self.data.shape)
        return f"CatBuffer(capacity={self.capacity}, count={self._n}, data={shape})"


class ShardedCatBuffer(CatBuffer):
    """Rank ``index`` of ``width``'s block of a global buffer of
    ``capacity`` rows: ``data`` is ``(capacity / width, *item)``; ``count``,
    ``overflowed`` and their host mirrors are the global buffer's. Global
    appends clamp as captured appends do (the buffer never grows)."""

    @classmethod
    def block(cls, data: Optional[Tensor], count: Tensor, overflowed: Tensor, n: int, over: bool, index: int,
              width: int, capacity: Optional[int] = None) -> "ShardedCatBuffer":
        obj = cls._from_parts(data, count, overflowed, n, over, capacity)
        obj._index, obj._width = int(index), int(width)
        return obj

    @property
    def capacity(self) -> int:
        """Rows of the global buffer."""
        return self.data.shape[0] * self._width if self.data is not None else self._capacity

    @property
    def index(self) -> int:
        return self._index

    @property
    def width(self) -> int:
        return self._width

    def _like(self, data: Optional[Tensor], count: Tensor, overflowed: Tensor) -> "ShardedCatBuffer":
        out = ShardedCatBuffer.block(data, count, overflowed, self._n, self._over, self._index, self._width,
                                     self._capacity)
        out._device = self._device if data is None else data.device
        return out

    def copy(self) -> "ShardedCatBuffer":
        return self._like(None if self.data is None else self.data.clone(), self.count.clone(), self.overflowed.clone())

    def _alias(self) -> "ShardedCatBuffer":
        return self._like(self.data, self.count, self.overflowed)

    def to(self, device: Union[str, torch.device]) -> "ShardedCatBuffer":
        return self._like(None if self.data is None else self.data.to(device), self.count.to(device),
                          self.overflowed.to(device))

    def valid_mask(self) -> Tensor:
        """(rows,) bool: which rows of this block hold appended samples."""
        rows = self.capacity // self._width
        pos = self._index * rows + torch.arange(rows, device=self.device)
        return pos < self.count.clamp(max=self.capacity)

    def to_array(self) -> Tensor:
        raise MetricsUserError(
            "a sample-sharded CatBuffer holds one block of the buffer: compute() gathers it, or call "
            "unshard_state() first"
        )

    def append(self, x: Tensor) -> None:
        raise MetricsUserError("a sample-sharded CatBuffer is appended to by its metric's sharded update")

    def merge(self, other: "CatBuffer") -> "CatBuffer":
        raise MetricsUserError("a sample-sharded CatBuffer does not merge: unshard_state() first")

    def gather(self, group, kind: str = "all_gather") -> "CatBuffer":
        """The whole buffer, on every rank of ``group``: one ``all_gather``
        of the blocks, ticked as ``kind``; the count and flag are global
        already."""
        if not self.materialized:
            return CatBuffer(None, 0, self.capacity, self.device)
        from metrics_tpu_torch.parallel.sync import _all_gather  # sync imports this module

        data = torch.cat(_all_gather(self.data, group, kind=kind))
        return CatBuffer._from_parts(data, self.count, self.overflowed, self._n, self._over)

    def __repr__(self) -> str:
        shape = None if self.data is None else tuple(self.data.shape)
        return (f"ShardedCatBuffer(capacity={self.capacity}, count={self._n}, block={self._index}/{self._width}, "
                f"data={shape})")


def buffers_in(tree) -> List[CatBuffer]:
    """Every ``CatBuffer`` in a state tree (dicts, lists, tuples), in the
    order the engines flatten it."""
    out: List[CatBuffer] = []
    _collect(tree, out)
    return out


def _collect(tree, out: List[CatBuffer]) -> None:
    if isinstance(tree, CatBuffer):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _collect(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _collect(v, out)
