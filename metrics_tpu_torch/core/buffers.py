"""Fixed-capacity device buffers for ``cat`` states, eager part.

Counterpart of ``metrics_tpu/core/buffers.py``. A ``CatBuffer`` is a
``(capacity, *item)`` tensor on the metric's device plus a fill count. The
count is a Python int, so an append needs no read from the device: the host
knows every batch's length from its shape.

Appends write in place into the rows past the count, and grow the buffer
geometrically (doubling, zero-filled) when they would overflow it, as the JAX
package's eager appends do. Because appends write in place, ``copy()`` clones
the tensor: two buffers never share storage, so a metric's reset never hands
out its default's storage.

``gather`` concatenates the buffer across the ranks of a process group
(through ``metrics_tpu_torch.parallel.sync``). The ``overflowed`` flag is
or-ed across ranks there, as in the JAX package; eager appends grow the
buffer and never set it.

Not ported yet: the traced append that sets the flag (it waits for a
compiled update engine).

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

from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.utils.exceptions import MetricsUserError

__all__ = ["CatBuffer"]


class CatBuffer:
    """Preallocated ``(capacity, *item_shape)`` buffer with a fill count.

    The item shape and dtype are fixed by the first append, or at creation
    when ``item_shape`` is given.
    """

    def __init__(
        self, data: Optional[Tensor], count: int, capacity: Optional[int] = None,
        device: Optional[Union[str, torch.device]] = None, overflowed: bool = False,
    ) -> None:
        if data is None and (capacity is None or capacity <= 0):
            raise ValueError(f"An unmaterialized CatBuffer needs a positive capacity, got {capacity}")
        self.data = data
        self.count = int(count)
        self._capacity = None if data is not None else int(capacity)
        # where an unmaterialized buffer puts its first append's storage
        self._device = torch.device(device) if device is not None else None
        self.overflowed = bool(overflowed)

    @property
    def capacity(self) -> int:
        """Row capacity: ``data.shape[0]`` once materialized."""
        return self.data.shape[0] if self.data is not None else self._capacity

    @property
    def device(self) -> Optional[torch.device]:
        return self.data.device if self.data is not None else self._device

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
        """An independent buffer: the tensor is cloned, since appends write in place."""
        return CatBuffer(
            None if self.data is None else self.data.clone(), self.count, self._capacity, self._device, self.overflowed
        )

    def to(self, device: Union[str, torch.device]) -> "CatBuffer":
        if self.data is None:
            return CatBuffer(None, 0, self._capacity, device)
        return CatBuffer(self.data.to(device), self.count, overflowed=self.overflowed)

    # ------------------------------------------------------------- queries --
    @property
    def materialized(self) -> bool:
        return self.data is not None

    @property
    def item_shape(self) -> Optional[Tuple[int, ...]]:
        return None if self.data is None else tuple(self.data.shape[1:])

    def valid_mask(self) -> Tensor:
        """(capacity,) bool, True for filled rows."""
        return torch.arange(self.capacity, device=self.device) < self.count

    def __bool__(self) -> bool:
        return self.materialized and self.count > 0

    def __len__(self) -> int:
        return self.count

    def to_array(self) -> Tensor:
        """The valid prefix ``data[:count]``."""
        if not self.materialized:
            raise MetricsUserError("CatBuffer is empty: no state has been appended yet.")
        if self.overflowed:
            raise MetricsUserError(
                f"CatBuffer overflow: a rank appended more samples than its capacity ({self.capacity}) "
                "held inside a compiled program, which overwrote the buffer tail."
            )
        return self.data[: self.count]

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
        """Append a batch (rows of ``x`` along dim 0; a scalar is one row),
        growing the buffer geometrically when it would overflow."""
        x = torch.atleast_1d(torch.as_tensor(x, device=self.device))
        n = x.shape[0]
        if self.data is None:
            self.data = torch.zeros((self.capacity, *x.shape[1:]), dtype=x.dtype, device=x.device)
            self._capacity = None  # capacity now tracks data.shape[0]
        elif tuple(x.shape[1:]) != tuple(self.data.shape[1:]):
            raise MetricsUserError(
                f"CatBuffer item shape mismatch: buffer holds items of shape {tuple(self.data.shape[1:])}, "
                f"got a batch of items of shape {tuple(x.shape[1:])}. Buffered cat states need a uniform "
                "per-item shape; pad inputs to a static shape first."
            )
        self._grow_to(self.count + n)
        self.data[self.count : self.count + n] = x
        self.count += n

    def __add__(self, other: Union["CatBuffer", List[Tensor]]) -> "CatBuffer":
        if isinstance(other, CatBuffer):
            return self.merge(other)
        new = self.copy()
        for v in other:
            new.append(v)
        return new

    def merge(self, other: "CatBuffer") -> "CatBuffer":
        """A new buffer holding this buffer's valid rows, then ``other``'s
        (the ``merge_states`` cat branch). Capacity stays geometric."""
        if not other.materialized:
            return self.copy()
        if not self.materialized:
            return other.copy()
        new = self.copy()
        new.append(other.to_array())
        return new

    # -------------------------------------------------------------- gather --
    @staticmethod
    def _compact(data: Tensor, valid: Tensor, total: int, overflowed: bool) -> "CatBuffer":
        """Stable-move the valid rows to the front (one sort); the capacity
        stays ``data.shape[0]``."""
        order = torch.argsort((~valid).to(torch.int8), stable=True)
        return CatBuffer(data[order], total, overflowed=overflowed)

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
        return f"CatBuffer(capacity={self.capacity}, count={self.count}, data={shape})"
