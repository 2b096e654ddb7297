"""Named layouts of ranks and their process groups.

Counterpart of ``make_mesh`` in ``metrics_tpu/parallel/mesh.py``. A JAX mesh
names the axes of an array of devices, and a collective over an axis name
reaches the devices along it. Here the ranks of the default process group
are laid out the same way, and each axis, or tuple of axes, becomes the
``ProcessGroup`` of the ranks that share this rank's coordinates on the other
axes: the group a sync over that axis name runs on.

``torch.distributed.new_group`` is collective over the whole default group:
every rank creates every group, in the same order, including the groups it
is not a member of. :class:`Mesh` does so for every non-empty subset of its
axes when it is built.

Example (a world of one rank, on the CPU):
    >>> import torch.distributed as dist
    >>> from metrics_tpu_torch.parallel import make_mesh
    >>> dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    >>> mesh = make_mesh([1, 1], ["data", "model"])
    >>> mesh.axis_size("data"), mesh.axis_index("model"), dist.get_world_size(mesh.group(("data", "model")))
    (1, 0, 1)
    >>> dist.destroy_process_group()
"""
from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch.distributed as dist

AxisNames = Union[str, Tuple[str, ...]]


class Mesh:
    """The ranks of the default group as an array with named axes.

    Args:
        axis_sizes: the size of each axis; one may be -1 (fill the rest).
            Their product must equal the world size.
        axis_names: one name per axis.
        backend: the backend of the axis groups (``"gloo"``, ``"nccl"``);
            ``None`` takes the default group's.
    """

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str], backend: Optional[str] = None) -> None:
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("a Mesh lays out the ranks of the default process group: initialise it first")
        if len(axis_sizes) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"need one distinct name per axis, got sizes {list(axis_sizes)} and names {list(axis_names)}")
        world = dist.get_world_size()
        sizes = list(axis_sizes)
        if -1 in sizes:
            known = int(np.prod([s for s in sizes if s != -1]))
            sizes[sizes.index(-1)] = world // known
        if int(np.prod(sizes)) != world:
            raise ValueError(f"a mesh of axes {dict(zip(axis_names, sizes))} needs {int(np.prod(sizes))} ranks, the world has {world}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(axis_names, sizes))
        self.ranks = np.arange(world).reshape(sizes)
        self.coords: Tuple[int, ...] = tuple(int(c) for c in np.unravel_index(dist.get_rank(), sizes))
        self._groups: Dict[Tuple[str, ...], dist.ProcessGroup] = {}
        for n_axes in range(1, len(sizes) + 1):
            for axes in itertools.combinations(range(len(sizes)), n_axes):
                others = [a for a in range(len(sizes)) if a not in axes]
                # move the group's axes last: each row of the reshaped array is one group
                blocks = np.transpose(self.ranks, others + list(axes)).reshape(-1, int(np.prod([sizes[a] for a in axes])))
                for block in blocks:
                    group = dist.new_group(ranks=block.tolist(), backend=backend)
                    if dist.get_rank() in block:
                        self._groups[tuple(self.axis_names[a] for a in axes)] = group

    def _key(self, axes: AxisNames) -> Tuple[str, ...]:
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in names if a not in self.shape]
        if unknown:
            raise ValueError(f"unknown mesh axes {unknown}; the mesh has {list(self.axis_names)}")
        return tuple(a for a in self.axis_names if a in names)

    def group(self, axes: AxisNames) -> dist.ProcessGroup:
        """This rank's process group along ``axes`` (a name or a tuple of names)."""
        return self._groups[self._key(axes)]

    def axis_index(self, name: str) -> int:
        """This rank's coordinate along ``name`` (``lax.axis_index``)."""
        return self.coords[self.axis_names.index(self._key(name)[0])]

    def axis_size(self, name: str) -> int:
        return self.shape[self._key(name)[0]]


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str], backend: Optional[str] = None) -> Mesh:
    """Lay out the ranks of the default process group as a named mesh."""
    return Mesh(axis_sizes, axis_names, backend)
