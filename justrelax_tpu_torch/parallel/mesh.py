"""The process mesh: ranks laid over the spatial grid.

Counterpart of ``justrelax_tpu/parallel/mesh.py``. The reference scales by
sharding the spatial grid over MPI ranks (ImplicitGlobalGrid); the JAX
package lays devices over a ``jax.sharding.Mesh`` with axes ("x", "y"[,
"z"]). The port runs one process per rank on ``torch.distributed``: a
:class:`GridMesh` is the rank grid over a process group, with this rank's
coordinates, each axis's size and the neighbours' ranks. Ranks are in
row-major order, as ``np.asarray(devices).reshape(shape)`` orders JAX's
devices, so rank ``r`` of a (px, py) mesh sits at ``(r // py, r % py)``.

Inside a solve each rank holds its own tile of every field, in the
blocked-local layout of :mod:`~justrelax_tpu_torch.parallel.decomp`:
:func:`grid_sharding` and :func:`shard_pytree` cut a blocked array, or a
state's fields, to this rank's tile. ``with mesh:`` makes a mesh the one
the :mod:`~justrelax_tpu_torch.parallel.halo` functions read, as JAX's
``with mesh:`` does for ``shard_map``.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from justrelax_tpu_torch.core.device import resolve_device

__all__ = [
    "GridMesh",
    "make_grid_mesh",
    "grid_sharding",
    "shard_pytree",
    "factor_devices",
    "current_mesh",
]

_AXES = ("x", "y", "z")
_ACTIVE = threading.local()


def factor_devices(n: int, ndim: int) -> Tuple[int, ...]:
    """Near-square factorization of ``n`` devices over ``ndim`` mesh axes."""
    dims = [1] * ndim
    remaining = n
    for d in range(ndim):
        target = round(remaining ** (1.0 / (ndim - d)))
        f = max(1, target)
        while remaining % f != 0:
            f -= 1
        dims[d] = f
        remaining //= f
    dims[-1] *= remaining
    return tuple(dims)


@dataclasses.dataclass(frozen=True, eq=False)
class GridMesh:
    """A rank grid with named axes. ``ranks`` holds the global rank at each
    mesh position; ``coords`` is this process's position. ``device`` is
    where this rank's tiles live; ``staged`` says that the backend cannot
    move device tensors (gloo with tiles on the card), so the halo module
    stages every slab through host memory."""

    ranks: np.ndarray
    axis_names: Tuple[str, ...]
    rank: int
    coords: Tuple[int, ...]
    device: torch.device
    group: Optional[object] = None
    staged: bool = False

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.ranks.shape)

    @property
    def devices(self) -> np.ndarray:
        """The rank at each mesh position (JAX's ``mesh.devices``)."""
        return self.ranks

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def distributed(self) -> bool:
        """Whether the mesh runs over a process group (a world of one made
        without one runs every exchange and reduction locally)."""
        return dist.is_available() and dist.is_initialized()

    def _axis(self, mesh_axis: str) -> int:
        try:
            return self.axis_names.index(mesh_axis)
        except ValueError:
            raise ValueError(f"mesh has no axis {mesh_axis!r} (axes {self.axis_names})") \
                from None

    def axis_index(self, mesh_axis: str) -> int:
        """This rank's coordinate along ``mesh_axis`` (``lax.axis_index``)."""
        return self.coords[self._axis(mesh_axis)]

    def axis_size(self, mesh_axis: str) -> int:
        return self.shape[self._axis(mesh_axis)]

    def neighbor(self, mesh_axis: str, step: int, cyclic: bool = False) -> Optional[int]:
        """The global rank ``step`` positions along ``mesh_axis``; ``None``
        past a physical edge unless ``cyclic``."""
        a = self._axis(mesh_axis)
        pos = list(self.coords)
        pos[a] += step
        if cyclic:
            pos[a] %= self.shape[a]
        elif not 0 <= pos[a] < self.shape[a]:
            return None
        return int(self.ranks[tuple(pos)])

    def tile(self, blocked, ndim: Optional[int] = None):
        """This rank's tile of a blocked array (``decomp.block_staggered``
        layout): the leading ``ndim`` axes (all mesh axes by default) are cut
        into ``shape`` equal blocks, trailing axes are kept whole."""
        ndim = len(self.shape) if ndim is None else ndim
        idx = []
        for a in range(ndim):
            n, p = blocked.shape[a], self.shape[a]
            if n % p:
                raise ValueError(f"axis {a} of length {n} does not split over {p} ranks")
            s = n // p
            idx.append(slice(self.coords[a] * s, (self.coords[a] + 1) * s))
        return blocked[tuple(idx)]

    def local(self, A, tile_shape: Sequence[int]) -> torch.Tensor:
        """``A`` as this rank's tile of leading shape ``tile_shape``, on the
        mesh's device: a tile is taken as it is, a whole blocked array (the
        tile shape times the mesh's) is cut with :meth:`tile`, and a scalar
        is broadcast."""
        A = torch.as_tensor(A)
        nd = len(self.shape)
        tile_shape = tuple(int(s) for s in tile_shape)
        if A.ndim == 0:
            return A.to(self.device).expand(tile_shape)
        lead = tuple(A.shape[:nd])
        if lead == tile_shape[:nd]:
            return A.to(self.device)
        if lead == tuple(t * p for t, p in zip(tile_shape, self.shape)):
            return self.tile(A).to(self.device)
        raise ValueError(f"array of shape {tuple(A.shape)} is neither a tile {tile_shape} "
                         f"nor the blocked array of mesh {self.shape}")

    def __enter__(self):
        stack = getattr(_ACTIVE, "stack", None)
        if stack is None:
            stack = _ACTIVE.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.stack.pop()
        return False


def current_mesh(mesh: Optional[GridMesh] = None) -> GridMesh:
    """``mesh`` if given, else the innermost ``with mesh:``."""
    if mesh is not None:
        return mesh
    stack = getattr(_ACTIVE, "stack", None)
    if not stack:
        raise RuntimeError("no process mesh: pass mesh= or enter `with mesh:`")
    return stack[-1]


def _default_device(device):
    if device is not None:
        return torch.device(device)
    from justrelax_tpu_torch.parallel import multihost

    if multihost.rank_device() is not None:
        return multihost.rank_device()
    return resolve_device(None)


def make_grid_mesh(
    shape: Optional[Sequence[int]] = None,
    ndim: int = 2,
    group=None,
    device=None,
) -> GridMesh:
    """The rank grid over ``group`` (the default process group) with axes
    ("x", "y"[, "z"]), ranks in row-major order. Without a process group it
    is a world of one. ``device`` defaults to the one
    :func:`~justrelax_tpu_torch.parallel.multihost.initialize` chose for this
    rank, else the card (``core.device.resolve_device``)."""
    if dist.is_available() and dist.is_initialized():
        members = (list(range(dist.get_world_size())) if group is None
                   else dist.get_process_group_ranks(group))
        rank = dist.get_rank()
        backend = dist.get_backend(group)
    else:
        if group is not None:
            raise ValueError("a process group was given but torch.distributed is not "
                             "initialized")
        members, rank, backend = [0], 0, None
    n = len(members)
    if shape is None:
        shape = factor_devices(n, ndim)
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} ranks")
    ranks = np.asarray(members, dtype=np.int64).reshape(shape)
    where = np.argwhere(ranks == rank)
    if len(where) != 1:
        raise ValueError(f"rank {rank} is not a member of the mesh's group")
    dev = _default_device(device)
    return GridMesh(ranks=ranks, axis_names=_AXES[: len(shape)], rank=rank,
                    coords=tuple(int(c) for c in where[0]), device=dev, group=group,
                    staged=backend == "gloo" and dev.type == "cuda")


def grid_sharding(mesh: GridMesh, ndim: Optional[int] = None):
    """The cut of a blocked array to this rank's tile, partitioning its
    leading ``ndim`` (all mesh) axes: a callable ``blocked → tile`` that
    puts the tile on the mesh's device (JAX's ``NamedSharding`` of
    ``P(*axes)``)."""
    ndim = len(mesh.axis_names) if ndim is None else min(ndim, len(mesh.axis_names))

    def cut(blocked):
        return torch.as_tensor(mesh.tile(blocked, ndim)).to(mesh.device)

    return cut


def shard_pytree(tree, mesh: GridMesh):
    """Every array leaf of a state (dicts, lists, tuples, named tuples and
    dataclasses of arrays) cut to this rank's tile along its spatial
    (leading) axes and put on the mesh's device; leaves of fewer dimensions
    than the mesh, and scalars, are replicated."""
    cut = grid_sharding(mesh)
    nd = len(mesh.axis_names)

    def place(x):
        if isinstance(x, (torch.Tensor, np.ndarray)):
            if x.ndim >= nd:
                return cut(x)
            return torch.as_tensor(x).to(mesh.device)
        if isinstance(x, dict):
            return {k: place(v) for k, v in x.items()}
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{f.name: place(getattr(x, f.name))
                                             for f in dataclasses.fields(x) if f.init})
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(place(v) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(place(v) for v in x)
        return x

    return place(tree)
