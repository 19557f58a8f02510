"""Staggered Cartesian grid geometry (uniform grid).

Counterpart of ``justrelax_tpu/core/grid.py::Geometry``: cell counts, domain
lengths, origin, spacings and the coordinate vectors of cell centers,
vertices and the ghosted velocity grids. Geometry is host-side metadata
(plain floats and numpy arrays); solvers read ``di`` from it and never move it
to the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = ["Geometry", "velocity_grids"]


def _lazy_grid(di, ni, li, origin):
    """Cell-center and vertex coordinate vectors of a uniform grid."""
    ndim = len(ni)
    xci = tuple(
        np.linspace(origin[d] + di[d] / 2, origin[d] + li[d] - di[d] / 2, ni[d])
        for d in range(ndim)
    )
    xvi = tuple(
        np.linspace(origin[d], origin[d] + li[d], ni[d] + 1) for d in range(ndim)
    )
    return xci, xvi


def velocity_grids(xci, xvi, di):
    """Coordinates of the staggered velocity nodes: the along-component axis
    on vertices, every transverse axis the cell-center axis extended by one
    ghost node on each side."""
    ndim = len(xci)
    ghosted = tuple(
        np.concatenate(([xci[d][0] - di[d]], xci[d], [xci[d][-1] + di[d]]))
        for d in range(ndim)
    )
    return tuple(
        tuple(xvi[d] if d == comp else ghosted[d] for d in range(ndim))
        for comp in range(ndim)
    )


@dataclasses.dataclass(frozen=True)
class Geometry:
    """A uniform staggered grid in 2 or 3 dimensions (``ni`` cells over
    lengths ``li`` from ``origin``; ``di = li / ni``)."""

    ni: Tuple[int, ...]
    li: Tuple[float, ...]
    origin: Tuple[float, ...]
    di: Tuple[float, ...]
    xci: Tuple[np.ndarray, ...]
    xvi: Tuple[np.ndarray, ...]
    xi_vel: Tuple[Tuple[np.ndarray, ...], ...]

    def __init__(
        self,
        ni: Tuple[int, ...],
        li: Tuple[float, ...],
        origin: Optional[Tuple[float, ...]] = None,
    ):
        ndim = len(ni)
        if ndim not in (2, 3):
            raise ValueError(f"Geometry supports 2D/3D, got ndim={ndim}")
        if len(li) != ndim:
            raise ValueError("ni and li must have the same length")
        ni = tuple(int(n) for n in ni)
        li = tuple(float(v) for v in li)
        if origin is None:
            origin = (0.0,) * ndim
        origin = tuple(float(o) for o in origin)
        di = tuple(li[d] / ni[d] for d in range(ndim))
        xci, xvi = _lazy_grid(di, ni, li, origin)
        object.__setattr__(self, "ni", ni)
        object.__setattr__(self, "li", li)
        object.__setattr__(self, "origin", origin)
        object.__setattr__(self, "di", di)
        object.__setattr__(self, "xci", xci)
        object.__setattr__(self, "xvi", xvi)
        object.__setattr__(self, "xi_vel", velocity_grids(xci, xvi, di))

    def __hash__(self):
        return hash((self.ni, self.li, self.origin))

    def __eq__(self, other):
        return (
            isinstance(other, Geometry)
            and self.ni == other.ni
            and self.li == other.li
            and self.origin == other.origin
        )

    @property
    def ndim(self) -> int:
        return len(self.ni)

    @property
    def max_li(self) -> float:
        return max(self.li)

    @property
    def min_li(self) -> float:
        return min(self.li)

    @property
    def min_di(self) -> float:
        return min(self.di)

    @property
    def inv_di(self) -> Tuple[float, ...]:
        return tuple(1.0 / d for d in self.di)

    def cell_centers_mesh(self, indexing: str = "ij"):
        return np.meshgrid(*self.xci, indexing=indexing)

    def vertices_mesh(self, indexing: str = "ij"):
        return np.meshgrid(*self.xvi, indexing=indexing)
