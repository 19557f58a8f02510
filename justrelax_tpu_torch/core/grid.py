"""Staggered Cartesian grid geometry, uniform and nonuniform.

Counterpart of ``justrelax_tpu/core/grid.py``: cell counts, domain lengths,
origin, spacings and the coordinate vectors of cell centers, vertices and
the ghosted velocity grids. Geometry is host-side metadata (plain floats and
numpy arrays); a uniform grid's solvers read ``di`` from it, a nonuniform
grid's (``NonuniformGeometry``) turn its spacing families into tensors once
per solve, in the state's dtype and on its device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["Geometry", "NonuniformGeometry", "spacing_tensors", "velocity_grids"]


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


@dataclasses.dataclass(frozen=True, init=False)
class NonuniformGeometry(Geometry):
    """A staggered grid with per-axis vector spacing, built from the vertex
    coordinate vectors of each axis. Besides the uniform grid's fields it
    holds two spacing families (tuples of floats per axis):

    - ``di_center[d]`` (ni[d],): the cell widths xv[i+1] − xv[i], for the
      divergences and cell updates;
    - ``di_vertex[d]`` (ni[d]+1,): the face spacings xc[i] − xc[i−1],
      clamped to the edge cell width at the two boundary faces, for the
      gradients and fluxes.

    ``di`` is the minimum spacing per axis (the CFL and PT coefficients);
    the ghost nodes of ``xi_vel`` sit one edge cell width outside. Equality
    and hash go by (ni, origin, di_center)."""

    di_center: Tuple[Tuple[float, ...], ...]
    di_vertex: Tuple[Tuple[float, ...], ...]

    def __init__(self, vertex_coords):
        xvi = tuple(np.asarray(v, dtype=float) for v in vertex_coords)
        ndim = len(xvi)
        if ndim not in (2, 3):
            raise ValueError(f"NonuniformGeometry supports 2D/3D, got {ndim}")
        for v in xvi:
            if v.ndim != 1 or v.size < 2 or np.any(np.diff(v) <= 0):
                raise ValueError("vertex coordinates must be strictly increasing 1D vectors")
        ni = tuple(int(v.size - 1) for v in xvi)
        xci = tuple(0.5 * (v[1:] + v[:-1]) for v in xvi)
        dc = tuple(np.diff(v) for v in xvi)
        dv = tuple(np.concatenate(([d[0]], np.diff(c), [d[-1]])) for c, d in zip(xci, dc))
        ghosted = tuple(np.concatenate(([c[0] - d[0]], c, [c[-1] + d[-1]]))
                        for c, d in zip(xci, dc))
        xi_vel = tuple(tuple(xvi[d] if d == comp else ghosted[d] for d in range(ndim))
                       for comp in range(ndim))
        object.__setattr__(self, "ni", ni)
        object.__setattr__(self, "li", tuple(float(v[-1] - v[0]) for v in xvi))
        object.__setattr__(self, "origin", tuple(float(v[0]) for v in xvi))
        object.__setattr__(self, "di", tuple(float(d.min()) for d in dc))
        object.__setattr__(self, "xci", xci)
        object.__setattr__(self, "xvi", xvi)
        object.__setattr__(self, "xi_vel", xi_vel)
        object.__setattr__(self, "di_center", tuple(tuple(map(float, d)) for d in dc))
        object.__setattr__(self, "di_vertex", tuple(tuple(map(float, d)) for d in dv))

    def __hash__(self):
        return hash((self.ni, self.di_center, self.origin))

    def __eq__(self, other):
        return (
            isinstance(other, NonuniformGeometry)
            and self.ni == other.ni
            and self.origin == other.origin
            and self.di_center == other.di_center
        )

    def _bcast(self, vecs):
        """Each axis's vector shaped to broadcast along that axis, float64."""
        ndim = len(self.ni)
        return tuple(np.asarray(v, dtype=float).reshape([len(v) if a == d else 1
                                                         for a in range(ndim)])
                     for d, v in enumerate(vecs))

    @property
    def inv_flux_di(self):
        """Broadcastable 1/spacing arrays of the face gradients (fluxes)."""
        return tuple(1.0 / a for a in self._bcast(self.di_vertex))

    @property
    def inv_div_di(self):
        """Broadcastable 1/spacing arrays of the cell divergences."""
        return tuple(1.0 / a for a in self._bcast(self.di_center))


def spacing_tensors(geometry, like):
    """``(inv_flux_di, inv_div_di)`` of a ``NonuniformGeometry`` (the
    broadcastable reciprocal face spacings and cell widths, taken in float64
    numpy as the JAX package takes them) made tensors once, in ``like``'s
    dtype and on its device; ``None`` on a uniform grid. Every solver's
    spacing families are these or views of them."""
    if not isinstance(geometry, NonuniformGeometry):
        return None
    return tuple(tuple(torch.as_tensor(a, dtype=like.dtype, device=like.device) for a in arrays)
                 for arrays in (geometry.inv_flux_di, geometry.inv_div_di))
