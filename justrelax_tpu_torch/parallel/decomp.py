"""Domain decomposition: blocked-local containers for staggered arrays.

Counterpart of ``justrelax_tpu/parallel/decomp.py`` (numpy only). The global
cell grid ``(nx_g, ny_g)`` is split into disjoint per-rank tiles of
``(nxl, nyl)`` cells over a ``(px, py)`` mesh. Center arrays split evenly.
Staggered arrays (velocities with shared faces and ghost transverse rows,
vertex arrays with shared edges, ghosted temperature) are stored as
*blocked-local containers*: an array of shape ``(px·sx, py·sy)`` whose
``(rx, ry)`` tile is exactly the local staggered block an MPI rank would
hold (reference ImplicitGlobalGrid local arrays).

The conversions here run on the host, for problem set-up and for gathering
results back to true global arrays (the analogue of the reference's
``gather!``); :func:`~justrelax_tpu_torch.io.vtk.save_pvtk` reads a
:class:`Decomp2D`'s ``nxl``, ``nyl``, ``px`` and ``py``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["Decomp2D", "Decomp3D", "block_staggered", "unblock_staggered",
           "block_staggered_nd", "unblock_staggered_nd"]


@dataclasses.dataclass(frozen=True)
class Decomp2D:
    """2D decomposition of ``(nx_g, ny_g)`` cells over a ``(px, py)`` mesh."""

    px: int
    py: int
    nxl: int  # owned cells per rank along x
    nyl: int

    @classmethod
    def make(cls, ni_global: Tuple[int, int], mesh_shape: Tuple[int, int]) -> "Decomp2D":
        (nx_g, ny_g), (px, py) = ni_global, mesh_shape
        if nx_g % px or ny_g % py:
            raise ValueError(
                f"global grid {ni_global} not divisible by mesh {mesh_shape}"
            )
        return cls(px=px, py=py, nxl=nx_g // px, nyl=ny_g // py)

    @property
    def ni_global(self) -> Tuple[int, int]:
        return (self.px * self.nxl, self.py * self.nyl)

    @property
    def ni_local(self) -> Tuple[int, int]:
        return (self.nxl, self.nyl)


def block_staggered(A: np.ndarray, decomp: Decomp2D, extra: Tuple[int, int]) -> np.ndarray:
    """Global staggered array → blocked-local container.

    ``extra[d]`` is the per-tile surplus over owned cells along dim d:
    0 for center arrays, 1 for shared faces/vertices, 2 for ghosted/velocity
    transverse dims. Tile (rx, ry) receives
    ``A[rx·nxl : rx·nxl + nxl+ex, ry·nyl : ry·nyl + nyl+ey]``.
    """
    nxl, nyl = decomp.nxl, decomp.nyl
    ex, ey = extra
    sx, sy = nxl + ex, nyl + ey
    want = (decomp.px * nxl + ex, decomp.py * nyl + ey)
    if A.shape != want:
        raise ValueError(f"global array of shape {A.shape}, expected {want}")
    out = np.empty((decomp.px * sx, decomp.py * sy), dtype=A.dtype)
    for rx in range(decomp.px):
        for ry in range(decomp.py):
            tile = A[rx * nxl : rx * nxl + sx, ry * nyl : ry * nyl + sy]
            out[rx * sx : (rx + 1) * sx, ry * sy : (ry + 1) * sy] = tile
    return out


def unblock_staggered(B: np.ndarray, decomp: Decomp2D, extra: Tuple[int, int]) -> np.ndarray:
    """Blocked-local container → global staggered array (inverse of
    :func:`block_staggered`; overlapping entries taken from the lower tile)."""
    nxl, nyl = decomp.nxl, decomp.nyl
    ex, ey = extra
    sx, sy = nxl + ex, nyl + ey
    out = np.empty((decomp.px * nxl + ex, decomp.py * nyl + ey), dtype=B.dtype)
    for rx in range(decomp.px):
        for ry in range(decomp.py):
            tile = B[rx * sx : (rx + 1) * sx, ry * sy : (ry + 1) * sy]
            out[rx * nxl : rx * nxl + sx, ry * nyl : ry * nyl + sy] = tile
    return out


@dataclasses.dataclass(frozen=True)
class Decomp3D:
    """3D decomposition of ``(nx_g, ny_g, nz_g)`` cells over ``(px, py, pz)``."""

    px: int
    py: int
    pz: int
    nxl: int
    nyl: int
    nzl: int

    @classmethod
    def make(cls, ni_global, mesh_shape) -> "Decomp3D":
        if any(n % p for n, p in zip(ni_global, mesh_shape)):
            raise ValueError(
                f"global grid {ni_global} not divisible by mesh {mesh_shape}"
            )
        (nx, ny, nz), (px, py, pz) = ni_global, mesh_shape
        return cls(px=px, py=py, pz=pz, nxl=nx // px, nyl=ny // py, nzl=nz // pz)

    @property
    def ni_global(self):
        return (self.px * self.nxl, self.py * self.nyl, self.pz * self.nzl)

    @property
    def ni_local(self):
        return (self.nxl, self.nyl, self.nzl)

    @property
    def mesh_shape(self):
        return (self.px, self.py, self.pz)


def block_staggered_nd(A: np.ndarray, nl, p, extra) -> np.ndarray:
    """N-D generalization of :func:`block_staggered`: ``nl``/``p``/``extra``
    are per-axis owned-cell counts, mesh sizes, and per-tile surpluses."""
    ndim = A.ndim
    s = tuple(nl[d] + extra[d] for d in range(ndim))
    want = tuple(p[d] * nl[d] + extra[d] for d in range(ndim))
    if A.shape != want:
        raise ValueError(f"global array of shape {A.shape}, expected {want}")
    out = np.empty(tuple(p[d] * s[d] for d in range(ndim)), dtype=A.dtype)
    for idx in np.ndindex(*p):
        src = tuple(
            slice(idx[d] * nl[d], idx[d] * nl[d] + s[d]) for d in range(ndim)
        )
        dst = tuple(
            slice(idx[d] * s[d], (idx[d] + 1) * s[d]) for d in range(ndim)
        )
        out[dst] = A[src]
    return out


def unblock_staggered_nd(B: np.ndarray, nl, p, extra) -> np.ndarray:
    """Inverse of :func:`block_staggered_nd` (overlapping entries taken from
    the lower tile)."""
    ndim = B.ndim
    s = tuple(nl[d] + extra[d] for d in range(ndim))
    out = np.empty(tuple(p[d] * nl[d] + extra[d] for d in range(ndim)), dtype=B.dtype)
    for idx in np.ndindex(*p):
        src = tuple(
            slice(idx[d] * s[d], (idx[d] + 1) * s[d]) for d in range(ndim)
        )
        dst = tuple(
            slice(idx[d] * nl[d], idx[d] * nl[d] + s[d]) for d in range(ndim)
        )
        out[dst] = B[src]
    return out
