"""Distributed particle transport, 2D.

Counterpart of ``justrelax_tpu/parallel/particles.py`` (JustPIC's
``move_particles!`` migrating particles between MPI ranks, SURVEY §2.4):

- the slot arrays are blocked like the cell fields (each rank holds its
  cells' ``(nxl, nyl, max_xcell)`` slots), with positions relative to the
  rank's block origin, so every rank shares one local geometry;
- advection samples the velocities extended by one face along each
  component's own axis: the blocks share their boundary face, so the ghost
  is the neighbour's penultimate face (one batch for both components); a
  physical boundary replicates the edge, as the serial clamped bilinear
  does;
- migration extends every slot array by one cell of the neighbours' slots,
  the x slabs of every array in one batch and then the y slabs in another
  (so the corners come from the diagonal neighbour), received positions
  shifted into the local frame and ``active`` carried as ``uint8``; beyond
  a physical boundary the ring holds no particle and position 0, as the
  serial mover's padding does. The serial ``move_particles`` re-slots the
  extended block and its interior is kept: emigrants land in the
  neighbour's interior and in this rank's ring, which is dropped.

CFL ≤ 1 cell per step, as for the serial mover.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.parallel import halo
from justrelax_tpu_torch.particles.particles import _bilinear, _over, move_particles

__all__ = [
    "block_particles",
    "unblock_particles",
    "local_particle_geometry",
    "advect_move_local",
]

_AXES = ("x", "y", "z")
_POS = ("px", "py", "pz")


def block_origins(shape, geometry, ni_local, like):
    """Each cell's block origin along each axis, shaped to broadcast against
    a (…cells, slot) array of ``like``'s dtype and device."""
    out = []
    ndim = len(ni_local)
    for d in range(ndim):
        b = (np.arange(shape[d]) // ni_local[d]) * ni_local[d] * geometry.di[d] \
            + geometry.origin[d]
        sh = [1] * (ndim + 1)
        sh[d] = shape[d]
        out.append(torch.as_tensor(b.reshape(sh), dtype=like.dtype, device=like.device))
    return out


def _shift_positions(particles, geometry, ni_local, sign):
    ndim = len(ni_local)
    names = _POS[:ndim]
    P = [getattr(particles, k) for k in names]
    origins = block_origins(P[0].shape, geometry, ni_local, P[0])
    return particles.replace(**{k: p + sign * o for k, p, o in zip(names, P, origins)})


def block_particles(particles, geometry, decomp):
    """Positions made relative to each cell's block origin (the slot arrays
    are cell-aligned, so they split over the ranks as they are)."""
    return _shift_positions(particles, geometry, decomp.ni_local, -1.0)


def unblock_particles(particles, geometry, decomp):
    """Inverse of :func:`block_particles` (positions back to global)."""
    return _shift_positions(particles, geometry, decomp.ni_local, 1.0)


def local_particle_geometry(decomp, di) -> Tuple[Geometry, Geometry]:
    """(the local block's geometry, the one-cell-extended block's) shared by
    every rank (positions block-relative, origin 0)."""
    nl = decomp.ni_local
    g_loc = Geometry(nl, tuple(n * d for n, d in zip(nl, di)))
    g_ext = Geometry(tuple(n + 2 for n in nl), tuple((n + 2) * d for n, d in zip(nl, di)),
                     origin=tuple(-d for d in di))
    return g_loc, g_ext


def extend_faces(V: Sequence[torch.Tensor]):
    """Each velocity component with one more face on both sides of its own
    axis: the neighbour's penultimate face (the blocks share the boundary
    face), the edge replicated at a physical boundary. One batch."""
    got = halo.swap_many([(_AXES[a], A.narrow(a, 1, 1), A.narrow(a, A.shape[a] - 2, 1))
                          for a, A in enumerate(V)])
    out = []
    for a, (A, (lo, hi)) in enumerate(zip(V, got)):
        lo = A.narrow(a, 0, 1) if lo is None else lo
        hi = A.narrow(a, A.shape[a] - 1, 1) if hi is None else hi
        out.append(torch.cat([lo, A, hi], dim=a))
    return out


def extend_slots(arrays, shifts):
    """Every ``(A, position_axis)`` of ``arrays`` (a (…cells, slot) array and
    the axis whose position it holds, or ``None``) extended by one cell on
    both sides of each grid axis: one batch per axis, received positions
    moved into the local frame by ``shifts[axis]``; beyond a physical
    boundary the new layer is 0."""
    out = [A for A, _ in arrays]
    for axis in range(len(shifts)):
        got = halo.swap_many([(_AXES[axis], A.narrow(axis, 0, 1),
                               A.narrow(axis, A.shape[axis] - 1, 1)) for A in out])
        new = []
        for A, (_, pos_axis), (lo, hi) in zip(out, arrays, got):
            moved = pos_axis == axis
            lo = torch.zeros_like(A.narrow(axis, 0, 1)) if lo is None else (
                lo - shifts[axis] if moved else lo)
            hi = torch.zeros_like(A.narrow(axis, 0, 1)) if hi is None else (
                hi + shifts[axis] if moved else hi)
            new.append(torch.cat([lo, A, hi], dim=axis))
        out = new
    return out


def _filed(v, origin, di):
    """The cell the serial mover files position ``v`` (a 0-d tensor) in, with
    its arithmetic (``move_cells``), before its index clamp."""
    return int(torch.floor(_over(v - origin, di)))


def inside_bounds(lo, hi, g_ext, axis, dtype):
    """``lo``/``hi`` in ``dtype``, moved inward by ulps until the extended
    block's mover files them in its first and last owned cell (in float64
    the block's own bounds stay as they are; in float32 the extent itself
    files in the ring)."""
    origin, di, n = g_ext.origin[axis], g_ext.di[axis], g_ext.ni[axis] - 2
    a, b = torch.tensor(lo, dtype=dtype), torch.tensor(hi, dtype=dtype)
    while _filed(a, origin, di) < 1:
        a = torch.nextafter(a, b)
    while _filed(b, origin, di) > n:
        b = torch.nextafter(b, a)
    return float(a), float(b)


def clamp_physical(new, old, active, li_local, eps, edges):
    """Positions clamped into the domain at physical boundaries only (the
    serial advection's clamp to [ε, extent − ε], in the local frame, the
    upper bound below the extent in the positions' dtype: in float32
    ``extent − 1e-12`` rounds to the extent); inactive slots keep their old
    position."""
    out = []
    for axis, (X, X0) in enumerate(zip(new, old)):
        first, last = edges[axis]
        if first:
            X = torch.clamp_min(X, eps)
        if last:
            top = torch.tensor(li_local[axis], dtype=X.dtype)
            hi = torch.minimum(torch.tensor(li_local[axis] - eps, dtype=X.dtype),
                               torch.nextafter(top, torch.zeros_like(top)))
            X = torch.clamp_max(X, float(hi))
        out.append(torch.where(active, X, X0))
    return out


def migrate(particles, fields: Dict[str, torch.Tensor], positions, g_loc, g_ext, move):
    """Extend the slots (positions, ``active`` as ``uint8``, the fields) by
    one cell of the neighbours', re-slot the extended block with the serial
    ``move`` and keep its interior.

    Which rank keeps a particle is decided exactly, in the frame it was
    advected in: along each axis its side of the block (−1 below 0, +1 at
    or above the extent, as ``int8``) rides with it, and a slot of the
    extended block stays active only where that side matches the ring it
    came to. Its position is then kept inside the owned cells by ulps
    (:func:`inside_bounds`): the frames' shifts round apart, and a particle
    within an ulp of a block face could otherwise be filed by both ranks or
    by neither (in float32 a few per 10⁷ particles; in float64 the bounds
    move nothing)."""
    ndim = len(positions)
    names = _POS[:ndim]
    sides = [((X >= li).to(torch.int8) - (X < 0).to(torch.int8))
             for X, li in zip(positions, g_loc.li)]
    items = [(X, a) for a, X in enumerate(positions)]
    items.append((particles.active.to(torch.uint8), None))
    items += [(sd, None) for sd in sides]
    items += [(v, None) for v in fields.values()]
    ext = extend_slots(items, g_loc.li)
    pos_e, active_e = list(ext[:ndim]), ext[ndim] != 0
    sides_e, f_e = ext[ndim + 1:2 * ndim + 1], ext[2 * ndim + 1:]
    for d in range(ndim):
        n = g_ext.ni[d]
        # the side a particle in each layer came from: +1 from the lower
        # neighbour's block, −1 from the higher one's, 0 its own
        want = torch.zeros(n, dtype=torch.int8, device=active_e.device)
        want[0], want[-1] = 1, -1
        shape = [1] * (ndim + 1)
        shape[d] = n
        active_e = active_e & (sides_e[d] == want.reshape(shape))
        lo, hi = inside_bounds(0.0, g_loc.li[d], g_ext, d, pos_e[d].dtype)
        pos_e[d] = torch.clamp(pos_e[d], lo, hi)
    p_ext = particles.replace(active=active_e, **dict(zip(names, pos_e)))
    p_new, f_new = move(p_ext, g_ext, dict(zip(fields, f_e)))
    inner = (slice(1, -1),) * ndim
    out = particles.replace(active=p_new.active[inner],
                            **{k: getattr(p_new, k)[inner] for k in names})
    return out, {k: v[inner] for k, v in f_new.items()}


def advect_move_local(
    particles,
    fields: Dict[str, torch.Tensor],
    Vx,
    Vy,
    decomp,
    di,
    dt,
):
    """On a rank's tiles (inside ``with mesh:``): midpoint RK2 advection on
    the face-extended local velocities, then the migration across the ranks
    and the re-slotting. Positions are block-relative; ``dt`` a Python
    float. Returns (particles, fields)."""
    dx, dy = di
    g_loc, g_ext = local_particle_geometry(decomp, di)
    edges = tuple(halo.axis_edges(a) for a in _AXES[:2])
    Vx_e, Vy_e = extend_faces((Vx, Vy))  # faces −1 … nxl+1 along their axis

    def vel(X, Y):
        return (_bilinear(Vx_e, -dx, -dy / 2, dx, dy, X, Y),
                _bilinear(Vy_e, -dx / 2, -dy, dx, dy, X, Y))

    X, Y = particles.px, particles.py
    vx1, vy1 = vel(X, Y)
    vx2, vy2 = vel(X + 0.5 * dt * vx1, Y + 0.5 * dt * vy1)
    # the serial advection's ε, from the global extents
    lx, ly = g_loc.li
    eps = 1e-12 * max(decomp.px * lx, decomp.py * ly)
    new = clamp_physical((X + dt * vx2, Y + dt * vy2), (X, Y), particles.active, g_loc.li,
                         eps, edges)
    return migrate(particles, fields, new, g_loc, g_ext, move_particles)
