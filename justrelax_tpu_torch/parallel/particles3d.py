"""Distributed particle transport, 3D.

Counterpart of ``justrelax_tpu/parallel/particles3d.py`` (JustPIC._3D's
``move_particles!`` MPI migration, SURVEY §2.4), the 3D twin of
:mod:`~justrelax_tpu_torch.parallel.particles`: blocked slot arrays with
block-relative positions, RK2 advection on the velocities extended by one
face along each component's own axis (the neighbour's penultimate face; the
transverse ghost layers come with the blocked velocities), and migration by
extending every slot array one cell per side (three axis passes, one batch
each, ``active`` as ``uint8``), re-slotting the extended block with the
serial ``move_particles_3d`` and keeping its interior.

CFL ≤ 1 cell per step, as for the serial mover.
"""

from __future__ import annotations

from typing import Dict, Tuple

from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.parallel import halo
from justrelax_tpu_torch.parallel.particles import (
    block_particles,
    clamp_physical,
    extend_faces,
    local_particle_geometry,
    migrate,
    unblock_particles,
)
from justrelax_tpu_torch.particles.particles3d import _trilinear, move_particles_3d

__all__ = [
    "block_particles_3d",
    "unblock_particles_3d",
    "local_particle_geometry_3d",
    "advect_move_local_3d",
]


def block_particles_3d(particles, geometry, decomp):
    """Positions made relative to each cell's block origin."""
    return block_particles(particles, geometry, decomp)


def unblock_particles_3d(particles, geometry, decomp):
    """Inverse of :func:`block_particles_3d`."""
    return unblock_particles(particles, geometry, decomp)


def local_particle_geometry_3d(decomp, di) -> Tuple[Geometry, Geometry]:
    """(the local block's geometry, the one-cell-extended block's)."""
    return local_particle_geometry(decomp, di)


def advect_move_local_3d(
    particles,
    fields: Dict,
    Vx,
    Vy,
    Vz,
    decomp,
    di,
    dt,
):
    """On a rank's tiles (inside ``with mesh:``): midpoint RK2 advection,
    then the migration across the ranks and the re-slotting. Positions are
    block-relative; ``dt`` a Python float. Returns (particles, fields)."""
    dx, dy, dz = di
    g_loc, g_ext = local_particle_geometry(decomp, di)
    edges = tuple(halo.axis_edges(a) for a in ("x", "y", "z"))
    Vx_e, Vy_e, Vz_e = extend_faces((Vx, Vy, Vz))

    def vel(X, Y, Z):
        return (_trilinear(Vx_e, -dx, -dy / 2, -dz / 2, dx, dy, dz, X, Y, Z),
                _trilinear(Vy_e, -dx / 2, -dy, -dz / 2, dx, dy, dz, X, Y, Z),
                _trilinear(Vz_e, -dx / 2, -dy / 2, -dz, dx, dy, dz, X, Y, Z))

    X, Y, Z = particles.px, particles.py, particles.pz
    v1 = vel(X, Y, Z)
    v2 = vel(X + 0.5 * dt * v1[0], Y + 0.5 * dt * v1[1], Z + 0.5 * dt * v1[2])
    # the serial advection's ε, from the global extents
    lx, ly, lz = g_loc.li
    eps = 1e-12 * max(decomp.px * lx, decomp.py * ly, decomp.pz * lz)
    new = clamp_physical((X + dt * v2[0], Y + dt * v2[1], Z + dt * v2[2]), (X, Y, Z),
                         particles.active, g_loc.li, eps, edges)
    return migrate(particles, fields, new, g_loc, g_ext, move_particles_3d)
