"""Staggered-grid interpolation utilities.

Counterpart of ``justrelax_tpu/ops/interpolation.py``: vertex↔center
averages, the ghosted staggered velocities Vx ``(nx+1, ny+2)`` and Vy
``(nx+2, ny+1)`` averaged onto the vertices ``(nx+1, ny+1)`` or the cell
centers ``(nx, ny)``, shear→center, and the velocity↔displacement
conversions.
"""

from __future__ import annotations

from justrelax_tpu_torch.ops.stencil import av_a, expand_edges, harm_a

__all__ = [
    "vertex2center",
    "center2vertex",
    "center2vertex_harm",
    "velocity2vertex",
    "velocity2center",
    "shear2center",
    "velocity2displacement",
    "displacement2velocity",
]


def vertex2center(vertex):
    """(n+1)^d vertices → n^d centers, plain average."""
    return av_a(vertex)


def center2vertex(center):
    """(nx, ny) centers → (nx+1, ny+1) vertices: the interior 4-point
    average, the boundary rows and columns copied from the adjacent interior
    line (rows first, then columns, so the corners take the diagonal
    interior value)."""
    nx, ny = center.shape
    vertex = center.new_zeros((nx + 1, ny + 1))
    vertex[1:-1, 1:-1] = av_a(center)
    vertex[0, :] = vertex[1, :]
    vertex[-1, :] = vertex[-2, :]
    vertex[:, 0] = vertex[:, 1]
    vertex[:, -1] = vertex[:, -2]
    return vertex


def center2vertex_harm(center):
    """Harmonic center→vertex average with edge-clamped neighbours."""
    return harm_a(expand_edges(center))


def velocity2vertex(Vx, Vy):
    """Ghosted staggered velocities → vertex values (nx+1, ny+1)."""
    Vx_v = 0.5 * (Vx[:, :-1] + Vx[:, 1:])
    Vy_v = 0.5 * (Vy[:-1, :] + Vy[1:, :])
    return Vx_v, Vy_v


def velocity2center(Vx, Vy):
    """Staggered velocities → cell centers (nx, ny)."""
    Vx_c = 0.5 * (Vx[:-1, 1:-1] + Vx[1:, 1:-1])
    Vy_c = 0.5 * (Vy[1:-1, :-1] + Vy[1:-1, 1:])
    return Vx_c, Vy_c


def shear2center(xy_vertex):
    """Vertex shear component → centers."""
    return av_a(xy_vertex)


def velocity2displacement(V, dt):
    """U = V·dt, component by component."""
    return tuple(v * dt for v in V)


def displacement2velocity(U, dt):
    """V = U/dt, component by component."""
    return tuple(u / dt for u in U)
