"""Staggered-grid velocity interpolation (2D).

Counterpart of ``velocity2vertex`` and ``velocity2center`` of
``justrelax_tpu/ops/interpolation.py``: the ghosted staggered velocities
Vx ``(nx+1, ny+2)`` and Vy ``(nx+2, ny+1)`` averaged onto the vertices
``(nx+1, ny+1)`` or the cell centers ``(nx, ny)``.
"""

from __future__ import annotations

__all__ = ["velocity2vertex", "velocity2center"]


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
