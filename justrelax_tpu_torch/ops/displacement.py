"""Displacement ↔ velocity conversion of a Stokes state (the strain-increment
formulation).

Counterpart of ``justrelax_tpu/ops/displacement.py``. With a fixed time step
the displacement formulation is the velocity one scaled: U = V·dt. A
displacement-driven problem applies its BCs to U
(``DisplacementBoundaryConditions``), converts to V at solve entry and back
to U after the solve.
"""

from __future__ import annotations

from justrelax_tpu_torch.ops.bc import (
    DisplacementBoundaryConditions,
    VelocityBoundaryConditions,
)

__all__ = ["velocity2displacement", "displacement2velocity"]


def velocity2displacement(stokes, dt):
    """U ← V·dt on every node."""
    V = stokes.V
    U = stokes.U.replace(
        Ux=V.Vx * dt,
        Uy=V.Vy * dt,
        Uz=None if V.Vz is None else V.Vz * dt,
    )
    return stokes.replace(U=U)


def displacement2velocity(stokes, dt, flow_bc=None):
    """V ← U/dt. A velocity-driven problem (``flow_bc`` a
    ``VelocityBoundaryConditions`` that is not a
    ``DisplacementBoundaryConditions``) is returned unchanged."""
    if isinstance(flow_bc, VelocityBoundaryConditions) \
            and not isinstance(flow_bc, DisplacementBoundaryConditions):
        return stokes
    U = stokes.U
    inv_dt = 1.0 / dt
    V = stokes.V.replace(
        Vx=U.Ux * inv_dt,
        Vy=U.Uy * inv_dt,
        Vz=None if U.Uz is None else U.Uz * inv_dt,
    )
    return stokes.replace(V=V)
