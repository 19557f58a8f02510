"""Burstedde 3D Stokes benchmark with an analytic solution (Burstedde et al.
2013, GJI).

Counterpart of ``justrelax_tpu/models/burstedde.py``: the unit cube, a
smoothly varying viscosity η = exp(1 − β Σ xᵢ(1−xᵢ)) with β = 10, a
polynomial manufactured body force, and the analytic velocity imposed on the
outermost layers of every velocity array. Oracle: Vx within 5e-2 (relative
L2 on the mid plane) of the analytic solution at 16³ (``bench.py``), and a
final residual < 1e-8 (tests/test_stokes_burstedde.py).

The solve imposes velocities and needs ``mean_free_RP`` and
``boundary_shear``, which the 3D VE chunk kernel does not take, so it runs
on the plain path (``use_kernel=False``) on every device, as the JAX
package runs it without Pallas.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs
from justrelax_tpu_torch.core.device import resolve_device
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.core.state import StokesState
from justrelax_tpu_torch.ops.bc import VelocityBoundaryConditions
from justrelax_tpu_torch.solvers.stokes3d import solve_ve_3d

__all__ = ["BETA", "run", "analytic_velocity"]

BETA = 10.0


def _viscosity(xc, yc, zc, beta):
    X, Y, Z = np.meshgrid(xc, yc, zc, indexing="ij")
    return np.exp(1.0 - beta * (X * (1 - X) + Y * (1 - Y) + Z * (1 - Z))), (X, Y, Z)


def _body_forces(X, Y, Z, eta, beta):
    detadx = -beta * (1 - 2 * X) * eta
    detady = -beta * (1 - 2 * Y) * eta
    detadz = -beta * (1 - 2 * Z) * eta
    fx = (
        (Y * Z + 3 * X**2 * Y**3 * Z)
        - eta * (2 + 6 * X * Y)
        - detadx * (2 + 4 * X + 2 * Y + 6 * X**2 * Y)
        - detady * (X + X**3 + Y + 2 * X * Y**2)
        - detadz * (-3 * Z - 10 * X * Y * Z)
    )
    fy = (
        (X * Z + 3 * X**3 * Y**2 * Z)
        - eta * (2 + 2 * X**2 + 2 * Y**2)
        - detadx * (X + X**3 + Y + 2 * X * Y**2)
        - detady * (2 + 2 * X + 4 * Y + 4 * X**2 * Y)
        - detadz * (-3 * Z - 5 * X**2 * Z)
    )
    fz = (
        (X * Y + X**3 * Y**3)
        - eta * (-10 * Y * Z)
        - detadx * (-3 * Z - 10 * X * Y * Z)
        - detady * (-3 * Z - 5 * X**2 * Z)
        - detadz * (-4 - 6 * X - 6 * Y - 10 * X**2 * Y)
    )
    return fx, fy, fz


def _vx(x, y):
    return x + x**2 + x * y + x**3 * y


def _vy(x, y):
    return y + x * y + y**2 + x**2 * y**2


def _vz(x, y, z):
    return -2 * z - 3 * x * z - 3 * y * z - 5 * x**2 * y * z


def _boundary_velocity(geometry, dtype, device):
    """Analytic velocity on the outermost layers of each velocity array,
    zero inside."""
    (nx, ny, nz) = geometry.ni
    xv, yv, zv = geometry.xvi
    # ghosted center coordinates
    gx, gy, gz = (
        np.concatenate(([c[0] - d], c, [c[-1] + d]))
        for c, d in zip(geometry.xci, geometry.di)
    )

    def fill(shape, coords, fn):
        A = np.zeros(shape)
        X, Y, Z = np.meshgrid(*coords, indexing="ij")
        vals = fn(X, Y, Z)
        m = np.zeros(shape, dtype=bool)
        for ax in range(3):
            sl = [slice(None)] * 3
            sl[ax] = 0
            m[tuple(sl)] = True
            sl[ax] = shape[ax] - 1
            m[tuple(sl)] = True
        A[m] = vals[m]
        return torch.as_tensor(A, dtype=dtype, device=device)

    Vx = fill((nx + 1, ny + 2, nz + 2), (xv, gy, gz), lambda X, Y, Z: _vx(X, Y))
    Vy = fill((nx + 2, ny + 1, nz + 2), (gx, yv, gz), lambda X, Y, Z: _vy(X, Y))
    Vz = fill((nx + 2, ny + 2, nz + 1), (gx, gy, zv), lambda X, Y, Z: _vz(X, Y, Z))
    return Vx, Vy, Vz


def run(nx=16, ny=16, nz=16, iter_max=100_000, nout=1_000, dtype=None, device=None):
    """The Burstedde solve on the plain path; returns (geometry, stokes,
    info). ``device`` defaults to the card."""
    device = resolve_device(device)
    ni = (nx, ny, nz)
    geometry = Geometry(ni, (1.0, 1.0, 1.0))
    stokes = StokesState.make(ni, dtype=dtype, device=device)
    f = dict(dtype=stokes.P.dtype, device=device)

    eta_np, (X, Y, Z) = _viscosity(*geometry.xci, BETA)
    fx, fy, fz = _body_forces(X, Y, Z, eta_np, BETA)
    stokes = stokes.replace(viscosity=stokes.viscosity.replace(eta=torch.as_tensor(eta_np, **f)))
    # ρg enters the momentum residual as −ρg; the analytic solution satisfies
    # ∇·τ − ∇P = −f, so the force enters as −f
    rho_g = tuple(torch.as_tensor(-c, **f) for c in (fx, fy, fz))

    Vx, Vy, Vz = _boundary_velocity(geometry, f["dtype"], device)
    stokes = stokes.replace(V=stokes.V.replace(Vx=Vx, Vy=Vy, Vz=Vz))

    pt_stokes = PTStokesCoeffs.make(geometry.li, geometry.di, CFL=1.0 / math.sqrt(3.0))
    flow_bc = VelocityBoundaryConditions()  # all faces: imposed analytic values
    G = torch.full(ni, math.inf, **f)
    K = torch.full(ni, math.inf, **f)
    stokes, info = solve_ve_3d(
        stokes, pt_stokes, geometry, flow_bc, rho_g, G, K, math.inf,
        iter_max=iter_max, nout=nout, mean_free_RP=True, boundary_shear=True,
        use_kernel=False)
    return geometry, stokes, info


def analytic_velocity(geometry):
    """The analytic Vx on (xv, yc) and Vy on (xc, yv), numpy."""
    xv, yv, zv = geometry.xvi
    xc, yc, zc = geometry.xci
    Vx = _vx(*np.meshgrid(xv, yc, indexing="ij"))
    Vy = _vy(*np.meshgrid(xc, yv, indexing="ij"))
    return Vx, Vy
