"""Taylor-Green 3D manufactured Stokes benchmark (FVCA8 benchmark, Angeli et
al., HAL cea-02434556).

Counterpart of ``justrelax_tpu/models/taylor_green.py``: η = 1 on [0,1]³ with
body force f = (−36π² cos(2πx) sin(2πy) sin(2πz), 0, 0) and Dirichlet
boundary velocities from the analytic solution

  u = (−2 cos sin sin,  sin cos sin,  sin sin cos)·(2πx, 2πy, 2πz)
  p = −6π sin(2πx) sin(2πy) sin(2πz).

The momentum residual is ∇·τ − ∇P − ρg, so the force enters as ρg = −f, and
``boundary_shear=True`` updates the Dirichlet boundary's shear stresses.
Like Burstedde, it runs on the plain path (``use_kernel=False``): imposed
velocities, ``mean_free_RP`` and ``boundary_shear`` lie outside the 3D VE
chunk kernel's contract.
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

__all__ = ["run", "analytic_fields"]

TWO_PI = 2.0 * np.pi


def _vx(x, y, z):
    return -2.0 * np.cos(TWO_PI * x) * np.sin(TWO_PI * y) * np.sin(TWO_PI * z)


def _vy(x, y, z):
    return np.sin(TWO_PI * x) * np.cos(TWO_PI * y) * np.sin(TWO_PI * z)


def _vz(x, y, z):
    return np.sin(TWO_PI * x) * np.sin(TWO_PI * y) * np.cos(TWO_PI * z)


def _pressure(x, y, z):
    return -6.0 * np.pi * np.sin(TWO_PI * x) * np.sin(TWO_PI * y) * np.sin(TWO_PI * z)


def _boundary_velocity(geometry, dtype, device):
    """The analytic velocity on every boundary and ghost node, zero inside
    (the solver never writes the boundary faces)."""
    xc, yc, zc = geometry.xci
    xv, yv, zv = geometry.xvi
    dx, dy, dz = geometry.di
    gx = np.concatenate(([xc[0] - dx], xc, [xc[-1] + dx]))
    gy = np.concatenate(([yc[0] - dy], yc, [yc[-1] + dy]))
    gz = np.concatenate(([zc[0] - dz], zc, [zc[-1] + dz]))

    def mesh(f, xs, ys, zs):
        A = f(*np.meshgrid(xs, ys, zs, indexing="ij"))
        A[1:-1, 1:-1, 1:-1] = 0.0
        return torch.as_tensor(A, dtype=dtype, device=device)

    return mesh(_vx, xv, gy, gz), mesh(_vy, gx, yv, gz), mesh(_vz, gx, gy, zv)


def run(n=16, iter_max=100_000, nout=1_000, dtype=None, geometry=None, device=None):
    """The Taylor-Green solve on the plain path; returns (geometry, stokes,
    info). ``geometry`` overrides the uniform unit-cube grid: a
    ``NonuniformGeometry`` runs the same manufactured solution on its
    vector spacings, the forcing and the boundary values sampled on its own
    coordinates (the ghost nodes one ``di``, the minimum spacing, outside,
    as the JAX model places them). ``device`` defaults to the card."""
    if geometry is None:
        ni = (n, n, n)
        geometry = Geometry(ni, (1.0, 1.0, 1.0))
    else:
        ni = geometry.ni
    device = resolve_device(device)
    stokes = StokesState.make(ni, dtype=dtype, device=device)
    f = dict(dtype=stokes.P.dtype, device=device)

    X, Y, Z = geometry.cell_centers_mesh()
    fx = -36.0 * np.pi**2 * np.cos(TWO_PI * X) * np.sin(TWO_PI * Y) * np.sin(TWO_PI * Z)
    zeros = np.zeros(ni)
    rho_g = tuple(torch.as_tensor(-c, **f) for c in (fx, zeros, zeros))

    stokes = stokes.replace(viscosity=stokes.viscosity.replace(eta=torch.ones(ni, **f)))
    Vx, Vy, Vz = _boundary_velocity(geometry, f["dtype"], device)
    stokes = stokes.replace(V=stokes.V.replace(Vx=Vx, Vy=Vy, Vz=Vz))

    pt_stokes = PTStokesCoeffs.make(geometry.li, geometry.di, CFL=1.0 / math.sqrt(3.0))
    flow_bc = VelocityBoundaryConditions()  # imposed analytic boundary values
    G = torch.full(ni, math.inf, **f)
    K = torch.full(ni, math.inf, **f)
    stokes, info = solve_ve_3d(
        stokes, pt_stokes, geometry, flow_bc, rho_g, G, K, math.inf,
        iter_max=iter_max, nout=nout, mean_free_RP=True, boundary_shear=True,
        use_kernel=False)
    return geometry, stokes, info


def analytic_fields(geometry):
    """The analytic Vx, Vy, Vz on their faces and P at the centers, numpy."""
    xc, yc, zc = geometry.xci
    xv, yv, zv = geometry.xvi
    Vx = _vx(*np.meshgrid(xv, yc, zc, indexing="ij"))
    Vy = _vy(*np.meshgrid(xc, yv, zc, indexing="ij"))
    Vz = _vz(*np.meshgrid(xc, yc, zv, indexing="ij"))
    P = _pressure(*np.meshgrid(xc, yc, zc, indexing="ij"))
    return Vx, Vy, Vz, P
