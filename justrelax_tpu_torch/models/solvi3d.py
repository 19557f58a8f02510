"""SolVi 3D: a spherical viscous inclusion under far-field pure shear.

Counterpart of ``justrelax_tpu/models/solvi3d.py``: a Δη = 1e-3 inclusion of
radius rc in a 10³ box, the viscosity smoothed by 10 Jacobi passes, a
visco-elastic solve with G = 1, dt = ∞, K = ∞, free slip on all six faces.
Oracle: norm_Rx < 1e-8 at 16³ within 5 000 iterations
(tests/test_solvi3d.py). The background field is the incompressible
plane-strain pure shear Vx = ε̇·x, Vy = 0, Vz = −ε̇·z.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs
from justrelax_tpu_torch.core.device import resolve_device
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.core.state import StokesState
from justrelax_tpu_torch.ops.bc import Faces, VelocityBoundaryConditions, flow_bcs
from justrelax_tpu_torch.solvers.stokes3d import solve_ve_3d

__all__ = ["run", "smooth_viscosity_3d", "pureshear_bc_3d"]


def smooth_viscosity_3d(eta, n_pass: int = 10, fact: float = 1.0):
    """Interior Jacobi smoothing: η ← η + (1/6.1/fact)·Σ ∂²η along each
    axis, ``n_pass`` times; the boundary layer is left as it is. Returns a
    new tensor."""
    c = 1.0 / 6.1 / fact
    eta = eta.clone()
    for _ in range(n_pass):
        lap = (
            eta[:-2, 1:-1, 1:-1] - 2 * eta[1:-1, 1:-1, 1:-1] + eta[2:, 1:-1, 1:-1]
            + eta[1:-1, :-2, 1:-1] - 2 * eta[1:-1, 1:-1, 1:-1] + eta[1:-1, 2:, 1:-1]
            + eta[1:-1, 1:-1, :-2] - 2 * eta[1:-1, 1:-1, 1:-1] + eta[1:-1, 1:-1, 2:]
        )
        eta[1:-1, 1:-1, 1:-1] += c * lap
    return eta


def pureshear_bc_3d(Vx, Vy, Vz, xvi, eps_bg):
    """Incompressible plane-strain pure shear: Vx = ε̇·xv on all Vx nodes,
    Vz = −ε̇·zv on all Vz nodes, Vy = 0. Returns new tensors."""
    xv = torch.as_tensor(xvi[0], dtype=Vx.dtype, device=Vx.device)
    zv = torch.as_tensor(xvi[2], dtype=Vz.dtype, device=Vz.device)
    Vx = (eps_bg * xv)[:, None, None].expand(Vx.shape).contiguous()
    Vz = (-eps_bg * zv)[None, None, :].expand(Vz.shape).contiguous()
    return Vx, torch.zeros_like(Vy), Vz


def _setup(nx=16, ny=16, nz=16, d_eta=1.0e-3, rc=1.0, eps_bg=1.0, lx=10.0, ly=10.0,
           lz=10.0, dtype=None, device=None):
    """Grid, initial state, PT coefficients, BCs, ρg, moduli and time step
    of the solve, on ``device`` (the card unless given)."""
    device = resolve_device(device)
    ni = (nx, ny, nz)
    li = (lx, ly, lz)
    geometry = Geometry(ni, li)
    stokes = StokesState.make(ni, dtype=dtype, device=device)
    f = dict(dtype=stokes.P.dtype, device=device)

    # spherical inclusion at the box center, then 10 smoothing passes
    X = geometry.cell_centers_mesh()
    rr = np.sqrt((X[0] - lx / 2) ** 2 + (X[1] - ly / 2) ** 2 + (X[2] - lz / 2) ** 2)
    eta = smooth_viscosity_3d(torch.as_tensor(np.where(rr <= rc, d_eta, 1.0), **f))
    stokes = stokes.replace(viscosity=stokes.viscosity.replace(eta=eta))

    V = pureshear_bc_3d(stokes.V.Vx, stokes.V.Vy, stokes.V.Vz, geometry.xvi, eps_bg)
    flow_bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True, front=True, back=True))
    Vx, Vy, Vz = flow_bcs(V, flow_bc)
    stokes = stokes.replace(V=stokes.V.replace(Vx=Vx, Vy=Vy, Vz=Vz))

    pt_stokes = PTStokesCoeffs.make(
        li, geometry.di, CFL=1.0 / math.sqrt(3.0), eps_rel=1.0e-12, eps_abs=1.0e-9)
    zeros = torch.zeros(ni, **f)
    G = torch.full(ni, 1.0, **f)
    K = torch.tensor(math.inf, **f)
    return geometry, stokes, pt_stokes, flow_bc, (zeros, zeros, zeros), G, K, math.inf


def run(nx=16, ny=16, nz=16, d_eta=1.0e-3, rc=1.0, eps_bg=1.0, lx=10.0, ly=10.0,
        lz=10.0, iter_max=5_000, nout=100, dtype=None, device=None, use_kernel=None):
    """The SolVi 3D solve (dt = ∞); returns (geometry, stokes, info).
    ``device`` defaults to the card; ``use_kernel`` to the Hopper kernel on
    the card and the plain path on the CPU (``False`` asks for the plain
    path)."""
    geometry, stokes, pt_stokes, flow_bc, rho_g, G, K, dt = _setup(
        nx, ny, nz, d_eta, rc, eps_bg, lx, ly, lz, dtype, device)
    stokes, info = solve_ve_3d(stokes, pt_stokes, geometry, flow_bc, rho_g, G, K, dt,
                               iter_max=iter_max, nout=nout, use_kernel=use_kernel)
    return geometry, stokes, info
