"""SolCx analytic Stokes benchmark.

Counterpart of ``justrelax_tpu/models/solcx.py``: unit box, viscosity jump
Δη at x = 0.5 (smoothed 5×), buoyancy ρ = −sin(πy)cos(πx), free slip on all
faces, incompressible viscous limit (G = K = ∞). Oracle: final absolute
residual < 1e-8 at 32², Δη = 1e6, in f64 (tests/test_stokes_solcx.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs
from justrelax_tpu_torch.core.device import resolve_device
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.core.state import StokesState
from justrelax_tpu_torch.ops.bc import Faces, VelocityBoundaryConditions
from justrelax_tpu_torch.solvers.stokes2d import solve_ve

__all__ = ["solcx_viscosity", "solcx_density", "run"]


def solcx_viscosity(geometry, d_eta=1.0e6, n_smooth=5):
    """Step viscosity at cell centers (numpy), diffusion-smoothed
    ``n_smooth`` times with edge replication."""
    xc = geometry.xci[0]
    nx, ny = geometry.ni
    eta = np.where(xc <= 0.5, 1.0, d_eta)[:, None] * np.ones((1, ny))
    for _ in range(n_smooth):
        eta2 = eta.copy()
        eta2[1:-1, 1:-1] = eta[1:-1, 1:-1] + (1.0 / 4.1) * (
            eta[:-2, 1:-1] - 2 * eta[1:-1, 1:-1] + eta[2:, 1:-1]
            + eta[1:-1, :-2] - 2 * eta[1:-1, 1:-1] + eta[1:-1, 2:]
        )
        eta2[0, :] = eta2[1, :]
        eta2[-1, :] = eta2[-2, :]
        eta2[:, 0] = eta2[:, 1]
        eta2[:, -1] = eta2[:, -2]
        eta = eta2
    return eta


def solcx_density(geometry):
    """ρ = −sin(πy)cos(πx) at cell centers (numpy)."""
    X, Y = geometry.cell_centers_mesh()
    return -np.sin(np.pi * Y) * np.cos(np.pi * X)


def _setup(nx, ny, d_eta, lx, ly, dtype, device):
    """Grid, initial state, PT coefficients, ρg, BCs and moduli of the
    solve, on ``device`` (the card unless given)."""
    device = resolve_device(device)
    ni = (nx, ny)
    geometry = Geometry(ni, (lx, ly))
    stokes = StokesState.make(ni, dtype=dtype, device=device)
    f = dict(dtype=stokes.P.dtype, device=device)
    pt_stokes = PTStokesCoeffs.make(
        geometry.li, geometry.di, CFL=1.0 / math.sqrt(2.1), eps_abs=1.0e-8,
        eps_rel=1.0e-9,
    )
    eta = torch.as_tensor(solcx_viscosity(geometry, d_eta), **f)
    stokes = stokes.replace(viscosity=stokes.viscosity.replace(eta=eta))
    rho = solcx_density(geometry)
    rho_g = (torch.zeros(ni, **f), torch.as_tensor(rho, **f))
    flow_bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True))
    G = torch.full(ni, math.inf, **f)
    K = torch.full(ni, math.inf, **f)
    return geometry, stokes, pt_stokes, flow_bc, rho_g, G, K, rho


def run(nx=32, ny=32, d_eta=1.0e6, lx=1.0, ly=1.0, iter_max=500_000, nout=5_000,
        dtype=None, device=None, use_kernel=None):
    """The SolCx solve; returns (geometry, stokes, info, ρ). ``device``
    defaults to the card; ``use_kernel`` to the Hopper kernel on the card
    and the plain path on the CPU (``False`` asks for the plain path)."""
    geometry, stokes, pt_stokes, flow_bc, rho_g, G, K, rho = _setup(
        nx, ny, d_eta, lx, ly, dtype, device)
    stokes, info = solve_ve(stokes, pt_stokes, geometry, flow_bc, rho_g, G, K, 0.1,
                            iter_max=iter_max, nout=nout, use_kernel=use_kernel)
    return geometry, stokes, info, rho
