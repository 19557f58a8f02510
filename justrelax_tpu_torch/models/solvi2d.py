"""SolVi 2D: a circular viscous inclusion under far-field pure shear
(Schmid & Podladchikov 2003).

Counterpart of ``justrelax_tpu/models/solvi2d.py``. The analytic interior
solution is uniform: the strain rate amplified by 2η_m/(η_m + η_i) and the
deviatoric stress

  τ_in = 2 η_i ε̇_in = 4 η_i η_m / (η_m + η_i) · ε̇_bg,

with no interior pressure perturbation. The pure-shear velocities are
imposed on the boundary; the solve is viscous and incompressible (G = K =
dt = ∞). Oracle (tests/test_solvi2d.py, n = 96): the interior mean τxx
within 4 % of the amplitude.

The solve runs on the plain path by contract: velocities imposed on the
boundary are outside the VE chunk kernel's all-free-slip contract (as they
are outside the JAX kernel's).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs
from justrelax_tpu_torch.core.device import resolve_device
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.core.state import StokesState
from justrelax_tpu_torch.ops.bc import VelocityBoundaryConditions, pureshear_bc
from justrelax_tpu_torch.solvers.stokes2d import solve_ve

__all__ = ["run", "interior_amplitude"]


def interior_amplitude(eta_m: float, eta_i: float, eps_bg: float) -> float:
    """Analytic uniform interior deviatoric stress amplitude."""
    return 4.0 * eta_i * eta_m / (eta_m + eta_i) * eps_bg


def run(n=64, d_eta=1.0e-3, rc=0.1, eps_bg=1.0, L=2.0, iter_max=500_000,
        nout=5_000, dtype=None, device=None):
    """The SolVi 2D solve; returns (geometry, stokes, info, the inclusion
    mask). ``device`` defaults to the card."""
    device = resolve_device(device)
    ni = (n, n)
    geometry = Geometry(ni, (L, L), origin=(-L / 2, -L / 2))
    stokes = StokesState.make(ni, dtype=dtype, device=device)
    f = dict(dtype=stokes.P.dtype, device=device)

    X, Y = geometry.cell_centers_mesh()
    inside = np.asarray(X) ** 2 + np.asarray(Y) ** 2 <= rc**2
    eta = torch.as_tensor(np.where(inside, d_eta, 1.0), **f)
    stokes = stokes.replace(viscosity=stokes.viscosity.replace(eta=eta))

    Vx, Vy = pureshear_bc(stokes.V.Vx, stokes.V.Vy, geometry.xvi, eps_bg)
    stokes = stokes.replace(V=stokes.V.replace(Vx=Vx, Vy=Vy))

    pt = PTStokesCoeffs.make(
        geometry.li, geometry.di, CFL=1.0 / math.sqrt(2.1), eps_abs=1.0e-9, eps_rel=1.0e-12)
    flow_bc = VelocityBoundaryConditions()  # boundary velocities imposed
    G = torch.full(ni, math.inf, **f)
    K = torch.tensor(math.inf, **f)
    zeros = torch.zeros(ni, **f)
    # plain path by contract: imposed boundary velocities (see the docstring)
    stokes, info = solve_ve(
        stokes, pt, geometry, flow_bc, (zeros, zeros), G, K, math.inf,
        iter_max=iter_max, nout=nout, use_kernel=False,
    )
    return geometry, stokes, info, inside
