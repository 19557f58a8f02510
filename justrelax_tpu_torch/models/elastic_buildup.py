"""Elastic stress build-up benchmark.

Counterpart of ``justrelax_tpu/models/elastic_buildup.py``: a pure-shear
box with Maxwell visco-elastic rheology and no gravity; the deviatoric
stress grows as the analytic Maxwell curve τ(t) = 2 ε̇ η (1 − exp(−G t/η)).
Oracle: mean relative error of max|τyy| against the curve ≤ 5e-3 at 32²,
η = 1e21, G = 1e10, ε̇ = 1e-14, 10 kyr in 0.05 kyr steps, in f64
(tests/test_elastic_buildup.py). It exercises the elastic terms of the
solve: finite G, τ_o and dt, K = ∞, and pure-shear velocities on the
boundary faces under free slip.
"""

from __future__ import annotations

import math

import torch

from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs
from justrelax_tpu_torch.core.device import resolve_device
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.core.state import StokesState
from justrelax_tpu_torch.ops.bc import Faces, VelocityBoundaryConditions, flow_bcs, pureshear_bc
from justrelax_tpu_torch.solvers.stokes2d import solve_ve

__all__ = ["analytic_solution", "run"]

YR = 365.25 * 3600 * 24
KYR = 1.0e3 * YR


def analytic_solution(eps_bg, t, G, eta):
    return 2.0 * eps_bg * eta * (1.0 - math.exp(-G * t / eta))


def _setup(nx, ny, lx, ly, eta0, eps_bg, G, dtype, device):
    """Grid, pure-shear initial state, PT coefficients, BCs, ρg and moduli,
    on ``device`` (the card unless given)."""
    device = resolve_device(device)
    ni = (nx, ny)
    geometry = Geometry(ni, (lx, ly))
    stokes = StokesState.make(ni, dtype=dtype, device=device)
    f = dict(dtype=stokes.P.dtype, device=device)
    pt_stokes = PTStokesCoeffs.make(
        geometry.li, geometry.di, CFL=1.0 / math.sqrt(2.1), eps_abs=1.0e-6,
        eps_rel=1.0e-6)
    stokes = stokes.replace(
        viscosity=stokes.viscosity.replace(eta=torch.full(ni, eta0, **f)))
    Gc = torch.full(ni, G, **f)
    Kb = torch.full(ni, math.inf, **f)
    rho_g = (torch.zeros(ni, **f), torch.zeros(ni, **f))
    flow_bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True))
    Vx, Vy = pureshear_bc(stokes.V.Vx, stokes.V.Vy, geometry.xvi, eps_bg)
    Vx, Vy = flow_bcs((Vx, Vy), flow_bc)
    stokes = stokes.replace(V=stokes.V.replace(Vx=Vx, Vy=Vy))
    return geometry, stokes, pt_stokes, flow_bc, rho_g, Gc, Kb


def run(nx=32, ny=32, lx=100.0e3, ly=100.0e3, endtime_kyr=10.0, eta0=1.0e21,
        eps_bg=1.0e-14, G=10.0e9, iter_max=150_000, nout=1000, dtype=None,
        device=None, use_kernel=None):
    """Time steps up to ``endtime_kyr``; returns (stokes, max|τyy| per step,
    the analytic curve per step, times in kyr, the last solve's info).
    ``device`` and ``use_kernel`` as in ``models/solcx.py::run``."""
    geometry, stokes, pt_stokes, flow_bc, rho_g, Gc, Kb = _setup(
        nx, ny, lx, ly, eta0, eps_bg, G, dtype, device)
    t = 0.0
    av_tyy, sol_tyy, tt = [], [], []
    ttot = endtime_kyr * KYR
    info = None
    while t < ttot:
        dt = 0.05 * KYR if t < 10 * KYR else 1.0 * KYR
        stokes, info = solve_ve(stokes, pt_stokes, geometry, flow_bc, rho_g, Gc, Kb, dt,
                                iter_max=iter_max, nout=nout, use_kernel=use_kernel)
        t += dt
        av_tyy.append(float(stokes.tau.yy.abs().max()))
        sol_tyy.append(analytic_solution(eps_bg, t, G, eta0))
        tt.append(t / KYR)
    return stokes, av_tyy, sol_tyy, tt, info
