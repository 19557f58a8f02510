"""Nondimensional layered convection driven by the DYREL solver
(reference miniapps/DYREL2D/convection/Layered_convection2D_DYREL.jl).

Counterpart of ``justrelax_tpu/models/layered_convection_dyrel.py``: the
configuration of :mod:`layered_convection_nondim` (GEO_units
nondimensionalization, three dislocation-creep layers on particles, a hot
anomaly seeding a plume) with ``solve_dyrel`` and its nonlinear viscosity
refresh as the Stokes stage (viscosity_relaxation 1e-2, the viscosity
cutoff, buoyancy ρ(T)·g given explicitly and refreshed every step). The
lithostatic pressure is set once, before the time loop, and the viscosity
is seeded per solve from the creep law at V = 0 (clamped to the cutoff's
maximum), from which the in-solve refresh only lowers it.

Oracle at 32², 2 steps (tests/test_layered_convection_dyrel.py): finite
fields, err < 1e-4, max |Vy| per step 3.1098e-5 and 4.8768e-7 (rtol 5 %),
within 15 % of the APT variant's 3.2067e-5 and 4.4046e-7, and comparable
up- and downwelling.

Routes on the card: the Stokes solve through DYREL, every chunk a CUDA
graph replay; the thermal solve through the thermal chunk kernel (B5), as
in the APT variant.
"""

from __future__ import annotations

import torch

from justrelax_tpu_torch.core.device import resolve_device
from justrelax_tpu_torch.core.state import StokesState
from justrelax_tpu_torch.models.layered_convection_nondim import (
    NPHASE,
    _setup,
    particle_step,
    thermal_step,
)
from justrelax_tpu_torch.rheology.materials import _as_stack, compute_density, phase_average
from justrelax_tpu_torch.rheology.viscosity import phase_viscosity
from justrelax_tpu_torch.solvers.dyrel import solve_dyrel
from justrelax_tpu_torch.utils.timestep import compute_dt

__all__ = ["run"]


def run(nx=32, ny=32, nt=3, nxcell=24, max_xcell=48, min_xcell=12, dtype=None, eps=1.0e-5,
        device=None, use_kernel=None):
    """``nt`` coupled steps; returns (stokes, thermal, particles, phase, the
    last Stokes solve's info, the CharacteristicUnits, max |Vy| per step),
    nondimensional. ``eps`` is DYREL's tolerance; ``device`` defaults to the
    card; ``use_kernel`` applies to the thermal solve (B5 on the card by
    default)."""
    device = resolve_device(device)
    s = _setup(nx, ny, nxcell, max_xcell, min_xcell, dtype, device)
    geometry, material, f = s.geometry, s.material, s.f
    particles, phase, pr_c, pr_v, thermal = s.particles, s.phase, s.pr_c, s.pr_v, s.thermal
    ni = (nx, ny)
    stokes = StokesState.make(ni, dtype=dtype, device=device)
    gravity = _as_stack(material, stokes.P).params.gravity

    def eta_seed(Tg, pr_c, pr_v):
        """The εII-mode creep law at V = 0, clamped to the cutoff: an η the
        in-solve refresh only lowers (the Gershgorin bounds are refreshed
        per chunk only, so an η racing upward would leave the
        pseudo-time step too large)."""
        T_cells = Tg[1:-1, 1:-1]
        T_v = 0.25 * (Tg[:-1, :-1] + Tg[1:, :-1] + Tg[:-1, 1:] + Tg[1:, 1:])
        eta0 = torch.clamp(phase_viscosity(material, torch.zeros(ni, **f), T_cells, pr_c,
                                           "eps"), *s.cutoff)
        eta_v0 = torch.clamp(phase_viscosity(material, torch.zeros((nx + 1, ny + 1), **f),
                                             T_v, pr_v, "eps"), *s.cutoff)
        return eta0, eta_v0

    def buoyancy(T_cells, pr_c):
        rho = compute_density(material, T=T_cells, phase_ratios=pr_c)
        return rho * phase_average(gravity, pr_c)

    # lithostatic pressure once before the time loop (reference
    # Layered_convection2D_DYREL.jl:186-189); P persists across steps
    rho_gy = buoyancy(thermal.T[1:-1, 1:-1], pr_c)
    P_litho = torch.flip(torch.cumsum(torch.flip(rho_gy * geometry.di[1], (1,)), dim=1), (1,))
    stokes = stokes.replace(P=P_litho)

    info = None
    dt = 1.0
    vmax_hist = []
    for _ in range(nt):
        T_cells = thermal.T[1:-1, 1:-1]
        # per-step ρ(T)·g (T is frozen during a solve) and the per-solve η seed
        rho_gy = buoyancy(T_cells, pr_c)
        eta_s, eta_vs = eta_seed(thermal.T, pr_c, pr_v)
        stokes = stokes.replace(viscosity=stokes.viscosity.replace(eta=eta_s, eta_v=eta_vs))
        stokes, info = solve_dyrel(
            stokes, geometry, s.flow_bc, material, pr_c, pr_v, dt,
            rho_g=(torch.zeros(ni, **f), rho_gy), T=T_cells, eps=eps, nout=200,
            iter_max=50_000, total_iter_max=50_000,
            linear_viscosity=False, viscosity_relaxation=1.0e-2, viscosity_cutoff=s.cutoff,
        )
        dt = float(compute_dt(stokes.V.components, geometry.di)) * 0.5
        thermal = thermal_step(thermal, s.thermal_bc, material, pr_c, dt, geometry,
                               use_kernel)
        particles, phase, pr_c, pr_v = particle_step(
            particles, phase, stokes.V.components, geometry, dt, NPHASE)
        vmax_hist.append(float(torch.abs(stokes.V.Vy).max()))

    return stokes, thermal, particles, phase, info, s.u, vmax_hist
