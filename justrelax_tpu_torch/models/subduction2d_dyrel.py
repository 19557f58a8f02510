"""Sticky-air (Schmeling-type) subduction driven by the DYREL solver
(reference miniapps/DYREL2D/StickyAirSubduction/Subduction2D_DYREL.jl).

Counterpart of ``justrelax_tpu/models/subduction2d_dyrel.py``. Isothermal
and purely mechanical: a 3000×750 km box (50 km of sticky air above y = 0;
origin (0, −700 km)) with three linear viscous phases
(Subduction2D_rheology.jl:1-26):

  asthenosphere  ρ=3200 kg/m³  η=1e21 Pa·s
  oceanic slab   ρ=3300 kg/m³  η=1e23 Pa·s
  sticky air     ρ=0           η=1e19 Pa·s

The slab is two boxes: the plate x ≥ 1000 km, −100 km ≤ y ≤ 0, and the tip
1000 ≤ x ≤ 1100 km down to −200 km. The phases ride particles (12 per
cell, 24 slots, at least 6); each step: phase ratios → η from the phases →
ρg → lithostatic P → solve_dyrel → CFL dt (×0.8) → RK2 advection,
re-slotting, injection (an emptied cell takes its initial phase) → phase
ratios. Free slip on all faces.

Oracle at 50×20, 2 steps (tests/test_subduction2d_dyrel.py): err < 1e-5,
an independent staggered momentum residual of the returned solution small
against its term scale (rms Rx < 10, Ry < 40 Pa/m) and max |∇·V| < 1e-12,
the slab tip below −180 km and descending, τII in the air under 5 % of the
rock's, and the rock's peak |V| between 1e-8 and 2e-8 m/s.

On the card the Stokes solve runs through DYREL, every chunk a CUDA graph
replay; the model runs no kernel of the port.
"""

from __future__ import annotations

import math

import torch

from justrelax_tpu_torch.core.device import resolve_device
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.core.state import StokesState
from justrelax_tpu_torch.ops.bc import Faces, VelocityBoundaryConditions
from justrelax_tpu_torch.particles.particles import (
    advect_rk2,
    init_particles,
    inject_particles,
    move_particles,
    phase_ratios_from_particles,
)
from justrelax_tpu_torch.rheology.materials import Material, MaterialStack, phase_average
from justrelax_tpu_torch.rheology.viscosity import phase_viscosity
from justrelax_tpu_torch.solvers.dyrel import solve_dyrel
from justrelax_tpu_torch.utils.timestep import compute_dt

__all__ = ["AST", "SLAB", "AIR", "N_PHASE", "KM", "YR", "materials", "init_phase", "run"]

KM = 1.0e3
YR = 365.25 * 24.0 * 3600.0

AST, SLAB, AIR = 0, 1, 2
N_PHASE = 3


def materials(dtype=None, device=None):
    """Subduction2D_rheology.jl:1-26 (linear viscous, constant density)."""
    return MaterialStack.make([
        Material(rho0=3.2e3, eta0=1.0e21, gravity=9.81),
        Material(rho0=3.3e3, eta0=1.0e23, gravity=9.81),
        Material(rho0=0.0, eta0=1.0e19, gravity=9.81),
    ], dtype=dtype, device=device)


def init_phase(px, py):
    """Per-point phase (Subduction2D_rheology.jl:33-58): asthenosphere by
    default, air above y=0, slab in the plate/tip boxes."""
    phase = torch.full_like(px, float(AST))
    phase = torch.where(py > 0.0, float(AIR), phase)
    plate = (px >= 1000.0 * KM) & (py <= 0.0) & (py >= -100.0 * KM)
    tip = (
        (px >= 1000.0 * KM) & (px <= 1100.0 * KM)
        & (py <= 0.0) & (py >= -200.0 * KM)
    )
    return torch.where(plate | tip, float(SLAB), phase)


def run(nx=50, ny=20, nt=3, seed=0, dtype=None, eps=1.0e-5, device=None):
    """``nt`` coupled steps; returns (stokes, particles, the particle phase,
    the center ratios after the last step, the last solve's info, the slab
    tip's depth per step, and ``aux``: the last solve's ρg, η and ηv and the
    slab's center-of-mass depth per step). ``eps`` is DYREL's tolerance;
    ``device`` defaults to the card."""
    device = resolve_device(device)
    li = (3000.0 * KM, 750.0 * KM)
    ni = (nx, ny)
    geometry = Geometry(ni, li, origin=(0.0, -700.0 * KM))
    stokes = StokesState.make(ni, dtype=dtype, device=device)
    f = dict(dtype=stokes.P.dtype, device=device)
    material = materials(**f)

    particles = init_particles(geometry, nxcell=12, max_xcell=24, min_xcell=6, seed=seed, **f)
    p_phase = init_phase(particles.px, particles.py)
    pr_c, pr_v = phase_ratios_from_particles(particles, p_phase, N_PHASE, geometry)

    # a phase field at the centers for the injection of emptied cells
    X, Y = geometry.cell_centers_mesh()
    phase_c = init_phase(torch.as_tensor(X, **f), torch.as_tensor(Y, **f))

    bc = VelocityBoundaryConditions(free_slip=Faces(left=True, right=True, top=True, bot=True))
    yc = torch.as_tensor(geometry.xci[1], **f)

    info = None
    dt = 10.0e3 * YR  # reference initial dt (Subduction2D_DYREL.jl:78)
    tip_hist = []
    ycm_hist = []
    aux = {}
    for _ in range(nt):
        eta = phase_viscosity(material, torch.ones(ni, **f), None, pr_c, "tau")
        eta_v = phase_viscosity(material, torch.ones((nx + 1, ny + 1), **f), None, pr_v, "tau")
        rho_gy = phase_average(material.params.rho0, pr_c) * phase_average(
            material.params.gravity, pr_c)
        # lithostatic P (init_P!, reverse cumsum, Subduction2D_DYREL.jl:111),
        # restarted every step so that the PH loop starts near balance
        P_litho = torch.flip(torch.cumsum(torch.flip(rho_gy * geometry.di[1], (1,)), dim=1),
                             (1,))
        stokes = stokes.replace(
            P=P_litho, viscosity=stokes.viscosity.replace(eta=eta, eta_v=eta_v))
        stokes, info = solve_dyrel(
            stokes, geometry, bc, material, pr_c, pr_v, math.inf,
            rho_g=(torch.zeros(ni, **f), rho_gy), eps=eps, nout=100,
            iter_max=50_000, total_iter_max=50_000,
        )
        # the solve's inputs, for an independent residual check
        aux = {"rho_gy": rho_gy, "eta": eta, "eta_v": eta_v}
        dt = float(compute_dt(stokes.V.components, geometry.di)) * 0.8

        particles = advect_rk2(particles, stokes.V.components, geometry, dt)
        particles, fields = move_particles(particles, geometry, {"phase": p_phase})
        particles, fields = inject_particles(particles, geometry, {}, phases=phase_c,
                                             fields=fields)
        p_phase = fields["phase"]
        pr_c, pr_v = phase_ratios_from_particles(particles, p_phase, N_PHASE, geometry)
        # slab-tip depth: the deepest active slab particle
        is_slab = torch.round(p_phase) == SLAB
        tip_hist.append(float(torch.where(is_slab & particles.active, particles.py,
                                          math.inf).min()))
        # slab center-of-mass depth from the cell ratios
        r_slab = pr_c[..., SLAB]
        ycm_hist.append(float(torch.sum(r_slab * yc[None, :]) / torch.sum(r_slab)))

    aux["ycm_hist"] = ycm_hist
    return stokes, particles, p_phase, pr_c, info, tip_hist, aux
