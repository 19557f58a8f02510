"""Crameri et al. (2012) case-2 free-surface relaxation (reference
miniapps/benchmarks/stokes2D/free_surface_stabilization/Crameri2D.jl).

Counterpart of ``justrelax_tpu/models/crameri2d.py``. A 2800×700 km mantle
(η=1e21) under a 100 km stiff crust (η=1e23), both ρ=3300, g=10, with
100 km of air (ρ=0) excised by the variational (rock-ratio masked) solve,
so that the surface is free. The crust carries a 7 km cosine topography
h(x, 0) = −7e3·cos(2πx/2800e3), which relaxes viscously; the
semi-analytic solution decays it as 7 km·exp(−t/14.825 kyr). The
topography is read from the rock-fraction column integral
Σ_j φ_center[i, j]·dy − 700 km, projected on the cosine mode.

As in the JAX package, each solve is the stabilized variational form with
the physical dt (the masked Vy·∂(φρg)/∂y·dt term) and the rock-fraction
step floor 0.05, Re = 3π; the advection dt is min(CFL dt, ``dt_max_kyr``).

On the card the solves' chunks are CUDA graph replays; the model runs no
kernel of the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs
from justrelax_tpu_torch.core.device import resolve_device
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.core.state import StokesState
from justrelax_tpu_torch.models.rayleigh_taylor import _advance, _ratios_and_phi
from justrelax_tpu_torch.ops.bc import Faces, VelocityBoundaryConditions
from justrelax_tpu_torch.particles.particles import init_particles
from justrelax_tpu_torch.rheology.materials import (
    Material,
    MaterialStack,
    compute_density,
    phase_average,
)
from justrelax_tpu_torch.solvers.stokes2d_variational import solve_variational
from justrelax_tpu_torch.utils.timestep import compute_dt

__all__ = ["YR", "AIR", "CRUST", "MANTLE", "T_RELAX_ANALYTIC", "H0", "LX", "topography_mode",
           "run"]

YR = 365.25 * 24 * 3600
AIR, CRUST, MANTLE = 0, 1, 2
T_RELAX_ANALYTIC = 14.825e3 * YR  # Crameri et al. 2012, case 2
H0 = 7.0e3
LX = 2800.0e3


def _phase_of(px, py):
    """Crameri2D.jl:37-71 init_phases! (0-based ids)."""
    depth = -py
    ph = torch.full_like(px, float(MANTLE))
    ph = torch.where(depth < 200.0e3, float(CRUST), ph)
    topo = -torch.cos(px * 2.0 * math.pi / LX) * H0 + 100.0e3
    return torch.where(depth < topo, float(AIR), ph)


def topography_mode(phi_center, geometry):
    """The cosine-mode amplitude of the surface topography from the
    rock-fraction column integral (sub-cell accurate), on the host."""
    dy = geometry.di[1]
    phi_np = phi_center.cpu().numpy() if isinstance(phi_center, torch.Tensor) \
        else np.asarray(phi_center)
    h_col = phi_np.sum(axis=1) * dy - 700.0e3
    mode = np.cos(2.0 * np.pi * np.asarray(geometry.xci[0]) / LX)
    return 2.0 * np.mean(h_col * mode)


def run(nx=64, ny=64, nt=5, nxcell=36, max_xcell=72, min_xcell=18,
        dt_max_kyr=10.0, iter_max=50_000, nout=2_000, dtype=None, device=None):
    """``nt`` relaxation steps; returns (stokes, particles, the particle
    phase, the last solve's info, the topography mode per step and the
    times, numpy). ``device`` defaults to the card."""
    device = resolve_device(device)
    thick_air = 100.0e3
    lx, ly = LX, 700.0e3 + thick_air
    ni = (nx, ny)
    geometry = Geometry(ni, (lx, ly), origin=(0.0, -ly))
    stokes = StokesState.make(ni, dtype=dtype, device=device)
    f = dict(dtype=stokes.P.dtype, device=device)

    etas = (1.0e22, 1.0e23, 1.0e21)
    material = MaterialStack.make(
        [Material(rho0=r, eta0=e, gravity=10.0, G=math.inf, Kb=math.inf)
         for r, e in zip((0.0, 3.3e3, 3.3e3), etas)], **f)

    particles = init_particles(geometry, nxcell, max_xcell, min_xcell, **f)
    phase = _phase_of(particles.px, particles.py)
    pr, phi = _ratios_and_phi(particles, phase, geometry)

    eta_tab = torch.as_tensor(etas, **f)
    # the lithostatic start: the reversed cumsum of ρg·dy (Crameri2D.jl:162)
    rho = compute_density(material, phase_ratios=pr.center)
    P0 = torch.flip(torch.cumsum(torch.flip(rho * 10.0 * geometry.di[1], (1,)), dim=1), (1,))
    stokes = stokes.replace(
        viscosity=stokes.viscosity.replace(
            eta=phase_average(eta_tab, pr.center), eta_v=phase_average(eta_tab, pr.vertex)),
        P=P0,
    )

    # Re = 3π (not the script's 15π) with the φ-step preconditioner, as in
    # the JAX package
    pt = PTStokesCoeffs.make(
        geometry.li, geometry.di, Re=3.0 * math.pi, r=1.0,
        CFL=0.98 / math.sqrt(2.1), eps_abs=1.0e-6, eps_rel=1.0e-6,
    )
    bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True), no_slip=Faces(bot=True),
        free_surface=True,
    )

    dt_max = dt_max_kyr * 1.0e3 * YR
    h_hist = [topography_mode(phi.center, geometry)]
    t_hist = [0.0]
    info = None
    t = 0.0
    dt = dt_max
    for _ in range(nt):
        # the stabilized variational form with the physical dt (the
        # reference script passes dt = ∞ and no stabilization, and cannot
        # converge: the masked surface leaves the piston mode undamped)
        stokes, info = solve_variational(
            stokes, pt, geometry, bc, material, pr.center, pr.vertex, phi, dt,
            iter_max=iter_max, iter_min=1_000, nout=nout,
            viscosity_relaxation=1.0e-2, viscosity_cutoff=(1.0e18, 1.0e24),
            air_phase=AIR, free_surface=True, mask_step_floor=0.05,
        )
        dt = min(float(compute_dt(stokes.V.components, geometry.di)), dt_max)
        particles, phase = _advance(particles, phase, stokes, geometry, dt)
        pr, phi = _ratios_and_phi(particles, phase, geometry)
        t += dt
        h_hist.append(topography_mode(phi.center, geometry))
        t_hist.append(t)

    return stokes, particles, phase, info, np.asarray(h_hist), np.asarray(t_hist)
