"""2D thermo-mechanical subduction (reference miniapps/subduction/2D, the
linear-rheology variant, analytic initial geometry).

Counterpart of ``justrelax_tpu/models/subduction2d.py``: ``run`` (fixed
phases, WENO5 temperature advection) and ``run_particles`` (phases and T on
particles, with checkpoints and restart). A 3000×675 km box: 15 km of
sticky air above a half-space-cooled (50 Myr) 80-km lithosphere, with a
250-km slab dipping 30° already inserted; mantle η=1e20, lithosphere η=1e23
with a T-dependent density (T0=1747 K, α=2.4e-5); the air excised by the
variational rock-ratio mask. Each step of ``run``: the variational VEP
Stokes solve → CFL dt → PT thermal diffusion → WENO5 temperature advection.

No reference golden exists (the miniapp is visual); tests/test_subduction2d.py
asserts steady convergence, a sinking slab at a plate-tectonic rate, air at
rest, and frozen goldens.

On the card the Stokes solve's chunks are CUDA graph replays; the thermal
solve passes a material, which the thermal kernel (B5) refuses, so it runs
plain by contract (``use_kernel=False``). The model runs no kernel of the
port.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from justrelax_tpu_torch.advection.weno5 import weno_advect
from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs, PTThermalCoeffs
from justrelax_tpu_torch.core.device import resolve_device
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.core.state import StokesState, ThermalState
from justrelax_tpu_torch.io.checkpoint import (
    checkpointing,
    checkpointing_particles,
    load_checkpoint,
    load_checkpoint_particles,
)
from justrelax_tpu_torch.ops.bc import (
    Faces,
    TemperatureBoundaryConditions,
    VelocityBoundaryConditions,
    thermal_bcs,
)
from justrelax_tpu_torch.ops.interpolation import velocity2center
from justrelax_tpu_torch.ops.rock_ratio import update_rock_ratio
from justrelax_tpu_torch.particles.particles import (
    advect_rk2,
    centroid2particle,
    init_particles,
    inject_particles,
    move_particles,
    particle2centroid,
    phase_ratios_from_particles,
    subgrid_characteristic_time,
    subgrid_diffusion,
)
from justrelax_tpu_torch.rheology.materials import Material, MaterialStack
from justrelax_tpu_torch.rheology.phases import PhaseRatios, phase_ratios_from_field
from justrelax_tpu_torch.solvers.stokes2d_variational import solve_variational
from justrelax_tpu_torch.solvers.thermal import heatdiffusion_PT
from justrelax_tpu_torch.utils.timestep import compute_dt

__all__ = ["KM", "MYR", "AST", "LITH", "AIR", "ETA0", "materials", "run", "run_particles"]

KM = 1.0e3
MYR = 1.0e6 * 365.25 * 24 * 3600.0

# phases: 0 the asthenosphere, 1 the lithosphere, 2 air
AST, LITH, AIR = 0, 1, 2
ETA0 = [1.0e20, 1.0e23, 1.0e19]  # the initial viscosity per phase
T_SURF, T_BOT = 293.0, 1747.0
KAPPA = 2.5 / (750.0 * 3.2e3)


def materials(dtype=None, device=None):
    """The three phases (linear viscous; the lithosphere's density depends
    on T)."""
    return MaterialStack.make(
        [
            Material(rho0=3.2e3, eta0=1.0e20, Cp=750.0, k=2.5, gravity=9.81),
            Material(rho0=3.2e3, alpha=2.4e-5, T0=273.0 + 1474.0, eta0=1.0e23, G=math.inf,
                     Cp=750.0, k=2.5, gravity=9.81),
            Material(rho0=100.0, eta0=1.0e19, Cp=3.0e3, k=1.0, gravity=9.81),
        ],
        dtype=dtype, device=device,
    )


def _setup_phases_T(geometry):
    """The analytic initial state, numpy: half-space cooling and a
    30°-dipping slab; the cell phase (int) and T."""
    X, Y = geometry.cell_centers_mesh()
    xkm, zkm = X / KM, Y / KM  # z: -660 .. +15
    Tsurf, Tbot = T_SURF, T_BOT
    age = 50.0 * MYR

    phases = np.full(X.shape, AST, dtype=int)
    depth = -zkm  # km, positive down; negative above sea level

    def erf_np(x):
        # the Abramowitz-Stegun rational approximation (|err| < 1.5e-7)
        sign = np.sign(x)
        x = np.abs(x)
        t = 1.0 / (1.0 + 0.3275911 * x)
        y = 1.0 - (((((1.061405429 * t - 1.453152027) * t) + 1.421413741) * t
                    - 0.284496736) * t + 0.254829592) * t * np.exp(-x * x)
        return sign * y

    with np.errstate(invalid="ignore"):
        Thalf = Tsurf + (Tbot - Tsurf) * erf_np(
            np.maximum(depth, 0.0) * KM / (2.0 * np.sqrt(KAPPA * age))
        )
    T = np.where(depth > 0, Thalf, Tsurf)

    # the lithosphere: T < 1573 K below the surface (≈ an 80 km plate at 50 Myr)
    plate = (depth > 0) & (T < 1573.0) & (xkm > 100) & (xkm < 2900)
    phases[plate] = LITH

    # the dipping slab: 30° from the trench at x = 1570 km, 250 km long, 80 thick
    trench = 1570.0
    s = (trench - xkm) / np.cos(np.radians(30.0))  # the distance along the slab top
    d_perp = (depth - (trench - xkm) * np.tan(np.radians(30.0)))
    in_slab = (xkm < trench) & (s > 0) & (s < 250.0) & (d_perp > 0) & (
        d_perp * np.cos(np.radians(30.0)) < 80.0
    )
    phases[in_slab & (depth > 0)] = LITH
    T = np.where(
        in_slab & (depth > 0),
        np.minimum(T, Tsurf + (Tbot - Tsurf) * 0.5),  # the cold slab core
        T,
    )

    # sticky air
    phases[depth <= 0] = AIR
    T[depth <= 0] = Tsurf
    return phases, T


def _with_interior(T, interior, thermal_bc):
    """The ghosted ``T`` with ``interior`` in its cells, boundary values
    applied."""
    T = T.clone()
    T[1:-1, 1:-1] = interior
    return thermal_bcs(T, thermal_bc)


def run(nx=96, ny=32, nt=3, dtype=None, device=None):
    """``nt`` coupled steps; returns (stokes, thermal, the last Stokes
    solve's info, the cell phases, numpy). ``device`` defaults to the card."""
    device = resolve_device(device)
    lx, lz = 3000.0 * KM, 675.0 * KM
    ni = (nx, ny)
    geometry = Geometry(ni, (lx, lz), origin=(0.0, -660.0 * KM))
    stokes = StokesState.make(ni, dtype=dtype, device=device)
    f = dict(dtype=stokes.P.dtype, device=device)
    material = materials(**f)
    phases, T0 = _setup_phases_T(geometry)
    pr = phase_ratios_from_field(torch.as_tensor(phases, device=device), 3, dtype=f["dtype"])
    phi = update_rock_ratio(pr, air_phase=AIR)

    eta0 = torch.as_tensor(np.choose(phases, ETA0), **f)
    stokes = stokes.replace(viscosity=stokes.viscosity.replace(eta=eta0))
    pt_stokes = PTStokesCoeffs.make(
        geometry.li, geometry.di, eps_rel=1.0e-4, CFL=0.9 / math.sqrt(2.1))
    flow_bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True))

    Tg = np.full((nx + 2, ny + 2), T_BOT)
    Tg[1:-1, 1:-1] = T0
    thermal_bc = TemperatureBoundaryConditions(
        no_flux=Faces(left=True, right=True),
        constant_value=Faces(top=T_SURF, bot=T_BOT),
    )
    Tj = thermal_bcs(torch.as_tensor(Tg, **f), thermal_bc)
    thermal = ThermalState.make(ni, dtype=f["dtype"], device=device).replace(T=Tj, Told=Tj)
    dt_diff = 0.9 * min(geometry.di) ** 2 / KAPPA / 4.0

    info = None
    for _ in range(nt):
        T_c = thermal.T[1:-1, 1:-1]
        stokes, info = solve_variational(
            stokes, pt_stokes, geometry, flow_bc, material, pr.center, pr.vertex, phi,
            math.inf, T=T_c, iter_max=80_000, nout=1_000,
            viscosity_cutoff=(1.0e18, 1.0e24),
        )
        dt = float(compute_dt(stokes.V.components, geometry.di, dt_diff))

        pt_thermal = PTThermalCoeffs.from_material(
            material, T_c, stokes.P, dt, geometry.di, geometry.li,
            phase_ratios=pr.center, eps=1.0e-5, CFL=0.95 / math.sqrt(2.0),
        )
        thermal, _ = heatdiffusion_PT(
            thermal, pt_thermal, thermal_bc, dt, geometry,
            material=material, P=stokes.P, phase_ratios=pr.center,
            iter_max=10_000, nout=100, use_kernel=False,
        )
        Vx_c, Vy_c = velocity2center(stokes.V.Vx, stokes.V.Vy)
        Tc = weno_advect(thermal.T[1:-1, 1:-1], (Vx_c, Vy_c), geometry.di, dt)
        thermal = thermal.replace(T=_with_interior(thermal.T, Tc, thermal_bc))

    return stokes, thermal, info, phases


def run_particles(nx=96, ny=32, nt=4, dtype=None, seed=0, out_dir=None, checkpoint_every=2,
                  restart_from=None, device=None):
    """Particle-transport subduction with checkpoints and restart: the
    reference miniapp pair Subduction2D.jl (``checkpointing_jld2`` and
    ``checkpointing_particles`` every step, :270-271) and
    Subduction2D_restart.jl (loads both and continues, :81-103).

    The particles (12 per cell, 24 slots, at least 6, drawn from ``seed``)
    carry the phase and T; each step takes the phase ratios and the
    rock-ratio mask from them, then: T from the particles → the variational
    Stokes solve → CFL dt → PT thermal diffusion → subgrid diffusion of the
    particles' T → RK2 advection, re-slotting and injection. With
    ``out_dir`` the Stokes and thermal states (``checkpoint.npz``) and the
    particles (``particles.npz``) are written every ``checkpoint_every``
    steps; ``restart_from`` is such a directory, and the run continues from
    it to ``nt`` steps in all. Returns (stokes, thermal, particles,
    (phase, T) on the particles, the last Stokes solve's info). The
    particles are in the run's dtype, their phase in float64, as the JAX
    model's; ``device`` defaults to the card."""
    device = resolve_device(device)
    lx, lz = 3000.0 * KM, 675.0 * KM
    ni = (nx, ny)
    geometry = Geometry(ni, (lx, lz), origin=(0.0, -660.0 * KM))
    stokes = StokesState.make(ni, dtype=dtype, device=device)
    f = dict(dtype=stokes.P.dtype, device=device)
    material = materials(**f)
    phases, T0 = _setup_phases_T(geometry)
    phases64 = torch.as_tensor(phases, dtype=torch.float64, device=device)

    thermal = ThermalState.make(ni, **f)
    thermal_bc = TemperatureBoundaryConditions(
        no_flux=Faces(left=True, right=True),
        constant_value=Faces(top=T_SURF, bot=T_BOT),
    )
    flow_bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True))
    pt_stokes = PTStokesCoeffs.make(
        geometry.li, geometry.di, eps_rel=1.0e-4, CFL=0.9 / math.sqrt(2.1))

    if restart_from is not None:
        stokes, thermal, t, _ = load_checkpoint(
            os.path.join(restart_from, "checkpoint.npz"), stokes, thermal)
        particles, pfields, t_p, _, it0 = load_checkpoint_particles(
            os.path.join(restart_from, "particles.npz"), device=device)
        p_phase, pT = pfields["phase"], pfields["T"]
        if t != t_p:
            raise ValueError(f"{restart_from}: the state's time {t} is not the "
                             f"particles' {t_p}")
    else:
        it0, t = 0, 0.0
        eta0 = torch.as_tensor(np.choose(phases, ETA0), **f)
        stokes = stokes.replace(viscosity=stokes.viscosity.replace(eta=eta0))
        Tg = np.full((nx + 2, ny + 2), T_BOT)
        Tg[1:-1, 1:-1] = T0
        Tj = thermal_bcs(torch.as_tensor(Tg, **f), thermal_bc)
        thermal = thermal.replace(T=Tj, Told=Tj)
        particles = init_particles(geometry, nxcell=12, max_xcell=24, min_xcell=6, seed=seed,
                                   **f)
        p_phase = torch.round(centroid2particle(phases64, particles, geometry))
        pT = centroid2particle(thermal.T, particles, geometry)

    def ratios_and_phi(particles, p_phase):
        rc, rv = phase_ratios_from_particles(particles, p_phase, 3, geometry)
        pr_full = phase_ratios_from_field(rc)
        pr = PhaseRatios(center=rc, vertex=rv, face_x=pr_full.face_x, face_y=pr_full.face_y)
        return pr, update_rock_ratio(pr, air_phase=AIR)

    dt_diff = 0.9 * min(geometry.di) ** 2 / KAPPA / 4.0

    info = None
    for it in range(it0, nt):
        pr, phi = ratios_and_phi(particles, p_phase)
        thermal = thermal.replace(T=_with_interior(
            thermal.T, particle2centroid(pT, particles, geometry), thermal_bc))
        T_c = thermal.T[1:-1, 1:-1]

        stokes, info = solve_variational(
            stokes, pt_stokes, geometry, flow_bc, material, pr.center, pr.vertex, phi,
            math.inf, T=T_c, iter_max=80_000, nout=1_000,
            viscosity_cutoff=(1.0e18, 1.0e24),
        )
        dt = float(compute_dt(stokes.V.components, geometry.di, dt_diff))

        pt_thermal = PTThermalCoeffs.from_material(
            material, T_c, stokes.P, dt, geometry.di, geometry.li,
            phase_ratios=pr.center, eps=1.0e-5, CFL=0.95 / math.sqrt(2.0),
        )
        thermal, _ = heatdiffusion_PT(
            thermal, pt_thermal, thermal_bc, dt, geometry,
            material=material, P=stokes.P, phase_ratios=pr.center,
            iter_max=10_000, nout=100, use_kernel=False,
        )
        dt0 = subgrid_characteristic_time(material, T_c, stokes.P, pr.center, geometry.di)
        pT = subgrid_diffusion(pT, thermal.T, thermal.dT, dt0, particles, geometry, dt)

        particles = advect_rk2(particles, stokes.V.components, geometry, dt)
        particles, fields = move_particles(particles, geometry, {"phase": p_phase, "T": pT})
        particles, fields = inject_particles(
            particles, geometry, fields_from_centers={"T": thermal.T[1:-1, 1:-1]},
            phases=phases64, fields=fields,
        )
        p_phase, pT = fields["phase"], fields["T"]
        t += dt

        if out_dir is not None and (it + 1) % checkpoint_every == 0:
            checkpointing(out_dir, stokes, thermal, t, dt)
            checkpointing_particles(out_dir, particles, fields={"phase": p_phase, "T": pT},
                                    t=t, dt=dt, it=it + 1)

    return stokes, thermal, particles, (p_phase, pT), info
