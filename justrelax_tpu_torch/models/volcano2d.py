"""Volcano2D / Caldera: the reference's coupled volcano model
(test_Volcano2D.jl and miniapps/DYREL2D/volcano/Caldera_{setup,rheology}.jl,
analytic geometry).

Counterpart of ``justrelax_tpu/models/volcano2d.py``. A 30×25 km box (5 km
of sticky air): a 20-Myr half-space-cooled crust split at the chamber
depth, an elliptical magma chamber (phase 2) with a hotter eruptible core
(phase 3) at 5 km depth, air (phase 4) above a marker-chain topography.
Each step couples, as the reference does: particle T → grid → the
variational VEP Stokes solve (rock-ratio masked) → particle stress rotation
→ CFL dt → PT thermal diffusion (the chamber pinned by a Dirichlet mask) →
subgrid particle-T diffusion → particle and marker-chain advection → the
per-particle topography correction against the chain → injection → phase
ratios and rock ratio.

Oracle (test_Volcano2D.jl:400, tests/test_volcano2d.py): the final Stokes
residual < 1e-4 at 16×8 after 2 steps, air at rest, bounded topography,
melt in the chamber, and frozen goldens.

On the card the Stokes solve's chunks are CUDA graph replays; the thermal
solve passes a material and a Dirichlet mask, which the thermal kernel
(B5) refuses, so it runs plain by contract (``use_kernel=False``). The
model runs no kernel of the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs, PTThermalCoeffs
from justrelax_tpu_torch.core.device import resolve_device
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.core.state import StokesState, ThermalState
from justrelax_tpu_torch.ops.bc import (
    Faces,
    TemperatureBoundaryConditions,
    VelocityBoundaryConditions,
    thermal_bcs,
)
from justrelax_tpu_torch.ops.rock_ratio import update_rock_ratio
from justrelax_tpu_torch.ops.stress_rotation import (
    compute_vorticity_center,
    rotate_stress_particles_2d,
)
from justrelax_tpu_torch.particles.marker_chain import (
    advect_marker_chain,
    init_marker_chain,
    phases_from_marker_chain,
    update_phases_given_markerchain,
)
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
from justrelax_tpu_torch.rheology.melting import MeltingCaricchi, NoMelting, compute_melt_fraction
from justrelax_tpu_torch.rheology.phases import PhaseRatios, phase_ratios_from_field
from justrelax_tpu_torch.solvers.stokes2d_variational import solve_variational
from justrelax_tpu_torch.solvers.thermal import heatdiffusion_PT
from justrelax_tpu_torch.utils.timestep import compute_dt

__all__ = ["KM", "YR", "UPPER", "LOWER", "CHAMBER", "MAGMA", "AIR", "N_PHASE", "run"]

KM = 1.0e3
YR = 3600.0 * 24.0 * 365.25
# phases (the reference's Caldera numbering, conduit and volcano off)
UPPER, LOWER, CHAMBER, MAGMA, AIR = 0, 1, 2, 3, 4
N_PHASE = 5
MELTING = (NoMelting(), NoMelting(), MeltingCaricchi(), MeltingCaricchi(), NoMelting())
ETA0 = [1.0e21, 1.0e21, 1.0e16, 1.0e16, 1.0e17]  # the initial viscosity per phase


def _setup(geometry, chamber_depth=5.0 * KM, chamber_radius=2.0 * KM,
           aspect_x=1.5, chamber_T=1273.0, sticky_air=5.0 * KM):
    """The analytic Caldera_setup.setup2D (flat, no chimney): the cell phase
    (int) and T, numpy."""
    X, Y = geometry.cell_centers_mesh()
    x, z = np.asarray(X), np.asarray(Y)  # z: -20 km .. +5 km
    lx = geometry.li[0]
    Tsurf, Tbot = 273.0, 273.0 + 1350.0
    kappa = 3.0 / (1050.0 * 2.7e3)
    age = 20.0e6 * YR

    depth = -z
    erf_v = np.vectorize(math.erf)
    Thalf = Tsurf + (Tbot - Tsurf) * erf_v(
        np.maximum(depth, 0.0) / (2.0 * np.sqrt(kappa * age))
    )
    T = np.where(depth > 0, Thalf, Tsurf)

    phases = np.where(depth > chamber_depth, LOWER, UPPER)
    # the chamber ellipse (T = chamber_T − 100)
    in_chamber = (
        ((x - lx / 2) / (chamber_radius * aspect_x)) ** 2
        + ((depth - chamber_depth) / chamber_radius) ** 2
    ) <= 1.0
    phases[in_chamber] = CHAMBER
    T = np.where(in_chamber, chamber_T - 100.0, T)
    # the eruptible core, hotter
    in_core = (
        ((x - lx / 2) / (chamber_radius / 1.25 * aspect_x)) ** 2
        + ((depth - (chamber_depth - chamber_radius / 2)) / (chamber_radius / 2)) ** 2
    ) <= 1.0
    phases[in_core] = MAGMA
    T = np.where(in_core, chamber_T, T)
    # sticky air above the initial flat topography z = 0
    phases[depth <= 0] = AIR
    T[depth <= 0] = Tsurf
    return phases, T


def _materials(dtype=None, device=None):
    """The simplified Caldera_rheology.jl: DP-plastic crust, weak magma, air."""
    crust = dict(
        rho0=2.65e3, alpha=3.0e-5, T0=273.0, Cp=1050.0, k=3.0,
        G=2.5e10, Kb=1.0 / 6.0e-11, gravity=9.81,
        disl_A=1.67e-24, disl_n=3.5, disl_E=1.87e5,
        is_plastic=1.0, C=10.0e6, friction_angle=30.0, eta_reg=1.0e16,
    )
    magma = dict(
        rho0=2.45e3, alpha=3.0e-5, T0=273.0, Cp=1150.0, k=1.5,
        G=1.0e10, Kb=1.0 / 6.0e-11, gravity=9.81, eta0=1.0e16,
    )
    air = dict(
        rho0=10.0, Cp=1.0e3, k=15.0, G=2.5e10, Kb=math.inf,
        gravity=9.81, eta0=1.0e17,
    )
    return MaterialStack.make(
        [Material(**crust), Material(**crust), Material(**magma),
         Material(**{**magma, "rho0": 2.4e3}), Material(**air)],
        dtype=dtype, device=device,
    )


def _ratios(particles, p_phase, geometry):
    """The phase ratios from the particles (faces from the centers)."""
    rc, rv = phase_ratios_from_particles(particles, p_phase, N_PHASE, geometry)
    full = phase_ratios_from_field(rc)
    return PhaseRatios(center=rc, vertex=rv, face_x=full.face_x, face_y=full.face_y)


def _thermal_setup(ni, T_c0, f):
    """The ghosted initial temperature, its BCs and the chamber's Dirichlet
    mask (the reference's thermal_anomaly!: the magma phases pinned at
    their temperatures in the thermal solve)."""
    nx, ny = ni
    T_air = 273.0
    Tg = np.full((nx + 2, ny + 2), T_air)
    Tg[1:-1, 1:-1] = T_c0
    thermal_bc = TemperatureBoundaryConditions(
        no_flux=Faces(left=True, right=True),
        constant_value=Faces(top=T_air, bot=float(T_c0[:, 0].max())),
    )
    T = thermal_bcs(torch.as_tensor(Tg, **f), thermal_bc)
    return T, thermal_bc


def _dirichlet(phases_c, T_c0, f):
    hot = (phases_c == CHAMBER) | (phases_c == MAGMA)
    return (torch.as_tensor(hot.astype(float), **f),
            torch.as_tensor(np.where(hot, T_c0, 0.0), **f))


def _with_interior(T, T_cc, bc):
    T = T.clone()
    T[1:-1, 1:-1] = T_cc
    return thermal_bcs(T, bc)


def run(nx=16, ny=8, nt=2, dtype=None, seed=0, device=None):
    """``nt`` coupled steps; returns (stokes, thermal, particles, the marker
    chain, the last step's melt fraction, the last Stokes solve's info).
    ``device`` defaults to the card."""
    device = resolve_device(device)
    lx, lz = 30.0 * KM, 25.0 * KM
    ni = (nx, ny)
    geometry = Geometry(ni, (lx, lz), origin=(0.0, -20.0 * KM))
    stokes = StokesState.make(ni, dtype=dtype, device=device)
    f = dict(dtype=stokes.P.dtype, device=device)
    material = _materials(**f)

    phases_c, T_c0 = _setup(geometry)

    # particles carrying phase, T and the old stress
    particles = init_particles(geometry, nxcell=12, max_xcell=24, min_xcell=6, seed=seed, **f)
    p_phase = torch.round(centroid2particle(torch.as_tensor(phases_c, **f), particles, geometry))
    pT = centroid2particle(torch.as_tensor(T_c0, **f), particles, geometry)
    p_txx = torch.zeros_like(particles.px)
    p_tyy = torch.zeros_like(particles.px)
    p_txy = torch.zeros_like(particles.px)

    # the marker chain on the initial flat topography
    chain = init_marker_chain(geometry, 0.0, **f)
    pr = _ratios(particles, p_phase, geometry)
    phi = update_rock_ratio(pr, air_phase=AIR)

    eta0 = torch.as_tensor(np.choose(phases_c, ETA0), **f)
    stokes = stokes.replace(viscosity=stokes.viscosity.replace(eta=eta0))
    pt_stokes = PTStokesCoeffs.make(
        geometry.li, geometry.di, eps_abs=1.0e-4, eps_rel=1.0e-10,
        Re=math.pi / 2, r=0.7, CFL=0.98 / math.sqrt(2.1),
    )
    flow_bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True)
    )

    T0, thermal_bc = _thermal_setup(ni, T_c0, f)
    thermal = ThermalState.make(ni, dtype=f["dtype"], device=device).replace(T=T0, Told=T0)
    dirichlet = _dirichlet(phases_c, T_c0, f)
    rock_c = torch.as_tensor(np.where(phases_c == AIR, UPPER, phases_c), **f)

    dt = 500.0 * YR
    dt_max = 2.0e3 * YR
    info = phi_m = None
    for _ in range(nt):
        # particles → grid temperature
        thermal = thermal.replace(
            T=_with_interior(thermal.T, particle2centroid(pT, particles, geometry), thermal_bc))

        # the melt fraction, then the variational VEP solve
        T_center = thermal.T[1:-1, 1:-1]
        phi_m = compute_melt_fraction(MELTING, T_center, phase_ratios=pr.center)
        stokes, info = solve_variational(
            stokes, pt_stokes, geometry, flow_bc, material,
            pr.center, pr.vertex, phi, dt, T=T_center,
            iter_max=100_000, nout=2_000, viscosity_cutoff=(1.0e16, 1.0e23),
        )

        # rotate the old particle stresses with the grid vorticity
        w_c = compute_vorticity_center(
            stokes.V.Vx, stokes.V.Vy, 1.0 / geometry.di[0], 1.0 / geometry.di[1])
        w_p = centroid2particle(w_c, particles, geometry)
        p_txx, p_tyy, p_txy = rotate_stress_particles_2d(p_txx, p_tyy, p_txy, w_p, dt)

        dt = float(compute_dt(stokes.V.components, geometry.di, dt_max)) * 0.5

        # thermal diffusion with the chamber anomaly pinned
        pt_thermal = PTThermalCoeffs.from_material(
            material, T_center, stokes.P, dt, geometry.di, geometry.li,
            phase_ratios=pr.center, eps=1.0e-8, CFL=0.95 / math.sqrt(2.0),
        )
        thermal, _ = heatdiffusion_PT(
            thermal, pt_thermal, thermal_bc, dt, geometry,
            material=material, P=stokes.P, phase_ratios=pr.center,
            dirichlet=dirichlet, iter_max=20_000, nout=200, use_kernel=False,
        )

        # subgrid diffusion of the particle temperature
        dt0 = subgrid_characteristic_time(material, T_center, stokes.P, pr.center,
                                          geometry.di)
        pT = subgrid_diffusion(pT, thermal.T[1:-1, 1:-1], thermal.dT[1:-1, 1:-1], dt0,
                               particles, geometry, dt)

        # advect the particles and the chain, refresh the ratios
        V = (stokes.V.Vx, stokes.V.Vy)
        particles = advect_rk2(particles, V, geometry, dt)
        fields = {"phase": p_phase, "T": pT, "txx": p_txx, "tyy": p_tyy, "txy": p_txy}
        particles, fields = move_particles(particles, geometry, fields)
        chain = advect_marker_chain(chain, V, geometry, dt)
        # the per-particle topography correction against the advected chain
        # (Caldera2D.jl:194,435): rock particles above the surface and air
        # particles below it are deactivated, then re-seeded by the
        # injection with the phase the chain implies
        particles, _ = update_phases_given_markerchain(chain, particles, fields["phase"], AIR)
        above_c = phases_from_marker_chain(chain, geometry, 0, 1).to(torch.bool)
        phases_inject = torch.where(above_c, float(AIR), rock_c)
        particles, fields = inject_particles(
            particles, geometry, fields_from_centers={"T": thermal.T[1:-1, 1:-1]},
            phases=phases_inject, fields=fields,
        )
        p_phase, pT = fields["phase"], fields["T"]
        p_txx, p_tyy, p_txy = fields["txx"], fields["tyy"], fields["txy"]
        pr = _ratios(particles, p_phase, geometry)
        phi = update_rock_ratio(pr, air_phase=AIR)

    return stokes, thermal, particles, chain, phi_m, info
