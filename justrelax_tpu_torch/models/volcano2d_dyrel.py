"""Caldera / Volcano2D driven by the DYREL solver (reference
miniapps/benchmarks/stokes2D/Volcano2D/Caldera2D_DYREL.jl).

Counterpart of ``justrelax_tpu/models/volcano2d_dyrel.py``: the analytic
caldera of :mod:`justrelax_tpu_torch.models.volcano2d`, with the Stokes
stage ``solve_dyrel`` (nonlinear viscosity refresh, cutoff) instead of the
variational solve. As in the reference's DYREL variant the solve is
unmasked (the air is a weak phase that carries equations), the particles
get the setup-time topography correction against the flat chain, P starts
lithostatic, and each step couples: particle T → grid → melt fraction →
buoyancy → solve_dyrel → particle stress rotation → CFL dt → PT thermal
diffusion with the chamber pinned → subgrid particle-T diffusion →
particle advection and injection → phase ratios.

Oracle (tests/test_volcano2d_dyrel.py) at 16×8, 2 steps: DYREL's err <
1e-4, an independent force balance on the returned (τ, P) with the
solve-time buoyancy, frozen Vy extremes, physical T, melt in the core.

On the card DYREL's chunks are CUDA graph replays and the thermal solve is
plain by contract (a material and a Dirichlet mask); the model runs no
kernel of the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from justrelax_tpu_torch.core.coeffs import PTThermalCoeffs
from justrelax_tpu_torch.core.device import resolve_device
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.core.state import StokesState, ThermalState
from justrelax_tpu_torch.models.volcano2d import (
    ETA0,
    KM,
    MELTING,
    YR,
    AIR,
    _dirichlet,
    _materials,
    _ratios,
    _setup,
    _thermal_setup,
    _with_interior,
)
from justrelax_tpu_torch.ops.bc import Faces, VelocityBoundaryConditions
from justrelax_tpu_torch.ops.stress_rotation import (
    compute_vorticity_center,
    rotate_stress_particles_2d,
)
from justrelax_tpu_torch.particles.marker_chain import (
    init_marker_chain,
    update_phases_given_markerchain,
)
from justrelax_tpu_torch.particles.particles import (
    advect_rk2,
    centroid2particle,
    init_particles,
    inject_particles,
    move_particles,
    particle2centroid,
    subgrid_characteristic_time,
    subgrid_diffusion,
)
from justrelax_tpu_torch.rheology.materials import compute_density, phase_average
from justrelax_tpu_torch.rheology.melting import compute_melt_fraction
from justrelax_tpu_torch.solvers.dyrel import solve_dyrel
from justrelax_tpu_torch.solvers.thermal import heatdiffusion_PT
from justrelax_tpu_torch.utils.timestep import compute_dt

__all__ = ["run"]


def _rho_gy(material, T, P, pr_c):
    rho = compute_density(material, T=T, P=P, phase_ratios=pr_c)
    return rho * phase_average(material.params.gravity, pr_c).expand(rho.shape)


def run(nx=16, ny=8, nt=2, dtype=None, seed=0, eps=1.0e-4, device=None):
    """``nt`` coupled steps; returns (stokes, thermal, particles, the last
    step's melt fraction, the last DYREL solve's info, ``aux`` with its
    ρg_y). ``eps`` is DYREL's tolerance; ``device`` defaults to the card."""
    device = resolve_device(device)
    lx, lz = 30.0 * KM, 25.0 * KM
    ni = (nx, ny)
    geometry = Geometry(ni, (lx, lz), origin=(0.0, -20.0 * KM))
    stokes = StokesState.make(ni, dtype=dtype, device=device)
    f = dict(dtype=stokes.P.dtype, device=device)
    material = _materials(**f)

    phases_c, T_c0 = _setup(geometry)

    particles = init_particles(geometry, nxcell=12, max_xcell=24, min_xcell=6, seed=seed, **f)
    p_phase = torch.round(centroid2particle(torch.as_tensor(phases_c, **f), particles, geometry))
    # the setup-time topography correction (Caldera2D_DYREL.jl:194): the
    # phases smeared around the initial surface are reconciled with the
    # flat chain before the first solve
    particles, _ = update_phases_given_markerchain(
        init_marker_chain(geometry, 0.0, **f), particles, p_phase, AIR)
    pT = centroid2particle(torch.as_tensor(T_c0, **f), particles, geometry)
    p_txx = torch.zeros_like(particles.px)
    p_tyy = torch.zeros_like(particles.px)
    p_txy = torch.zeros_like(particles.px)
    pr = _ratios(particles, p_phase, geometry)

    eta0 = torch.as_tensor(np.choose(phases_c, ETA0), **f)
    stokes = stokes.replace(viscosity=stokes.viscosity.replace(eta=eta0))
    # lithostatic P (Caldera2D_DYREL.jl:231: P = reverse(cumsum(reverse(ρg_y·dz))))
    rho_gy0 = _rho_gy(material, torch.as_tensor(T_c0, **f), stokes.P, pr.center)
    P_litho = torch.flip(torch.cumsum(torch.flip(rho_gy0 * geometry.di[1], (1,)), dim=1), (1,))
    stokes = stokes.replace(P=P_litho)
    flow_bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True)
    )

    T0, thermal_bc = _thermal_setup(ni, T_c0, f)
    thermal = ThermalState.make(ni, dtype=f["dtype"], device=device).replace(T=T0, Told=T0)
    dirichlet = _dirichlet(phases_c, T_c0, f)
    phases_inject = torch.as_tensor(phases_c, **f)

    dt = 500.0 * YR
    dt_max = 2.0e3 * YR
    info = phi_m = None
    aux = {}
    for _ in range(nt):
        thermal = thermal.replace(
            T=_with_interior(thermal.T, particle2centroid(pT, particles, geometry), thermal_bc))
        T_center = thermal.T[1:-1, 1:-1]
        phi_m = compute_melt_fraction(MELTING, T_center, phase_ratios=pr.center)

        # the phase-blended T- and P-dependent buoyancy, as the reference's
        # ρg argument
        rho_gy = _rho_gy(material, T_center, stokes.P, pr.center)
        # the reference's kwargs (Caldera2D_DYREL.jl:330-350)
        stokes, info = solve_dyrel(
            stokes, geometry, flow_bc, material, pr.center, pr.vertex, dt,
            rho_g=(torch.zeros_like(rho_gy), rho_gy), T=T_center, eps=eps, nout=200,
            iter_max=50_000, total_iter_max=50_000, lambda_relax=1.0,
            linear_viscosity=False, viscosity_relaxation=1.0e-3,
            viscosity_cutoff=(1.0e16, 1.0e23),
        )
        # the solve-time buoyancy, for the independent force balance
        aux = {"rho_gy": rho_gy}

        w_c = compute_vorticity_center(
            stokes.V.Vx, stokes.V.Vy, 1.0 / geometry.di[0], 1.0 / geometry.di[1])
        w_p = centroid2particle(w_c, particles, geometry)
        p_txx, p_tyy, p_txy = rotate_stress_particles_2d(p_txx, p_tyy, p_txy, w_p, dt)

        dt = float(compute_dt(stokes.V.components, geometry.di, dt_max)) * 0.5

        pt_thermal = PTThermalCoeffs.from_material(
            material, T_center, stokes.P, dt, geometry.di, geometry.li,
            phase_ratios=pr.center, eps=1.0e-8, CFL=0.95 / math.sqrt(2.0),
        )
        thermal, _ = heatdiffusion_PT(
            thermal, pt_thermal, thermal_bc, dt, geometry,
            material=material, P=stokes.P, phase_ratios=pr.center,
            dirichlet=dirichlet, iter_max=20_000, nout=200, use_kernel=False,
        )

        dt0 = subgrid_characteristic_time(material, T_center, stokes.P, pr.center,
                                          geometry.di)
        pT = subgrid_diffusion(pT, thermal.T[1:-1, 1:-1], thermal.dT[1:-1, 1:-1], dt0,
                               particles, geometry, dt)

        V = (stokes.V.Vx, stokes.V.Vy)
        particles = advect_rk2(particles, V, geometry, dt)
        fields = {"phase": p_phase, "T": pT, "txx": p_txx, "tyy": p_tyy, "txy": p_txy}
        particles, fields = move_particles(particles, geometry, fields)
        particles, fields = inject_particles(
            particles, geometry, fields_from_centers={"T": thermal.T[1:-1, 1:-1]},
            phases=phases_inject, fields=fields,
        )
        p_phase, pT = fields["phase"], fields["T"]
        p_txx, p_tyy, p_txy = fields["txx"], fields["tyy"], fields["txy"]
        pr = _ratios(particles, p_phase, geometry)

    return stokes, thermal, particles, phi_m, info, aux
