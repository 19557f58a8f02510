"""Blankenbach thermal convection benchmark (Ra = 1e4, case 1).

Counterpart of ``justrelax_tpu/models/blankenbach.py::run``: a 1000 km
square box, linear geotherm 273→1273 K with a +20 K square anomaly near the
left wall at 600 km depth, PT_Density (ρ0 = 4000, α = 2.5e-5), η = 1e23,
k = 5, Cp = 1250, g = 10. Each step: VEP Stokes solve (viscous limit,
buoyancy ρ(T)·g) → CFL time step → PT thermal diffusion → WENO-5
temperature advection at the cell centers.

Golden values at 32², 10 steps (tests/test_blankenbach.py): Urms ≈
0.40987052065118357 (rtol 1e-1), Nu_top ≈ 1.0026242251320245 (rtol 1e-2),
Stokes residual < 1e-4; Urms after the first step 0.29207194481326537 (the
JAX package's f64 value, ``bench.py``). ``run_particles`` carries T on
particles instead of the WENO-5 advection (the reference's own scheme),
with the same goldens (Urms within 20 %).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from justrelax_tpu_torch.advection.weno5 import weno_advect
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
from justrelax_tpu_torch.ops.interpolation import velocity2center, velocity2vertex
from justrelax_tpu_torch.ops.stencil import interior_set
from justrelax_tpu_torch.rheology.materials import Material
from justrelax_tpu_torch.solvers.stokes2d_vep import solve_vep
from justrelax_tpu_torch.solvers.thermal import heatdiffusion_PT
from justrelax_tpu_torch.utils.timestep import compute_dt

__all__ = ["run", "run_particles"]


RHO0, CP0, K0, ETA0, G0 = 4000.0, 1250.0, 5.0, 1.0e23, 10.0
LY = LX = 1000.0e3


def _setup(nx, ny, dtype, device):
    """Grid, material, diffusive time-step limit, the Stokes state (η = η0)
    with its coefficients and BCs, and the thermal state (geotherm with the
    anomaly) with its BCs."""
    ni = (nx, ny)
    geometry = Geometry(ni, (LX, LY), origin=(0.0, -LY))
    xci, xvi = geometry.xci, geometry.xvi
    di = geometry.di
    material = Material(rho0=RHO0, T0=273.0, alpha=2.5e-5, beta=0.0,
                        Cp=CP0, k=K0, eta0=ETA0, gravity=G0)
    kappa = K0 / (CP0 * RHO0)
    dt_diff = 0.9 * min(di) ** 2 / kappa / 4.0

    stokes = StokesState.make(ni, dtype=dtype, device=device)
    f = dict(dtype=stokes.P.dtype, device=device)
    stokes = stokes.replace(viscosity=stokes.viscosity.replace(
        eta=torch.full(ni, ETA0, **f), eta_v=torch.full((nx + 1, ny + 1), ETA0, **f)))
    pt_stokes = PTStokesCoeffs.make(geometry.li, geometry.di, eps_rel=1.0e-4,
                                    CFL=1.0 / math.sqrt(2.1))
    flow_bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True))

    # temperature profile + rectangular anomaly
    thermal = ThermalState.make(ni, dtype=dtype, device=device)
    dTdZ = (1273.0 - 273.0) / LY
    T = np.zeros((nx + 2, ny + 2))
    T[:, 1:-1] = (-xci[1])[None, :] * dTdZ + 273.0
    X, Y = np.meshgrid(xci[0], xci[1], indexing="ij")
    mask = ((X - 0.0) ** 2 <= 100.0e3**2) & ((Y + 600.0e3) ** 2 <= 100.0e3**2)
    T[1:-1, 1:-1] += 20.0 * mask
    Tbot = float(-xvi[1][0] * dTdZ + 273.0)
    thermal_bc = TemperatureBoundaryConditions(
        no_flux=Faces(left=True, right=True), constant_value=Faces(top=273.0, bot=Tbot))
    T = thermal_bcs(torch.as_tensor(T, **f), thermal_bc)
    thermal = thermal.replace(T=T, Told=T)
    return geometry, material, dt_diff, stokes, pt_stokes, flow_bc, thermal, thermal_bc


def _stokes(stokes, pt_stokes, geometry, flow_bc, material, T_center, use_kernel):
    """The viscous-limit VEP Stokes solve with buoyancy ρ(T)·g."""
    return solve_vep(stokes, pt_stokes, geometry, flow_bc, material, None, None, math.inf,
                     T=T_center, iter_max=150_000, nout=200, use_kernel=use_kernel)


def _thermal(thermal, thermal_bc, material, P, dt, geometry):
    """The PT thermal step on the material path.

    ρ(T)·Cp and k are evaluated from the material every iteration, which
    the thermal chunk kernel does not cover (its contract is the K/ρCp
    path, as B5's is): the plain path is asked for explicitly."""
    pt_thermal = PTThermalCoeffs.from_material(
        material, thermal.T[1:-1, 1:-1], P, dt, geometry.di, geometry.li,
        eps=1.0e-5, CFL=0.99 / math.sqrt(2.1))
    thermal, _ = heatdiffusion_PT(
        thermal, pt_thermal, thermal_bc, dt, geometry, material=material, P=P,
        iter_max=10_000, nout=100, use_kernel=False)
    return thermal


def _diagnostics(stokes, thermal, di):
    """(Nusselt number at the top, rms velocity)."""
    dT_top = torch.abs(thermal.T[1:-1, -1] - thermal.T[1:-1, -2]) / di[1]
    Nu = float((LY / (1000.0 * LX)) * torch.sum(dT_top * di[0]))
    Vx_v, Vy_v = velocity2vertex(stokes.V.Vx, stokes.V.Vy)
    vmag2 = Vx_v**2 + Vy_v**2
    Urms = float(torch.sqrt(torch.sum(vmag2 * di[0] * di[1]) / LX / LY)
                 * (LY * RHO0 * CP0 / K0))
    return Nu, Urms


def run(nx=32, ny=32, nit=10, dtype=None, use_kernel=None, device=None):
    """``nit`` coupled steps; returns (Urms per step, Nu per step, the last
    Stokes solve's info, stokes, thermal). ``device`` defaults to the card;
    ``use_kernel`` reaches the Stokes solve (the VEP chunk kernel on the
    card by default, the plain path on the CPU)."""
    device = resolve_device(device)
    (geometry, material, dt_diff, stokes, pt_stokes, flow_bc, thermal,
     thermal_bc) = _setup(nx, ny, dtype, device)
    di = geometry.di

    Urms_hist, Nu_hist = [], []
    info = None
    for _ in range(nit):
        stokes, info = _stokes(stokes, pt_stokes, geometry, flow_bc, material,
                               thermal.T[1:-1, 1:-1], use_kernel)
        dt = float(compute_dt(stokes.V.components, di, dt_diff))
        thermal = _thermal(thermal, thermal_bc, material, stokes.P, dt, geometry)
        Nu, Urms = _diagnostics(stokes, thermal, di)
        Nu_hist.append(Nu)
        Urms_hist.append(Urms)

        # WENO-5 temperature advection at the cell centers
        Vx_c, Vy_c = velocity2center(stokes.V.Vx, stokes.V.Vy)
        Tc = weno_advect(thermal.T[1:-1, 1:-1], (Vx_c, Vy_c), di, dt)
        thermal = thermal.replace(T=thermal_bcs(interior_set(thermal.T, Tc), thermal_bc))

    return Urms_hist, Nu_hist, info, stokes, thermal


def run_particles(nx=32, ny=32, nit=10, dtype=None, seed=0, use_kernel=None, device=None):
    """The reference's own transport scheme: particles (24 per cell, 36
    slots, at least 12) carry T, relaxed toward the grid solution by
    subgrid diffusion, advected with RK2, re-slotted and refilled (new
    particles interpolate T from the centers), and interpolated back to the
    centroids (test_Blankenbach.jl:100-260). Per step: Stokes → CFL dt →
    thermal diffusion → subgrid diffusion → advect/move/inject →
    diagnostics → particle2centroid → T. Same returns and goldens as
    :func:`run` (tests/test_blankenbach.py: Urms within 20 %, Nu within 1 %,
    residual < 1e-4, Urms growing after step 3); routes as :func:`run`."""
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

    device = resolve_device(device)
    (geometry, material, dt_diff, stokes, pt_stokes, flow_bc, thermal,
     thermal_bc) = _setup(nx, ny, dtype, device)
    di = geometry.di
    f = dict(dtype=stokes.P.dtype, device=device)

    particles = init_particles(geometry, nxcell=24, max_xcell=36, min_xcell=12, seed=seed,
                               **f)
    pT = centroid2particle(thermal.T, particles, geometry)  # ghosted lattice
    p_phase = torch.zeros_like(particles.px)  # single phase
    cell_phase = torch.zeros((nx, ny), **f)

    Urms_hist, Nu_hist = [], []
    info = None
    for _ in range(nit):
        T_center = thermal.T[1:-1, 1:-1]
        stokes, info = _stokes(stokes, pt_stokes, geometry, flow_bc, material, T_center,
                               use_kernel)
        dt = float(compute_dt(stokes.V.components, di, dt_diff))
        thermal = _thermal(thermal, thermal_bc, material, stokes.P, dt, geometry)

        # subgrid relaxation of the particle temperature toward the grid
        dt0 = subgrid_characteristic_time(material, T_center, stokes.P, None, di)
        pT = subgrid_diffusion(pT, thermal.T, thermal.dT, dt0, particles, geometry, dt)

        # advect + rebin + inject
        particles = advect_rk2(particles, stokes.V.components, geometry, dt)
        fields = {"phase": p_phase, "T": pT}
        particles, fields = move_particles(particles, geometry, fields)
        particles, fields = inject_particles(
            particles, geometry, fields_from_centers={"T": thermal.T[1:-1, 1:-1]},
            phases=cell_phase, fields=fields)
        p_phase, pT = fields["phase"], fields["T"]

        Nu, Urms = _diagnostics(stokes, thermal, di)
        Nu_hist.append(Nu)
        Urms_hist.append(Urms)

        # particles → grid temperature closes the step
        T_cc = particle2centroid(pT, particles, geometry)
        thermal = thermal.replace(T=thermal_bcs(interior_set(thermal.T, T_cc), thermal_bc))

    return Urms_hist, Nu_hist, info, stokes, thermal
