"""Thermal stresses around a magma chamber (Kiss et al. 2023 physics).

Counterpart of ``justrelax_tpu/models/thermal_stresses.py``: a hot chamber
inside compressible visco-elastic rock. Each step: PT thermal diffusion →
ΔT = T − Told → melt fraction (Caricchi) → melt-dependent expansivity →
compressible VE Stokes with the α·ΔT/dt pressure source. Heating expands the
chamber against the visco-elastic host, building an over-pressure ~K·α·ΔT
that relaxes on the host's Maxwell time; gravity is off, so the pressure
anomaly is purely thermal. Oracle at 48², two steps
(tests/test_thermal_stresses.py): a molten core, a solid host, the heated
host shell over-pressured and the rim under-pressured, both far above the
far field, and |P| below 1.5·K·α·|ΔT|.

Routes on the card: in 2D (:func:`run`) the thermal solve runs through the
thermal chunk kernel (B5: K/ρCp tensors, constant values on every face);
the Stokes solve runs on the plain path by contract, since the VE chunk
kernel does not take the ``alpha_dT`` source. In 3D (:func:`run_3d`) both
run on the plain path by contract: the thermal kernel is 2D, and the 3D VE
kernel does not take ``alpha_dT`` either.
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
from justrelax_tpu_torch.rheology.melting import (
    MeltingCaricchi,
    NoMelting,
    compute_melt_fraction,
    melt_dependent_alpha,
)
from justrelax_tpu_torch.rheology.phases import phase_ratios_from_field
from justrelax_tpu_torch.solvers.stokes2d import solve_ve
from justrelax_tpu_torch.solvers.stokes3d import solve_ve_3d
from justrelax_tpu_torch.solvers.thermal import heatdiffusion_PT

__all__ = ["run", "run_3d"]

KM = 1.0e3
ROCK, MAGMA = 0, 1
T_HOST, T_MAGMA = 273.15 + 350.0, 273.15 + 1200.0
ALPHA_ROCK, ALPHA_MELT = 3.0e-5, 6.0e-5
BETA = 6.0e-11  # 1/Pa, both phases
RHO, CP, K_TH = 2.65e3, 1.05e3, 3.0


def _chamber_T(rr, rad):
    """Cold host, hot chamber, with a smooth tanh edge (numpy)."""
    return T_HOST + (T_MAGMA - T_HOST) * 0.5 * (1.0 - np.tanh((rr - rad) / (0.5 * KM)))


def _step_alpha_dT(thermal, Told, melting, pr_center):
    """α(ϕ(T))·ΔT at the cell centers after a thermal solve, and ϕ."""
    inner = (slice(1, -1),) * thermal.T.ndim
    dT = (thermal.T - Told)[inner]
    phi = compute_melt_fraction(melting, thermal.T[inner], phase_ratios=pr_center)
    return melt_dependent_alpha(ALPHA_ROCK, ALPHA_MELT, phi) * dT, phi


def run(nx=64, ny=64, nt=2, dtype=None, device=None, use_kernel=None,
        stokes_iter_max=100_000):
    """The 2D chamber over ``nt`` steps; returns (stokes, thermal, ϕ, info
    of the last Stokes solve, the chamber mask). ``device`` defaults to the
    card; ``use_kernel`` applies to the thermal solve (the Hopper kernel on
    the card, the plain path on the CPU; ``False`` asks for the plain
    path); ``stokes_iter_max`` caps each Stokes solve."""
    device = resolve_device(device)
    lx = ly = 20.0 * KM
    ni = (nx, ny)
    geometry = Geometry(ni, (lx, ly), origin=(-lx / 2, -ly / 2))
    X, Y = geometry.cell_centers_mesh()
    rad = 2.5 * KM
    chamber = np.asarray(X) ** 2 + np.asarray(Y) ** 2 < rad**2
    phases = np.where(chamber, MAGMA, ROCK)

    stokes = StokesState.make(ni, dtype=dtype, device=device)
    f = dict(dtype=stokes.P.dtype, device=device)
    pr = phase_ratios_from_field(torch.as_tensor(phases, device=device), 2, dtype=f["dtype"])

    # material fields (rock / magma)
    eta = torch.as_tensor(np.where(chamber, 1.0e18, 1.0e21), **f)
    G = torch.as_tensor(np.where(chamber, 1.0e10, 2.5e10), **f)
    K = torch.tensor(1.0 / BETA, **f)
    melting = (NoMelting(), MeltingCaricchi())

    stokes = stokes.replace(viscosity=stokes.viscosity.replace(eta=eta))
    pt_stokes = PTStokesCoeffs.make(
        geometry.li, geometry.di, eps_rel=1.0e-6, eps_abs=1.0e-8, CFL=0.9 / math.sqrt(2.1))
    flow_bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True))
    zeros_c = torch.zeros(ni, **f)
    rho_g = (zeros_c, zeros_c)  # gravity off: isolate the thermal pressurization

    rr = np.sqrt(np.asarray(X) ** 2 + np.asarray(Y) ** 2)
    thermal = ThermalState.make(ni, dtype=dtype, device=device)
    Tg = np.full((nx + 2, ny + 2), T_HOST)
    Tg[1:-1, 1:-1] = _chamber_T(rr, rad)
    thermal_bc = TemperatureBoundaryConditions(
        constant_value=Faces(left=T_HOST, right=T_HOST, top=T_HOST, bot=T_HOST))
    Tt = thermal_bcs(torch.as_tensor(Tg, **f), thermal_bc)
    thermal = thermal.replace(T=Tt, Told=Tt)

    kappa = K_TH / (RHO * CP)
    dt = 0.25 * min(geometry.di) ** 2 / kappa  # conduction-limited step
    Kfield = torch.full(ni, K_TH, **f)
    RhoCp = torch.full(ni, RHO * CP, **f)

    info = None
    phi = None
    for _ in range(nt):
        Told = thermal.T
        pt_thermal = PTThermalCoeffs.make(
            Kfield, RhoCp, dt, geometry.di, geometry.li, eps=1.0e-8, CFL=0.95 / math.sqrt(2.0))
        thermal, _ = heatdiffusion_PT(
            thermal, pt_thermal, thermal_bc, dt, geometry,
            K=Kfield, rho_Cp=RhoCp, iter_max=20_000, nout=200, use_kernel=use_kernel,
        )
        alpha_dT, phi = _step_alpha_dT(thermal, Told, melting, pr.center)
        # plain path by contract: the VE chunk kernel does not take alpha_dT
        stokes, info = solve_ve(
            stokes, pt_stokes, geometry, flow_bc, rho_g, G, K, dt,
            iter_max=stokes_iter_max, nout=1_000, alpha_dT=alpha_dT, use_kernel=False,
        )
        stokes = stokes.replace(P0=stokes.P)

    return stokes, thermal, phi, info, chamber


def run_3d(n=24, nt=2, dtype=None, device=None):
    """The spherical chamber in a 20 km box over ``nt`` steps, the physics
    of :func:`run`; returns (stokes, thermal, ϕ, info of the last Stokes
    solve, the chamber mask). ``device`` defaults to the card; both solves
    run on the plain path (see the module docstring)."""
    device = resolve_device(device)
    lx = ly = lz = 20.0 * KM
    ni = (n, n, n)
    geometry = Geometry(ni, (lx, ly, lz), origin=(-lx / 2, -ly / 2, -lz / 2))
    Xc = [np.asarray(c) for c in geometry.xci]
    X, Y, Z = np.meshgrid(*Xc, indexing="ij")
    rad = 2.5 * KM
    rr = np.sqrt(X**2 + Y**2 + Z**2)
    chamber = rr < rad

    stokes = StokesState.make(ni, dtype=dtype, device=device)
    f = dict(dtype=stokes.P.dtype, device=device)
    eta = torch.as_tensor(np.where(chamber, 1.0e18, 1.0e21), **f)
    G = torch.as_tensor(np.where(chamber, 1.0e10, 2.5e10), **f)
    K = torch.full(ni, 1.0 / BETA, **f)
    melting = (NoMelting(), MeltingCaricchi())
    pr = phase_ratios_from_field(torch.as_tensor(chamber.astype(int), device=device), 2,
                                 dtype=f["dtype"])

    stokes = stokes.replace(viscosity=stokes.viscosity.replace(eta=eta))
    pt_stokes = PTStokesCoeffs.make(
        geometry.li, geometry.di, eps_rel=1.0e-5, eps_abs=1.0e-8, CFL=0.9 / math.sqrt(3.1))
    flow_bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True, front=True, back=True))
    zeros_c = torch.zeros(ni, **f)
    rho_g3 = (zeros_c, zeros_c, zeros_c)

    thermal = ThermalState.make(ni, dtype=dtype, device=device)
    Tg = np.full((n + 2, n + 2, n + 2), T_HOST)
    Tg[1:-1, 1:-1, 1:-1] = _chamber_T(rr, rad)
    thermal_bc = TemperatureBoundaryConditions(
        constant_value=Faces(left=T_HOST, right=T_HOST, top=T_HOST, bot=T_HOST,
                             front=T_HOST, back=T_HOST))
    Tt = thermal_bcs(torch.as_tensor(Tg, **f), thermal_bc)
    thermal = thermal.replace(T=Tt, Told=Tt)

    kappa = K_TH / (RHO * CP)
    dt = 0.25 * min(geometry.di) ** 2 / kappa
    Kfield = torch.full(ni, K_TH, **f)
    RhoCp = torch.full(ni, RHO * CP, **f)

    info = None
    phi = None
    for _ in range(nt):
        Told = thermal.T
        pt_thermal = PTThermalCoeffs.make(
            Kfield, RhoCp, dt, geometry.di, geometry.li, eps=1.0e-8, CFL=0.95 / math.sqrt(3.0))
        # plain path by contract: the thermal chunk kernel is 2D
        thermal, _ = heatdiffusion_PT(
            thermal, pt_thermal, thermal_bc, dt, geometry,
            K=Kfield, rho_Cp=RhoCp, iter_max=20_000, nout=200, use_kernel=False,
        )
        alpha_dT, phi = _step_alpha_dT(thermal, Told, melting, pr.center)
        # plain path by contract: the 3D VE chunk kernel does not take alpha_dT
        stokes, info = solve_ve_3d(
            stokes, pt_stokes, geometry, flow_bc, rho_g3, G, K, dt,
            iter_max=100_000, nout=500, alpha_dT=alpha_dT, use_kernel=False,
        )
        stokes = stokes.replace(P0=stokes.P)

    return stokes, thermal, phi, info, chamber
