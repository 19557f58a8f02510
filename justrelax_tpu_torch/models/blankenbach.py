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
JAX package's f64 value, ``bench.py``).
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

__all__ = ["run"]


def run(nx=32, ny=32, nit=10, dtype=None, use_kernel=None, device=None):
    """``nit`` coupled steps; returns (Urms per step, Nu per step, the last
    Stokes solve's info, stokes, thermal). ``device`` defaults to the card;
    ``use_kernel`` reaches the Stokes solve (the VEP chunk kernel on the
    card by default, the plain path on the CPU)."""
    device = resolve_device(device)
    ni = (nx, ny)
    ly = 1000.0e3
    lx = ly
    geometry = Geometry(ni, (lx, ly), origin=(0.0, -ly))
    xci, xvi = geometry.xci, geometry.xvi
    di = geometry.di

    rho0, Cp0, k0, eta0, g = 4000.0, 1250.0, 5.0, 1.0e23, 10.0
    material = Material(rho0=rho0, T0=273.0, alpha=2.5e-5, beta=0.0,
                        Cp=Cp0, k=k0, eta0=eta0, gravity=g)
    kappa = k0 / (Cp0 * rho0)
    dt_diff = 0.9 * min(di) ** 2 / kappa / 4.0

    stokes = StokesState.make(ni, dtype=dtype, device=device)
    f = dict(dtype=stokes.P.dtype, device=device)
    stokes = stokes.replace(viscosity=stokes.viscosity.replace(
        eta=torch.full(ni, eta0, **f), eta_v=torch.full((nx + 1, ny + 1), eta0, **f)))
    pt_stokes = PTStokesCoeffs.make(geometry.li, geometry.di, eps_rel=1.0e-4,
                                    CFL=1.0 / math.sqrt(2.1))
    flow_bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True))

    # temperature profile + rectangular anomaly
    thermal = ThermalState.make(ni, dtype=dtype, device=device)
    dTdZ = (1273.0 - 273.0) / ly
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

    Urms_hist, Nu_hist = [], []
    info = None
    for _ in range(nit):
        T_center = thermal.T[1:-1, 1:-1]
        stokes, info = solve_vep(
            stokes, pt_stokes, geometry, flow_bc, material, None, None, math.inf,
            T=T_center, iter_max=150_000, nout=200, use_kernel=use_kernel)
        dt = float(compute_dt(stokes.V.components, di, dt_diff))

        pt_thermal = PTThermalCoeffs.from_material(
            material, thermal.T[1:-1, 1:-1], stokes.P, dt, di, geometry.li,
            eps=1.0e-5, CFL=0.99 / math.sqrt(2.1))
        # ρ(T)·Cp and k are evaluated from the material every iteration,
        # which the thermal chunk kernel does not cover (its contract is the
        # K/ρCp path, as B5's is): the plain path is asked for explicitly.
        thermal, _ = heatdiffusion_PT(
            thermal, pt_thermal, thermal_bc, dt, geometry, material=material, P=stokes.P,
            iter_max=10_000, nout=100, use_kernel=False)

        # Nusselt number at the top
        dT_top = torch.abs(thermal.T[1:-1, -1] - thermal.T[1:-1, -2]) / di[1]
        Nu_hist.append(float((ly / (1000.0 * lx)) * torch.sum(dT_top * di[0])))

        # rms velocity
        Vx_v, Vy_v = velocity2vertex(stokes.V.Vx, stokes.V.Vy)
        vmag2 = Vx_v**2 + Vy_v**2
        Urms_hist.append(float(
            torch.sqrt(torch.sum(vmag2 * di[0] * di[1]) / lx / ly) * (ly * rho0 * Cp0 / k0)))

        # WENO-5 temperature advection at the cell centers
        Vx_c, Vy_c = velocity2center(stokes.V.Vx, stokes.V.Vy)
        Tc = weno_advect(thermal.T[1:-1, 1:-1], (Vx_c, Vy_c), di, dt)
        thermal = thermal.replace(T=thermal_bcs(interior_set(thermal.T, Tc), thermal_bc))

    return Urms_hist, Nu_hist, info, stokes, thermal
