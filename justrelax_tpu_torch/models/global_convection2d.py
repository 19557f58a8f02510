"""Global mantle convection with WENO-5 temperature advection.

Counterpart of ``justrelax_tpu/models/global_convection2d.py``: a
2890 km-deep mantle box with a half-space-cooling geotherm, a circular
thermal anomaly, and the custom Arrhenius rheology

    η(T, P, z) = η0 · exp((Ea + P·Va)/(R·T) − Ea/(R·T0)) · corr(depth)

with corr = 1 above 660 km, 10 in the lower mantle, 0.1 below 2740 km,
clamped to the viscosity cutoff. Each time step runs a short Picard loop
(η(T, P) → VE Stokes → updated P), then the CFL time step, the PT thermal
diffusion and the WENO-5 advection of T at the centers. Oracle at 32², three
steps (tests/test_global_convection.py): err < 1e-4, T within its BCs, an
η span above 1e3 and an upwelling above the anomaly.

On the card the Stokes solve runs through the VE chunk kernel (B1/B4: free
slip on every face, no ``alpha_dT``). The thermal solve runs on the plain
path by contract: it evaluates ρ(T)·Cp from the material every iteration,
which the thermal chunk kernel's K/ρCp contract does not cover.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.special import erf

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
from justrelax_tpu_torch.ops.interpolation import velocity2center
from justrelax_tpu_torch.rheology.materials import Material, MaterialStack, compute_density
from justrelax_tpu_torch.solvers.stokes2d import solve_ve
from justrelax_tpu_torch.solvers.thermal import heatdiffusion_PT
from justrelax_tpu_torch.utils.timestep import compute_dt

__all__ = ["custom_viscosity", "half_space_cooling_T", "run"]

R_GAS = 8.3145
YR = 3600.0 * 24.0 * 365.25


def custom_viscosity(T, P, depth, eta0=5.0e20, Ea=200.0e3, Va=2.6e-6,
                     T0=1.6e3, cutoff=(1.0e16, 1.0e24)):
    """The custom Arrhenius viscosity with its depth correction, clamped to
    ``cutoff``."""
    eta = eta0 * torch.exp((Ea + P * Va) / (R_GAS * torch.clamp_min(T, 1.0))
                           - Ea / (R_GAS * T0))

    def ind(mask):
        return mask.to(depth.dtype)

    corr = (
        ind(depth <= 660.0e3) * 1.0
        + ind((depth > 660.0e3) & (depth <= 2740.0e3)) * 10.0
        + ind(depth > 2740.0e3) * 0.1
    )
    return torch.clamp(eta * corr, cutoff[0], cutoff[1])


def half_space_cooling_T(zc, kappa, Tm, Tp, Tmin):
    """Half-space-cooling initial T at cell-center depths (numpy)."""
    z = np.abs(np.asarray(zc))
    dTdz = (Tm - Tp) / 2890.0e3
    T_adiabat = Tp + dTdz * z
    t_cool = 100.0e6 * YR
    T_hs = Tmin + (Tm - Tmin) * erf(z * 0.5 / np.sqrt(kappa * t_cool))
    return np.minimum(T_adiabat, T_hs)


def run(n=32, ar=1, nt=5, picard=2, dtype=None, device=None, use_kernel=None):
    """``nt`` coupled steps; returns (geometry, stokes, thermal, info of the
    last Stokes solve, the time reached, (min η, max η) per step).
    ``device`` defaults to the card; ``use_kernel`` applies to the Stokes
    solve (the Hopper kernel on the card, the plain path on the CPU;
    ``False`` asks for the plain path)."""
    device = resolve_device(device)
    nx, ny = n * ar, n
    ni = (nx, ny)
    ly = 2890.0e3
    lx = ly * ar
    geometry = Geometry(ni, (lx, ly), origin=(0.0, -ly))
    xci = geometry.xci
    di = geometry.di

    # material: PT density ρ0 = 3.1e3, α = 1.5e-5, T0 = 0; Cp = 1.2e3, k = 3,
    # G = 70 GPa, incompressible
    rho0, Cp0, k0, G0, g = 3.1e3, 1.2e3, 3.0, 70.0e9, 9.81
    kappa = k0 / (Cp0 * rho0)
    dt_diff = 0.5 * min(di) ** 2 / kappa / 2.01
    viscosity_cutoff = (1.0e16, 1.0e24)

    # temperature: half-space cooling + circular anomaly
    adiabat = 0.3
    Tp = 1900.0
    Tm = Tp + adiabat * 2890.0
    Tmin, Tmax = 300.0, 3.5e3
    Tc = np.broadcast_to(half_space_cooling_T(xci[1], kappa, Tm, Tp, Tmin)[None, :], ni).copy()
    xc_a, yc_a, r_a = 0.5 * lx, -0.75 * ly, 150.0e3
    X, Y = np.meshgrid(xci[0], xci[1], indexing="ij")
    inside = (X - xc_a) ** 2 + (Y - yc_a) ** 2 <= r_a**2
    Tc *= 1.0 + 0.10 * inside  # δT = 10%
    Tc[:, 0] = Tmax
    Tc[:, -1] = Tmin

    thermal = ThermalState.make(ni, dtype=dtype, device=device)
    f = dict(dtype=thermal.T.dtype, device=device)
    material = MaterialStack.make(
        [Material(rho0=rho0, T0=0.0, alpha=1.5e-5, beta=0.0, Cp=Cp0, k=k0, gravity=g)],
        dtype=f["dtype"], device=device)
    thermal_bc = TemperatureBoundaryConditions(
        no_flux=Faces(left=True, right=True),
        constant_value=Faces(top=Tmin, bot=Tmax),
    )
    T_full = torch.zeros((nx + 2, ny + 2), **f)
    T_full[1:-1, 1:-1] = torch.as_tensor(Tc, **f)
    T_full = thermal_bcs(T_full, thermal_bc)
    thermal = thermal.replace(T=T_full, Told=T_full)

    stokes = StokesState.make(ni, dtype=dtype, device=device)
    depth = torch.as_tensor(np.broadcast_to(np.abs(xci[1])[None, :], ni).copy(), **f)
    # lithostatic initial P = ρg·|z|
    rho = compute_density(material, T=thermal.T[1:-1, 1:-1], P=stokes.P)
    stokes = stokes.replace(P=rho * g * depth)

    pt_stokes = PTStokesCoeffs.make(
        geometry.li, di, eps_abs=1.0e-4, eps_rel=1.0e-4, CFL=0.8 / math.sqrt(2.1))
    flow_bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True))
    G = torch.full(ni, G0, **f)
    K = torch.full(ni, math.inf, **f)

    t = 0.0
    dt = dt_diff
    info = None
    eta_hist = []
    for _ in range(nt):
        T_center = thermal.T[1:-1, 1:-1]
        # Picard: custom η(T, P, depth) ↔ VE Stokes
        for _p in range(picard):
            eta = custom_viscosity(T_center, stokes.P, depth, cutoff=viscosity_cutoff)
            stokes = stokes.replace(viscosity=stokes.viscosity.replace(eta=eta))
            rho = compute_density(material, T=T_center, P=stokes.P)
            rho_g = (torch.zeros(ni, **f), rho * g)
            stokes, info = solve_ve(
                stokes, pt_stokes, geometry, flow_bc, rho_g, G, K, dt,
                iter_max=50_000, nout=1_000, use_kernel=use_kernel,
            )
        # the step's one host read: dt and the viscosity's extremes together
        eta_s = stokes.viscosity.eta
        dt, eta_min, eta_max = torch.stack([
            compute_dt(stokes.V.components, di, dt_diff), eta_s.min(), eta_s.max()]).tolist()

        pt_thermal = PTThermalCoeffs.from_material(
            material, T_center, stokes.P, dt, di, geometry.li,
            eps=1.0e-5, CFL=1.0e-3 / math.sqrt(2.1),
        )
        # plain path by contract: ρ(T)·Cp from the material every iteration
        thermal, _ = heatdiffusion_PT(
            thermal, pt_thermal, thermal_bc, dt, geometry,
            material=material, P=stokes.P, iter_max=10_000, nout=100, use_kernel=False,
        )

        # WENO-5 advection of T at the centers
        Vx_c, Vy_c = velocity2center(stokes.V.Vx, stokes.V.Vy)
        T_new = thermal.T.clone()
        T_new[1:-1, 1:-1] = weno_advect(thermal.T[1:-1, 1:-1], (Vx_c, Vy_c), di, dt)
        thermal = thermal.replace(T=thermal_bcs(T_new, thermal_bc))
        t += dt
        eta_hist.append((eta_min, eta_max))

    return geometry, stokes, thermal, info, t, eta_hist
