"""Thermal stresses around a magma chamber through DYREL.

Counterpart of ``justrelax_tpu/models/thermal_stresses_dyrel.py``: the
configuration of ``models/thermal_stresses.py`` (a hot chamber in
compressible visco-elastic rock, gravity off, melt-dependent expansivity)
with ``solve_dyrel`` and its α·ΔT/dt pressure source as the Stokes stage.

The model is nondimensional (characteristic length 20 km, viscosity 1e21
Pa·s, temperature 1000 K; ``utils/units.py``): the only forcing is α·ΔT/dt
inside RP, and DYREL's exit test takes min(relative, absolute) per
residual, so in SI units (α·ΔT/dt ≈ 6e-13 1/s) the absolute branch would
certify the zero state at once. P, V and T are dimensionalized at return.

Routes on the card: the thermal solve through the thermal chunk kernel
(B5: K/ρCp tensors, constant values on every face); the Stokes solve
through DYREL, every chunk a CUDA graph replay. The JAX test's values at
32², nt=2 (tests/test_thermal_stresses_dyrel.py): err < 1e-4, P max
11.369 MPa (±2 %), |Vy| max 2.7418e-11 m/s (±2 %), the chamber's P < 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from justrelax_tpu_torch.core.coeffs import PTThermalCoeffs
from justrelax_tpu_torch.core.device import resolve_device
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.core.state import StokesState, ThermalState
from justrelax_tpu_torch.ops.bc import (
    Faces,
    TemperatureBoundaryConditions,
    VelocityBoundaryConditions,
    thermal_bcs,
)
from justrelax_tpu_torch.rheology.materials import Material, MaterialStack
from justrelax_tpu_torch.rheology.melting import (
    MeltingCaricchi,
    NoMelting,
    compute_melt_fraction,
    melt_dependent_alpha,
)
from justrelax_tpu_torch.rheology.phases import phase_ratios_from_field
from justrelax_tpu_torch.solvers.dyrel import solve_dyrel
from justrelax_tpu_torch.solvers.thermal import heatdiffusion_PT
from justrelax_tpu_torch.utils.units import dimensionalize, geo_units, nondimensionalize

__all__ = ["run"]

KM = 1.0e3
ROCK, MAGMA = 0, 1


def run(nx=64, ny=64, nt=2, dtype=None, eps=1.0e-5, device=None, use_kernel=None):
    """The chamber over ``nt`` steps; returns (stokes, thermal, ϕ, info of
    the last Stokes solve, the chamber mask), P, V and T in SI units.
    ``eps`` is DYREL's tolerance; ``device`` defaults to the card;
    ``use_kernel`` applies to the thermal solve, as in every model of the
    port whose path reaches a kernel (the Hopper kernel on the card, the
    plain path on the CPU; ``False`` asks for the plain path)."""
    device = resolve_device(device)
    u = geo_units(length=20.0 * KM, viscosity=1.0e21, temperature=1.0e3)

    def nd(v, q):
        return nondimensionalize(v, q, u)

    lx = ly = nd(20.0 * KM, "length")
    ni = (nx, ny)
    geometry = Geometry(ni, (lx, ly), origin=(-lx / 2, -ly / 2))
    X, Y = geometry.cell_centers_mesh()
    rad = nd(2.5 * KM, "length")
    chamber = np.asarray(X) ** 2 + np.asarray(Y) ** 2 < rad**2
    phases = np.where(chamber, MAGMA, ROCK)

    stokes = StokesState.make(ni, dtype=dtype, device=device)
    f = dict(dtype=stokes.P.dtype, device=device)
    pr = phase_ratios_from_field(torch.as_tensor(phases, device=device), 2, dtype=f["dtype"])

    # the physics of thermal_stresses.run (β_rock = β_magma = 6e-11 1/Pa)
    Kb = nd(1.0 / 6.0e-11, "stress")
    material = MaterialStack.make([
        Material(eta0=nd(1.0e21, "viscosity"), G=nd(2.5e10, "stress"), Kb=Kb, rho0=0.0),
        Material(eta0=nd(1.0e18, "viscosity"), G=nd(1.0e10, "stress"), Kb=Kb, rho0=0.0),
    ], **f)
    eta = torch.as_tensor(np.where(chamber, nd(1.0e18, "viscosity"), nd(1.0e21, "viscosity")),
                          **f)
    eta_v0 = torch.full((nx + 1, ny + 1), nd(1.0e21, "viscosity"), **f)
    alpha_rock = nd(3.0e-5, "expansivity")
    alpha_melt = nd(6.0e-5, "expansivity")
    melting = (NoMelting(), MeltingCaricchi())

    stokes = stokes.replace(viscosity=stokes.viscosity.replace(eta=eta, eta_v=eta_v0))
    flow_bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True))
    zeros_c = torch.zeros(ni, **f)

    T_host = nd(273.15 + 350.0, "temperature")
    T_magma = nd(273.15 + 1200.0, "temperature")
    rr = np.sqrt(np.asarray(X) ** 2 + np.asarray(Y) ** 2)
    T0 = T_host + (T_magma - T_host) * 0.5 * (
        1.0 - np.tanh((rr - rad) / nd(0.5 * KM, "length")))
    thermal = ThermalState.make(ni, dtype=dtype, device=device)
    Tg = np.full((nx + 2, ny + 2), T_host)
    Tg[1:-1, 1:-1] = T0
    thermal_bc = TemperatureBoundaryConditions(
        constant_value=Faces(left=float(T_host), right=float(T_host),
                             top=float(T_host), bot=float(T_host)))
    Tt = thermal_bcs(torch.as_tensor(Tg, **f), thermal_bc)
    thermal = thermal.replace(T=Tt, Told=Tt)

    rho = nd(2.65e3, "density")
    Cp = nd(1.05e3, "heat_capacity")
    k_th = nd(3.0, "conductivity")
    kappa = k_th / (rho * Cp)
    dt = 0.25 * min(geometry.di) ** 2 / kappa  # conduction-limited step
    Kfield = torch.full(ni, k_th, **f)
    RhoCp = torch.full(ni, rho * Cp, **f)

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
        dT = (thermal.T - Told)[1:-1, 1:-1]
        # the Caricchi melt parameterization takes kelvin
        T_dim = dimensionalize(thermal.T[1:-1, 1:-1], "temperature", u)
        phi = compute_melt_fraction(melting, T_dim, phase_ratios=pr.center)
        alpha = melt_dependent_alpha(alpha_rock, alpha_melt, phi)
        stokes, info = solve_dyrel(
            stokes, geometry, flow_bc, material, pr.center, pr.vertex, dt,
            rho_g=(zeros_c, zeros_c), alpha_dT=(alpha * dT).to(f["dtype"]),
            eps=eps, nout=200, iter_max=75_000, total_iter_max=75_000,
        )
        stokes = stokes.replace(P0=stokes.P)

    stokes = stokes.replace(
        P=dimensionalize(stokes.P, "pressure", u),
        V=stokes.V.replace(
            Vx=dimensionalize(stokes.V.Vx, "velocity", u),
            Vy=dimensionalize(stokes.V.Vy, "velocity", u),
        ),
    )
    thermal = thermal.replace(T=dimensionalize(thermal.T, "temperature", u))
    return stokes, thermal, phi, info, chamber
