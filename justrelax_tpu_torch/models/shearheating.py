"""Shear heating benchmark, 2D (Duretz et al. 2014).

Counterpart of ``justrelax_tpu/models/shearheating.py``: a 70×40 km crustal
block at 673 K under compressive pure shear (ε̇ = 5e-14) with a weak circular
inclusion (another dislocation-creep law) at 25 km depth; the viscous
dissipation feeds the thermal solver. The initial viscosity comes from the
background strain rate ("eps" mode). Oracle at 32², five steps
(tests/test_shearheating.py): Stokes residual < 1e-4, shear heating ≥ 0 and
its maximum above five times its median.

Both solves run on the plain path by contract: the two phases' dislocation
exponents (3.0 and 3.3) are not one shared power law, which the VEP chunk
kernel needs; the thermal solve evaluates ρ(T)·Cp and k from the material
every iteration, outside the thermal chunk kernel's K/ρCp contract.
"""

from __future__ import annotations

import math

import torch

from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs, PTThermalCoeffs
from justrelax_tpu_torch.core.device import resolve_device
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.core.state import StokesState, ThermalState
from justrelax_tpu_torch.ops.bc import (
    Faces,
    TemperatureBoundaryConditions,
    VelocityBoundaryConditions,
    flow_bcs,
    thermal_bcs,
)
from justrelax_tpu_torch.ops.heating import compute_shear_heating
from justrelax_tpu_torch.rheology.materials import Material, MaterialStack
from justrelax_tpu_torch.rheology.phases import phase_ratios_from_field
from justrelax_tpu_torch.rheology.viscosity import phase_viscosity
from justrelax_tpu_torch.solvers.stokes2d_vep import solve_vep
from justrelax_tpu_torch.solvers.thermal import heatdiffusion_PT
from justrelax_tpu_torch.utils.timestep import compute_dt

__all__ = ["run", "T0", "EPS_BG"]

T0 = 273.0 + 400.0
EPS_BG = 5.0e-14


def crustal_materials(dtype, device, **extra):
    """The host crust and the weak inclusion: two dislocation-creep laws."""
    common = dict(rho0=2700.0, Cp=1050.0, k=2.5, gravity=9.81, **extra)
    return MaterialStack.make(
        [
            Material(disl_A=3.2e-20, disl_n=3.0, disl_E=276.0e3, **common),
            Material(disl_A=3.16e-26, disl_n=3.3, disl_E=186.0e3, **common),
        ],
        dtype=dtype, device=device,
    )


def run(nx=32, ny=32, nt=5, dtype=None, device=None):
    """``nt`` coupled steps; returns (stokes, thermal, info of the last
    Stokes solve). ``device`` defaults to the card; both solves run on the
    plain path (see the module docstring)."""
    device = resolve_device(device)
    lx, ly = 70.0e3, 40.0e3
    ni = (nx, ny)
    geometry = Geometry(ni, (lx, ly), origin=(0.0, -ly))
    xvi = geometry.xvi

    stokes = StokesState.make(ni, dtype=dtype, device=device)
    f = dict(dtype=stokes.P.dtype, device=device)
    material = crustal_materials(f["dtype"], device)
    X, Y = geometry.cell_centers_mesh()
    depth = -Y
    # the inclusion at 25 km depth inside the 40 km box
    incl = (X - lx / 2) ** 2 + (depth - 25.0e3) ** 2 <= 3.0e3**2
    pr = phase_ratios_from_field(torch.as_tensor(incl.astype(int), device=device), 2,
                                 dtype=f["dtype"])

    thermal = ThermalState.make(ni, dtype=dtype, device=device)
    thermal_bc = TemperatureBoundaryConditions(
        no_flux=Faces(left=True, right=True), constant_value=Faces(top=T0, bot=T0))
    Tt = thermal_bcs(torch.full((nx + 2, ny + 2), T0, **f), thermal_bc)
    thermal = thermal.replace(T=Tt, Told=Tt)

    # initial viscosity from the background strain rate
    T_c = thermal.T[1:-1, 1:-1]
    eta0 = phase_viscosity(material, torch.full(ni, EPS_BG, **f), T_c, pr.center, mode="eps")
    eta0_v = phase_viscosity(
        material, torch.full((nx + 1, ny + 1), EPS_BG, **f),
        torch.full((nx + 1, ny + 1), T0, **f), pr.vertex, mode="eps")
    stokes = stokes.replace(viscosity=stokes.viscosity.replace(eta=eta0, eta_v=eta0_v))

    # compressive pure-shear velocity
    xv = torch.as_tensor(xvi[0], **f)
    yv = torch.as_tensor(xvi[1], **f)
    Vx = (-(xv - lx / 2) * EPS_BG)[:, None].expand(nx + 1, ny + 2)
    Vy = ((ly - torch.abs(yv)) * EPS_BG)[None, :].expand(nx + 2, ny + 1)
    flow_bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True))
    Vx, Vy = flow_bcs((Vx, Vy), flow_bc)
    stokes = stokes.replace(V=stokes.V.replace(Vx=Vx, Vy=Vy))

    kappa = 2.5 / (1050.0 * 2700.0)
    dt_diff = 0.5 * min(geometry.di) ** 2 / kappa / 2.01
    pt_stokes = PTStokesCoeffs.make(
        geometry.li, geometry.di, eps_rel=1.0e-9, eps_abs=1.0e-5, CFL=0.9 / math.sqrt(2.1))

    info = None
    for _ in range(nt):
        T_c = thermal.T[1:-1, 1:-1]
        # plain path by contract: no shared power-law exponent
        stokes, info = solve_vep(
            stokes, pt_stokes, geometry, flow_bc, material, pr.center, pr.vertex, math.inf,
            T=T_c, iter_max=100_000, nout=500, viscosity_cutoff=(1.0e18, 1.0e24),
            use_kernel=False,
        )
        dt = float(compute_dt(stokes.V.components, geometry.di, dt_diff))

        H_s = compute_shear_heating(
            stokes.tau.xx, stokes.tau.yy, stokes.tau.xy_c,
            stokes.tau_o.xx, stokes.tau_o.yy, stokes.tau_o.xy_c,
            stokes.eps.xx, stokes.eps.yy, stokes.eps.xy,
            material, math.inf, phase_ratios=pr.center,
        )
        thermal = thermal.replace(shear_heating=H_s)

        pt_thermal = PTThermalCoeffs.from_material(
            material, thermal.T[1:-1, 1:-1], stokes.P, dt, geometry.di, geometry.li,
            phase_ratios=pr.center, eps=1.0e-5, CFL=1.0e-3 / math.sqrt(2.1),
        )
        # plain path by contract: the material path
        thermal, _ = heatdiffusion_PT(
            thermal, pt_thermal, thermal_bc, dt, geometry,
            material=material, P=stokes.P, phase_ratios=pr.center,
            iter_max=10_000, nout=100, use_kernel=False,
        )
    return stokes, thermal, info
