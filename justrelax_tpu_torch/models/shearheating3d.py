"""Shear heating benchmark, 3D (Duretz et al. 2014).

Counterpart of ``justrelax_tpu/models/shearheating3d.py``: a 70×60×40 km
crustal block at 673 K under compressive pure shear with a weak spherical
inclusion; the viscous dissipation feeds the 3D PT thermal solver. The
nonlinear viscosity is handled by two Picard passes per step (η from T and
the strain-rate invariant, "eps" mode, then the VE solve). Oracle at 12³,
two steps, rc = 8 km (tests/test_shearheating3d.py): Stokes residual
< 1e-4, shear heating ≥ 0 with a positive maximum, T above 674 K somewhere,
and more heating at the inclusion than in the far field.

On the card the Stokes solves run through the 3D VE chunk kernel (B7: free
slip on six faces, no ``alpha_dT``). The thermal solve runs on the plain
path by contract: it is 3D, and it evaluates the material every iteration.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs, PTThermalCoeffs
from justrelax_tpu_torch.core.device import resolve_device
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.core.state import StokesState, ThermalState
from justrelax_tpu_torch.models.shearheating import EPS_BG, T0, crustal_materials
from justrelax_tpu_torch.ops import stokes3d as k3
from justrelax_tpu_torch.ops.bc import (
    Faces,
    TemperatureBoundaryConditions,
    VelocityBoundaryConditions,
    flow_bcs,
    thermal_bcs,
)
from justrelax_tpu_torch.ops.heating import (
    compute_shear_heating_3d,
    shear_components_to_centers_3d,
)
from justrelax_tpu_torch.rheology.phases import phase_ratios_from_field
from justrelax_tpu_torch.rheology.viscosity import phase_viscosity
from justrelax_tpu_torch.solvers.stokes3d import solve_ve_3d
from justrelax_tpu_torch.solvers.thermal import heatdiffusion_PT
from justrelax_tpu_torch.utils.timestep import compute_dt

__all__ = ["run"]


def run(nx=16, ny=16, nz=16, nt=3, rc=3.0e3, dtype=None, device=None, use_kernel=None):
    """``nt`` coupled steps; returns (stokes, thermal, info of the last
    Stokes solve). ``device`` defaults to the card; ``use_kernel`` applies
    to the Stokes solves (the Hopper kernel on the card, the plain path on
    the CPU; ``False`` asks for the plain path)."""
    device = resolve_device(device)
    lx, ly, lz = 70.0e3, 60.0e3, 40.0e3
    ni = (nx, ny, nz)
    geometry = Geometry(ni, (lx, ly, lz), origin=(0.0, 0.0, -lz))
    xvi = geometry.xvi

    stokes = StokesState.make(ni, dtype=dtype, device=device)
    f = dict(dtype=stokes.P.dtype, device=device)
    material = crustal_materials(f["dtype"], device, G=math.inf)
    X, Y, Z = geometry.cell_centers_mesh()
    incl = (
        (np.asarray(X) - lx / 2) ** 2
        + (np.asarray(Y) - ly / 2) ** 2
        + (np.asarray(Z) + 25.0e3) ** 2
        <= rc**2
    )
    pr = phase_ratios_from_field(torch.as_tensor(incl.astype(int), device=device), 2,
                                 dtype=f["dtype"])

    thermal = ThermalState.make(ni, dtype=dtype, device=device)
    thermal_bc = TemperatureBoundaryConditions(
        no_flux=Faces(left=True, right=True, front=True, back=True),
        constant_value=Faces(top=T0, bot=T0),
    )
    Tt = thermal_bcs(torch.full((nx + 2, ny + 2, nz + 2), T0, **f), thermal_bc)
    thermal = thermal.replace(T=Tt, Told=Tt)

    flow_bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True, front=True, back=True))
    # compressive pure shear: shortening along x, extrusion along z
    xv = torch.as_tensor(xvi[0], **f)
    zv = torch.as_tensor(xvi[2], **f)
    Vx = (-(xv - lx / 2) * EPS_BG)[:, None, None].expand(nx + 1, ny + 2, nz + 2)
    Vy = torch.zeros((nx + 2, ny + 1, nz + 2), **f)
    Vz = ((zv + lz / 2) * EPS_BG)[None, None, :].expand(nx + 2, ny + 2, nz + 1)
    Vx, Vy, Vz = flow_bcs((Vx, Vy, Vz), flow_bc)
    stokes = stokes.replace(V=stokes.V.replace(Vx=Vx, Vy=Vy, Vz=Vz))

    pt_stokes = PTStokesCoeffs.make(
        geometry.li, geometry.di, eps_rel=1.0e-9, eps_abs=1.0e-5, CFL=0.9 / math.sqrt(3.1))
    kappa = 2.5 / (1050.0 * 2700.0)
    dt_diff = 0.5 * min(geometry.di) ** 2 / kappa / 3.01
    zeros = torch.zeros(ni, **f)
    K_inf = torch.tensor(math.inf, **f)
    G_field = torch.full(ni, math.inf, **f)
    visc_cut = (1.0e18, 1.0e24)
    inv_di = tuple(1.0 / d for d in geometry.di)

    def strain_rate_6(stokes):
        V = stokes.V
        grad_V = k3.compute_grad_V_3d(V.Vx, V.Vy, V.Vz, inv_di)
        return k3.compute_strain_rate_3d(grad_V, V.Vx, V.Vy, V.Vz, inv_di)

    info = None
    eII = torch.full(ni, EPS_BG, **f)
    for _ in range(nt):
        T_c = thermal.T[1:-1, 1:-1, 1:-1]
        # Picard refresh: viscosity from the current T and strain-rate invariant
        for _pic in range(2):
            eta = torch.clamp(phase_viscosity(material, eII, T_c, pr.center, mode="eps"),
                              *visc_cut)
            stokes = stokes.replace(viscosity=stokes.viscosity.replace(eta=eta))
            stokes, info = solve_ve_3d(
                stokes, pt_stokes, geometry, flow_bc, (zeros, zeros, zeros),
                G_field, K_inf, math.inf, iter_max=20_000, nout=500, use_kernel=use_kernel,
            )
            eII = torch.clamp_min(
                k3.tensor_invariant_staggered_3d(*strain_rate_6(stokes)), 1.0e-18)
        dt = float(compute_dt(stokes.V.components, geometry.di, dt_diff))

        tau = stokes.tau
        yz_c, xz_c, xy_c = shear_components_to_centers_3d(tau.yz, tau.xz, tau.xy)
        exx, eyy, ezz, eyz, exz, exy = strain_rate_6(stokes)
        eyz_c, exz_c, exy_c = shear_components_to_centers_3d(eyz, exz, exy)
        tau_c = (tau.xx, tau.yy, tau.zz, yz_c, xz_c, xy_c)
        H_s = compute_shear_heating_3d(
            tau_c, tau_c,  # G = ∞: no elastic part
            (exx, eyy, ezz, eyz_c, exz_c, exy_c),
            material, math.inf, phase_ratios=pr.center,
        )
        thermal = thermal.replace(shear_heating=H_s)

        pt_thermal = PTThermalCoeffs.from_material(
            material, T_c, stokes.P, dt, geometry.di, geometry.li,
            phase_ratios=pr.center, eps=1.0e-5, CFL=0.95 / math.sqrt(3.0),
        )
        # plain path by contract: 3D, and the material path
        thermal, _ = heatdiffusion_PT(
            thermal, pt_thermal, thermal_bc, dt, geometry,
            material=material, P=stokes.P, phase_ratios=pr.center,
            iter_max=10_000, nout=100, use_kernel=False,
        )
    return stokes, thermal, info
