"""3D layered-lithosphere convection with particles
(reference miniapps/convection/Particles3D/Layered_convection3D.jl).

Counterpart of ``justrelax_tpu/models/layered_convection3d.py``: a
lithosphere column (upper crust, lower crust, mantle; phases on particles)
with a hot spherical anomaly seeding a plume; each step: multi-phase 3D VEP
Stokes → CFL dt → PT thermal diffusion (K/ρCp) → RK2 particle transport,
re-slotting, injection → phase ratios. Dimensional SI inputs (the
nondimensional workflow is the 2D twin's, models/layered_convection_nondim.py).

Oracle at 12³, 2 steps, 6/12/3 particles (tests/test_layered_convection3d.py):
residual < 1e-5, all three phases on active particles, T inside the
geotherm window, upward flow, and the frozen goldens max Vz after step 1
7.086241845485486e-11 (rtol 1e-5) and max T 1542.5441453335352 (rtol 1e-6).

Both solves run on the plain path by contract, on the card too: the creep
table mixes stress exponents (4, 3.2, 3.5), which no 3D VEP kernel route
takes (they need a linear or shared-exponent table), and the thermal chunk
kernel is 2D.
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
from justrelax_tpu_torch.particles.particles3d import (
    advect_rk2_3d,
    init_particles_3d,
    inject_particles_3d,
    move_particles_3d,
    phase_ratios_from_particles_3d,
)
from justrelax_tpu_torch.rheology.materials import (
    Material,
    MaterialStack,
    compute_conductivity,
    compute_rhoCp,
)
from justrelax_tpu_torch.rheology.phases import phase_ratios_from_field
from justrelax_tpu_torch.solvers.stokes3d_vep import solve_vep_3d
from justrelax_tpu_torch.solvers.thermal import heatdiffusion_PT
from justrelax_tpu_torch.utils.timestep import compute_dt

__all__ = ["NPHASE", "run"]

NPHASE = 3


def run(nx=16, ny=16, nz=16, nt=2, nxcell=8, max_xcell=16, min_xcell=4, dtype=None,
        device=None):
    """``nt`` coupled steps; returns (stokes, thermal, particles, phase, the
    last Stokes solve's info, max |Vz| per step). ``device`` defaults to the
    card."""
    device = resolve_device(device)
    lx, ly, lz = 100.0e3, 100.0e3, 110.0e3
    ni = (nx, ny, nz)
    geometry = Geometry(ni, (lx, ly, lz), origin=(0.0, 0.0, -lz))
    xci = geometry.xci

    z_moho = 35.0e3
    T_top, T_moho, T_bot = 273.0, 923.0, 1492.0
    stokes = StokesState.make(ni, dtype=dtype, device=device)
    f = dict(dtype=stokes.P.dtype, device=device)

    def layer(rho, A, n, E, V):
        return Material(
            rho0=rho, alpha=3.0e-5, T0=T_top, Cp=1000.0, k=3.0,
            G=25.0e9, Kb=math.inf, gravity=9.81,
            disl_A=A, disl_n=n, disl_E=E, disl_V=V,
        )

    material = MaterialStack.make([
        layer(2700.0, 1.0e-28, 4.0, 223.0e3, 0.0),      # upper crust
        layer(2900.0, 2.0e-23, 3.2, 238.0e3, 0.0),      # lower crust
        layer(3300.0, 1.1e5 * 1.0e-6**3.5, 3.5, 530.0e3, 14.0e-6),  # mantle
    ], **f)

    # particles carry the layer phase
    particles = init_particles_3d(geometry, nxcell, max_xcell, min_xcell, **f)
    depth_p = -particles.pz
    phase = torch.where(
        depth_p < 0.5 * z_moho, 0.0, torch.where(depth_p < z_moho, 1.0, 2.0)
    ).to(f["dtype"])
    pr_center, _ = phase_ratios_from_particles_3d(particles, phase, NPHASE, geometry)
    pr = phase_ratios_from_field(pr_center)

    # geotherm + hot spherical anomaly at 0.7·lz depth, on the ghosted lattice
    Xg, Yg, Zg = np.meshgrid(
        *[(np.arange(n + 2) - 0.5) * (L / n) + o
          for n, L, o in zip(ni, (lx, ly, lz), (0.0, 0.0, -lz))],
        indexing="ij",
    )
    depth = -Zg
    geo_c = T_top + (T_moho - T_top) * depth / z_moho
    geo_m = T_moho + (T_bot - T_moho) * (depth - z_moho) / (lz - z_moho)
    T0 = np.where(depth < z_moho, geo_c, geo_m)
    anom = ((Xg - 0.5 * lx) ** 2 + (Yg - 0.5 * ly) ** 2
            + (Zg + 0.7 * lz) ** 2) < (0.12 * lz) ** 2
    T0 = torch.as_tensor(T0 + np.where(anom, 250.0, 0.0), **f)
    thermal = ThermalState.make(ni, dtype=dtype, device=device)
    thermal_bc = TemperatureBoundaryConditions(
        no_flux=Faces(left=True, right=True, front=True, back=True),
        constant_value=Faces(top=T_top, bot=T_bot),
    )
    thermal = thermal.replace(T=thermal_bcs(T0, thermal_bc), Told=T0)

    stokes = stokes.replace(viscosity=stokes.viscosity.replace(eta=torch.full(ni, 1.0e21, **f)))
    depth_c = torch.as_tensor(-xci[2], **f).expand(ni)
    stokes = stokes.replace(P=3100.0 * 9.81 * depth_c)

    pt = PTStokesCoeffs.make(
        geometry.li, geometry.di, CFL=0.9 / math.sqrt(3.1), eps_abs=1.0e-5, eps_rel=1.0e-5)
    flow_bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, front=True, back=True, top=True, bot=True))
    cutoff = (1.0e17, 1.0e24)

    info = None
    dt = 1.0e10  # ~300 yr initial elastic step; replaced by CFL after
    vmax_hist = []
    for _ in range(nt):
        T_cells = thermal.T[1:-1, 1:-1, 1:-1]
        # plain by contract: mixed creep exponents (module doc)
        stokes, info = solve_vep_3d(
            stokes, pt, geometry, flow_bc, material, pr.center,
            (pr.edge_yz, pr.edge_xz, pr.edge_xy), dt,
            T=T_cells, iter_max=20_000, iter_min=200, nout=500,
            viscosity_relaxation=1.0e-2, viscosity_cutoff=cutoff, use_kernel=False,
        )
        dt = float(compute_dt(stokes.V.components, geometry.di)) * 0.5
        K = compute_conductivity(material, T=T_cells, phase_ratios=pr.center)
        rhoCp = compute_rhoCp(material, T=T_cells, phase_ratios=pr.center)
        pt_th = PTThermalCoeffs.make(K, rhoCp, dt, geometry.di, geometry.li)
        # plain by contract: 3D
        thermal, _ = heatdiffusion_PT(
            thermal, pt_th, thermal_bc, dt, geometry, K=K, rho_Cp=rhoCp,
            iter_max=10_000, nout=200, use_kernel=False,
        )
        particles = advect_rk2_3d(particles, stokes.V.components, geometry, dt)
        particles, fields = move_particles_3d(particles, geometry, {"phase": phase})
        particles, fields = inject_particles_3d(
            particles, geometry, {}, phases=NPHASE, fields=fields, phase_field="phase")
        phase = fields["phase"]
        pr_center, _ = phase_ratios_from_particles_3d(particles, phase, NPHASE, geometry)
        pr = phase_ratios_from_field(pr_center)
        vmax_hist.append(float(torch.abs(stokes.V.Vz).max()))

    return stokes, thermal, particles, phase, info, vmax_hist
