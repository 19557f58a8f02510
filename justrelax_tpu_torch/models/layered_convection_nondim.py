"""Nondimensionalized layered-lithosphere convection with particles
(reference miniapps/convection/Particles2D_nonDim/Layered_convection2D.jl).

Counterpart of ``justrelax_tpu/models/layered_convection_nondim.py``: the
GeoParams ``GEO_units`` workflow (utils/units.py; length 40 km, viscosity
1e20 Pa·s, temperature 1000 K), three layers (upper crust, lower crust,
lithospheric mantle) carried on particles with a dislocation-creep law
each, a piecewise-linear geotherm with a hot circular anomaly that seeds a
plume, lithostatic pressure at the start. Each step: VEP Stokes → CFL dt →
PT thermal diffusion (K/ρCp) → particle advection, re-slotting, injection
→ phase ratios. The creep parameters transform as A' = A·σc^n·tc,
E' = E/Θc, V' = V·σc/Θc, so the unchanged viscosity code evaluates the
dimensional law on nondimensional fields.

Oracle at 16², 2 steps, 12/24/6 particles (tests/
test_layered_convection_nondim.py): residual < 1e-5, T inside the geotherm
window, upward flow, all three phases on active particles, an ascent of
1e-6 to 10 cm/yr, and the frozen goldens max Vy 4.160546429279427e-06
(rtol 1e-5) and max T 1.5278565116446254 (rtol 1e-6).

Routes on the card: the thermal solve through the thermal chunk kernel
(B5: K/ρCp tensors, constant values and no flux). The Stokes solve is
plain by contract: the creep table mixes stress exponents (4, 3.2, 3.5),
which the VEP chunk kernel does not take (``vep_chunk_supported`` needs a
linear or shared-exponent table).
"""

from __future__ import annotations

import math
from types import SimpleNamespace

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
from justrelax_tpu_torch.particles.particles import (
    advect_rk2,
    init_particles,
    inject_particles,
    move_particles,
    phase_ratios_from_particles,
)
from justrelax_tpu_torch.rheology.materials import (
    Material,
    MaterialStack,
    compute_conductivity,
    compute_rhoCp,
)
from justrelax_tpu_torch.solvers.stokes2d_vep import solve_vep
from justrelax_tpu_torch.solvers.thermal import heatdiffusion_PT
from justrelax_tpu_torch.utils.timestep import compute_dt
from justrelax_tpu_torch.utils.units import geo_units, nondimensionalize

__all__ = ["NPHASE", "run", "particle_step"]

NPHASE = 3  # upper crust / lower crust / mantle


def _nd_creep(u, A, n, E, V):
    """Nondimensionalize a power-law creep parameter set (see module doc)."""
    sigma_c = u.scale("stress")
    t_c = u.scale("time")
    theta_c = u.scale("temperature")
    return dict(
        disl_A=A * sigma_c**n * t_c,
        disl_n=n,
        disl_E=E / theta_c,
        disl_V=V * sigma_c / theta_c,
    )


def _setup(nx, ny, nxcell, max_xcell, min_xcell, dtype, device):
    """What the APT and the DYREL variants share: units, the three layers'
    materials, the grid, the particles with their layer phase and ratios,
    the thermal state (geotherm with the anomaly) with its BCs, the flow
    BCs, the viscosity cutoff and the gravity, in a namespace."""
    u = geo_units(length=40.0e3, viscosity=1.0e20, temperature=1000.0)
    lx = nondimensionalize(100.0e3, "length", u)
    ly = nondimensionalize(110.0e3, "length", u)
    g = nondimensionalize(9.81, "gravity", u)
    T_top = nondimensionalize(273.0, "temperature", u)
    T_bot = nondimensionalize(1492.0, "temperature", u)
    T_moho = nondimensionalize(923.0, "temperature", u)
    z_moho = nondimensionalize(35.0e3, "length", u)

    def phase_mat(rho, k, Cp, A, n, E, V):
        return Material(
            rho0=nondimensionalize(rho, "density", u),
            alpha=nondimensionalize(3.0e-5, "expansivity", u),
            T0=T_top,
            k=nondimensionalize(k, "conductivity", u),
            Cp=nondimensionalize(Cp, "heat_capacity", u),
            G=nondimensionalize(25.0e9, "stress", u),
            Kb=math.inf,
            gravity=g,
            **_nd_creep(u, A, n, E, V),
        )

    thermal = ThermalState.make((nx, ny), dtype=dtype, device=device)
    f = dict(dtype=thermal.T.dtype, device=device)
    material = MaterialStack.make([
        # upper crust: wet-quartzite-like dislocation creep
        phase_mat(2700.0, 2.5, 1000.0, A=1.0e-28, n=4.0, E=223.0e3, V=0.0),
        # lower crust: intermediate
        phase_mat(2900.0, 2.5, 1000.0, A=2.0e-23, n=3.2, E=238.0e3, V=0.0),
        # lithospheric mantle: dry olivine (Hirth & Kohlstedt 2003, SI)
        phase_mat(3300.0, 3.0, 1000.0, A=1.1e5 * 1.0e-6**3.5, n=3.5, E=530.0e3, V=14.0e-6),
    ], **f)

    geometry = Geometry((nx, ny), (lx, ly), origin=(0.0, -ly))
    xci = geometry.xci

    # particles carry the layer phase
    particles = init_particles(geometry, nxcell, max_xcell, min_xcell, **f)
    depth_p = -particles.py
    phase = torch.where(
        depth_p < 0.5 * z_moho, 0.0, torch.where(depth_p < z_moho, 1.0, 2.0)
    ).to(f["dtype"])
    pr_c, pr_v = phase_ratios_from_particles(particles, phase, NPHASE, geometry)

    # initial temperature: piecewise-linear geotherm + hot circle (the plume
    # seed), on the ghosted center lattice
    dx, dy = geometry.di
    Xc, Yc = np.meshgrid(np.r_[xci[0][0] - dx, xci[0], xci[0][-1] + dx],
                         np.r_[xci[1][0] - dy, xci[1], xci[1][-1] + dy], indexing="ij")
    depth = -Yc
    geo_crust = T_top + (T_moho - T_top) * depth / z_moho
    geo_mantle = T_moho + (T_bot - T_moho) * (depth - z_moho) / (ly - z_moho)
    T0 = np.where(depth < z_moho, geo_crust, geo_mantle)
    xc_a, yc_a, r_a = 0.5 * lx, -ly + 0.3 * ly, 0.1 * ly
    dT = nondimensionalize(200.0, "temperature", u)
    anom = ((Xc - xc_a) ** 2 + (Yc - yc_a) ** 2) < r_a**2
    T0 = torch.as_tensor(np.where(anom, T0 + dT, T0), **f)
    thermal_bc = TemperatureBoundaryConditions(
        no_flux=Faces(left=True, right=True),
        constant_value=Faces(top=float(T_top), bot=float(T_bot)),
    )
    thermal = thermal.replace(T=thermal_bcs(T0, thermal_bc), Told=T0)
    flow_bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True))
    cutoff = (nondimensionalize(1.0e17, "viscosity", u),
              nondimensionalize(1.0e24, "viscosity", u))
    return SimpleNamespace(
        u=u, g=g, material=material, geometry=geometry, particles=particles, phase=phase,
        pr_c=pr_c, pr_v=pr_v, thermal=thermal, thermal_bc=thermal_bc, flow_bc=flow_bc,
        cutoff=cutoff, f=f)


def thermal_step(thermal, thermal_bc, material, pr_c, dt, geometry, use_kernel):
    """The PT thermal step on the K/ρCp path (B5 on the card by default)."""
    T_cells = thermal.T[1:-1, 1:-1]
    K = compute_conductivity(material, T=T_cells, phase_ratios=pr_c)
    rhoCp = compute_rhoCp(material, T=T_cells, phase_ratios=pr_c)
    pt_thermal = PTThermalCoeffs.make(K, rhoCp, dt, geometry.di, geometry.li)
    thermal, _ = heatdiffusion_PT(
        thermal, pt_thermal, thermal_bc, dt, geometry, K=K, rho_Cp=rhoCp,
        iter_max=20_000, nout=200, use_kernel=use_kernel)
    return thermal


def particle_step(particles, phase, V, geometry, dt, nphase, phases=None):
    """Advect, re-slot and refill the particles, the dominant phase of a
    cell's survivors going to its new particles (``phases`` as
    ``inject_particles`` takes it, ``nphase`` if not given); returns
    (particles, phase, center ratios, vertex ratios)."""
    particles = advect_rk2(particles, V, geometry, dt)
    particles, fields = move_particles(particles, geometry, {"phase": phase})
    particles, fields = inject_particles(
        particles, geometry, {}, phases=nphase if phases is None else phases,
        fields=fields, phase_field="phase")
    phase = fields["phase"]
    pr_c, pr_v = phase_ratios_from_particles(particles, phase, nphase, geometry)
    return particles, phase, pr_c, pr_v


def run(nx=32, ny=32, nt=3, nxcell=24, max_xcell=48, min_xcell=12, dtype=None,
        device=None, use_kernel=None):
    """``nt`` coupled steps; returns (stokes, thermal, particles, phase,
    the last Stokes solve's info, the CharacteristicUnits, max |Vy| per
    step), nondimensional. ``device`` defaults to the card; ``use_kernel``
    applies to the thermal solve (B5 on the card by default)."""
    device = resolve_device(device)
    s = _setup(nx, ny, nxcell, max_xcell, min_xcell, dtype, device)
    u, geometry, material, f = s.u, s.geometry, s.material, s.f
    particles, phase, pr_c, pr_v, thermal = s.particles, s.phase, s.pr_c, s.pr_v, s.thermal

    stokes = StokesState.make((nx, ny), dtype=dtype, device=device)
    eta_i = nondimensionalize(1.0e21, "viscosity", u)
    stokes = stokes.replace(viscosity=stokes.viscosity.replace(
        eta=torch.full((nx, ny), eta_i, **f), eta_v=torch.full((nx + 1, ny + 1), eta_i, **f)))
    # lithostatic pressure (reference init_P!, Layered_convection2D.jl:38-42)
    rho_mean = nondimensionalize(3100.0, "density", u)
    depth_c = np.broadcast_to(-np.asarray(geometry.xci[1])[None, :], (nx, ny))
    stokes = stokes.replace(P=torch.as_tensor(rho_mean * s.g * depth_c, **f))
    pt_stokes = PTStokesCoeffs.make(
        geometry.li, geometry.di, CFL=0.9 / math.sqrt(2.1), eps_abs=1.0e-5, eps_rel=1.0e-5)

    info = None
    dt = 1.0  # nondim; replaced by the CFL value after the first solve
    vmax_hist = []
    for _ in range(nt):
        T_cells = thermal.T[1:-1, 1:-1]
        # plain by contract: mixed creep exponents (module doc)
        stokes, info = solve_vep(
            stokes, pt_stokes, geometry, s.flow_bc, material, pr_c, pr_v,
            dt=dt, T=T_cells, iter_max=30_000, nout=500,
            viscosity_relaxation=1.0e-2, viscosity_cutoff=s.cutoff, use_kernel=False)
        dt = float(compute_dt(stokes.V.components, geometry.di)) * 0.5
        thermal = thermal_step(thermal, s.thermal_bc, material, pr_c, dt, geometry,
                               use_kernel)
        particles, phase, pr_c, pr_v = particle_step(
            particles, phase, stokes.V.components, geometry, dt, NPHASE)
        vmax_hist.append(float(torch.abs(stokes.V.Vy).max()))

    return stokes, thermal, particles, phase, info, u, vmax_hist
