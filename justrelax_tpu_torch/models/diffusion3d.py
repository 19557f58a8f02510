"""3D thermal diffusion benchmark.

Counterpart of ``justrelax_tpu/models/diffusion3d.py::run``: a 100 km cube
with a linear geotherm (1600→1900 K down the cell-center column), Dirichlet
top/bottom (300 K / 3500 K), insulating sides, constant radiogenic heating
1e-6 W/m³ and a +100 K spherical perturbation of radius 10 km at the
center; 10 implicit steps of 50 kyr of the PT solver with a T-dependent
density (ρ0 = 3.1e3, α = 1.5e-5), Cp = 1.2e3, k = 3.

Golden values at 32³ (tests/test_diffusion3d.py; ghosted 34³ T, 0-based):
T[15, 15, 15] ≈ 1813.2470160788096 and T[16, 16, 16] ≈ 1831.2568044653274
(rtol 1e-3), final residual < 1e-5. The multi-phase variant
(``run_multiphase``: a second phase, ρ0 = 3.0e3 / 3.3e3 and radiogenic
heating 1e-6 / 1e-7 W/m³, inside the sphere, its ratios from 3D particles):
T[15, 15, 15] ≈ 1816.8262937737384, T[16, 16, 16] ≈ 1834.4197141500213.

The solves run on the plain path by contract: the thermal chunk kernel is
2D (as the JAX package's is), and the material path re-evaluates ρ(T)·Cp
every iteration.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from justrelax_tpu_torch.core.coeffs import PTThermalCoeffs
from justrelax_tpu_torch.core.device import resolve_device
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.core.state import ThermalState
from justrelax_tpu_torch.ops.bc import Faces, TemperatureBoundaryConditions, thermal_bcs
from justrelax_tpu_torch.rheology.materials import Material, MaterialStack
from justrelax_tpu_torch.solvers.thermal import heatdiffusion_PT

__all__ = ["KYR", "MYR", "run", "run_multiphase"]

KYR = 1.0e3 * 3600 * 24 * 365.25
MYR = 1.0e3 * KYR


def _setup_thermal(ni, li, dtype, device):
    """Grid, initial thermal state, BCs and the perturbation's (center,
    radius), on ``device``."""
    nx, ny, nz = ni
    geometry = Geometry(ni, li, origin=(0.0, 0.0, -li[2]))
    xci = geometry.xci

    thermal = ThermalState.make(ni, dtype=dtype, device=device)
    f = dict(dtype=thermal.T.dtype, device=device)
    thermal = thermal.replace(H=torch.full(ni, 1.0e-6, **f))

    # linear geotherm on all x/y columns (incl. ghosts), interior z rows
    z = xci[2]
    profile = z * (1900.0 - 1600.0) / z.min() + 1600.0
    T = np.zeros((nx + 2, ny + 2, nz + 2))
    T[:, :, 1:-1] = profile[None, None, :]

    thermal_bc = TemperatureBoundaryConditions(
        no_flux=Faces(left=True, right=True, front=True, back=True),
        constant_value=Faces(top=300.0, bot=3500.0),
    )

    # spherical +100 K perturbation at the domain center
    xc, yc, zc = li[0] / 2, li[1] / 2, -li[2] / 2
    r = 10.0e3
    X, Y, Z = np.meshgrid(xci[0], xci[1], xci[2], indexing="ij")
    mask = (X - xc) ** 2 + (Y - yc) ** 2 + (Z - zc) ** 2 <= r**2
    T[1:-1, 1:-1, 1:-1] += 100.0 * mask
    Tt = thermal_bcs(torch.as_tensor(T, **f), thermal_bc)
    thermal = thermal.replace(T=Tt, Told=Tt)
    return geometry, thermal, thermal_bc, (xc, yc, zc, r)


def run(n=32, l=100.0e3, ttot=0.5 * MYR, dt=50 * KYR, dtype=None, device=None):
    """``ceil(ttot/dt)`` implicit steps; returns (thermal, info of the last
    solve). ``device`` defaults to the card."""
    device = resolve_device(device)
    ni = (n, n, n)
    geometry, thermal, thermal_bc, _ = _setup_thermal(ni, (l, l, l), dtype, device)
    f = dict(dtype=thermal.T.dtype, device=device)
    material = MaterialStack.make(
        [Material(rho0=3.1e3, alpha=1.5e-5, beta=0.0, T0=0.0, Cp=1.2e3, k=3.0)],
        dtype=f["dtype"], device=device)

    # PT coefficients from constant K and ρCp (the reference uses ρ0 = 3.3e3 here)
    K = torch.full(ni, 3.0, **f)
    rho_Cp = torch.full(ni, 3.3e3 * 1.2e3, **f)
    pt_thermal = PTThermalCoeffs.make(
        K, rho_Cp, dt, geometry.di, geometry.li, CFL=0.95 / math.sqrt(3.1))
    P = torch.zeros(ni, **f)
    info = None
    for _ in range(int(math.ceil(ttot / dt))):
        # plain path by contract: a 3D grid and the material path
        thermal, info = heatdiffusion_PT(
            thermal, pt_thermal, thermal_bc, dt, geometry,
            material=material, P=P, use_kernel=False,
        )
    return thermal, info


def run_multiphase(n=32, l=100.0e3, ttot=0.5 * MYR, dt=50 * KYR, dtype=None, device=None):
    """Particle-carried second phase inside the perturbation sphere; returns
    (thermal, info of the last solve). ``device`` defaults to the card."""
    from justrelax_tpu_torch.models.diffusion2d_multiphase import face_ratios
    from justrelax_tpu_torch.particles.particles3d import (
        init_particles_3d,
        phase_ratios_from_particles_3d,
    )

    device = resolve_device(device)
    ni = (n, n, n)
    geometry, thermal, thermal_bc, (xc, yc, zc, r) = _setup_thermal(
        ni, (l, l, l), dtype, device)
    f = dict(dtype=thermal.T.dtype, device=device)
    material = MaterialStack.make([
        Material(rho0=3.0e3, alpha=1.5e-5, Cp=1.2e3, k=3.0, H_r=1.0e-6),
        Material(rho0=3.3e3, alpha=1.5e-5, Cp=1.2e3, k=3.0, H_r=1.0e-7),
    ], **f)
    # the reference's 3D multiphase test keeps thermal.H = 1e-6 AND the
    # per-phase radioactive heat: both enter the source

    particles = init_particles_3d(geometry, nxcell=12, max_xcell=12, min_xcell=1, **f)
    phase = torch.where(
        (particles.px - xc) ** 2 + (particles.py - yc) ** 2 + (particles.pz - zc) ** 2
        <= r**2, 1.0, 0.0).to(f["dtype"])
    pr_c, _ = phase_ratios_from_particles_3d(particles, phase, 2, geometry)
    pr_faces = tuple(face_ratios(pr_c, a) for a in range(3))

    P = torch.zeros(ni, **f)
    info = None
    for _ in range(int(math.ceil(ttot / dt))):
        pt_thermal = PTThermalCoeffs.from_material(
            material, thermal.T[1:-1, 1:-1, 1:-1], P, dt, geometry.di, geometry.li,
            phase_ratios=pr_c, eps=1.0e-5, CFL=0.95 / math.sqrt(3.0),
        )
        # plain path by contract: 3D, and the material path
        thermal, info = heatdiffusion_PT(
            thermal, pt_thermal, thermal_bc, dt, geometry,
            material=material, P=P, phase_ratios=pr_c, phase_ratios_faces=pr_faces,
            iter_max=10_000, nout=100, use_kernel=False,
        )
    return thermal, info
