"""2D multi-phase thermal diffusion benchmark
(reference test_diffusion2D_multiphase.jl).

Counterpart of ``justrelax_tpu/models/diffusion2d_multiphase.py``: the
set-up of ``models/diffusion2d.py`` with a second phase inside the 10 km
perturbation circle (PT_Density ρ0 = 3.0e3 / 3.3e3, radiogenic heating
1e-6 / 1e-7 W/m³), the phase ratios taken from particles (24 per cell).
Golden values at 32² (tests/test_diffusion2d_multiphase.py): T[17, 17] ≈
1814.029, T[16, 16] ≈ 1823.548 (atol 0.1), final residual < 1e-5.

The thermal solve runs on the plain path by contract: the material path
re-evaluates ρ(T)·Cp and k every iteration, which the thermal chunk kernel
(the K/ρCp path) does not cover.
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
from justrelax_tpu_torch.particles.particles import init_particles, phase_ratios_from_particles
from justrelax_tpu_torch.rheology.materials import Material, MaterialStack
from justrelax_tpu_torch.solvers.thermal import heatdiffusion_PT

__all__ = ["KYR", "MYR", "face_ratios", "run"]

KYR = 1.0e3 * 3600 * 24 * 365.25
MYR = 1.0e3 * KYR


def face_ratios(pr_c, axis):
    """Face ratios along ``axis`` as the mean of the two adjacent centers,
    the outermost centers repeated past the walls."""
    n = pr_c.shape[axis]
    E = torch.cat([pr_c.narrow(axis, 0, 1), pr_c, pr_c.narrow(axis, n - 1, 1)], dim=axis)
    return 0.5 * (E.narrow(axis, 0, n + 1) + E.narrow(axis, 1, n + 1))


def run(nx=32, ny=32, lx=100.0e3, ly=100.0e3, ttot=1 * MYR, dt=50 * KYR, dtype=None,
        device=None):
    """``ceil(ttot/dt)`` implicit steps; returns (thermal, info of the last
    solve). ``device`` defaults to the card."""
    device = resolve_device(device)
    ni = (nx, ny)
    geometry = Geometry(ni, (lx, ly), origin=(0.0, -ly))
    xci = geometry.xci

    thermal = ThermalState.make(ni, dtype=dtype, device=device)
    f = dict(dtype=thermal.T.dtype, device=device)
    material = MaterialStack.make(
        [
            Material(rho0=3.0e3, alpha=1.5e-5, Cp=1.2e3, k=3.0, H_r=1.0e-6),
            Material(rho0=3.3e3, alpha=1.5e-5, Cp=1.2e3, k=3.0, H_r=1.0e-7),
        ],
        **f,
    )

    z = xci[1]
    profile = z * (1900.0 - 1600.0) / z.min() + 1600.0
    T = np.zeros((nx + 2, ny + 2))
    T[:, 1:-1] = profile[None, :]
    thermal_bc = TemperatureBoundaryConditions(
        no_flux=Faces(left=True, right=True),
        constant_value=Faces(top=300.0, bot=3500.0),
    )
    xc, yc = lx / 2, -ly / 2
    r = 10.0e3
    X, Y = np.meshgrid(xci[0], xci[1], indexing="ij")
    mask = (X - xc) ** 2 + (Y - yc) ** 2 <= r**2
    T[1:-1, 1:-1] += 100.0 * mask
    Tt = thermal_bcs(torch.as_tensor(T, **f), thermal_bc)
    thermal = thermal.replace(T=Tt, Told=Tt)

    # particle-carried phases: phase 1 inside the circle
    particles = init_particles(geometry, nxcell=24, max_xcell=36, min_xcell=12, **f)
    phase = torch.where(
        (particles.px - xc) ** 2 + (particles.py - yc) ** 2 <= r**2, 1.0, 0.0
    ).to(f["dtype"])
    pr_c, _ = phase_ratios_from_particles(particles, phase, 2, geometry)
    # face ratios from center averages (constant conductivity: unused weight)
    pr_faces = (face_ratios(pr_c, 0), face_ratios(pr_c, 1))

    P = torch.zeros(ni, **f)
    info = None
    for _ in range(int(math.ceil(ttot / dt))):
        pt_thermal = PTThermalCoeffs.from_material(
            material, thermal.T[1:-1, 1:-1], P, dt, geometry.di, geometry.li,
            phase_ratios=pr_c, eps=1.0e-5, CFL=0.95 / math.sqrt(2.0),
        )
        # plain path by contract: the material path
        thermal, info = heatdiffusion_PT(
            thermal, pt_thermal, thermal_bc, dt, geometry,
            material=material, P=P, phase_ratios=pr_c, phase_ratios_faces=pr_faces,
            iter_max=10_000, nout=100, use_kernel=False,
        )
    return thermal, info
