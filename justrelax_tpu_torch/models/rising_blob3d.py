"""Rising blob 3D: a particle-tracked buoyant sphere in a viscous mantle.

Counterpart of ``justrelax_tpu/models/rising_blob3d.py`` (reference
miniapps/convection/RisingBlob3D, the 3D PIC transport coupled to the 3D
Stokes solver). A light sphere (Δρ < 0) in a 1000 km box is carried by
particles (8 per cell, 20 slots, at least 4); each step: phase ratios from
the particles → buoyancy → viscous 3D Stokes solve → RK2 particle advection
→ re-slotting → injection. The blob rises at the Stokes-sphere velocity
scale (2/9)·|Δρ|·g·R²/η and stays coherent.

Oracle at 16³, 3 steps (tests/test_rising_blob3d.py): Stokes residual
< 1e-6, the blob's centroid rising every step, peak Vz within 40 % of the
Stokes-sphere speed, the blob particles' spread under 1.5 R.

On the card the Stokes solve runs through the 3D VE chunk kernel (B7: free
slip on all six faces, the viscous limit); the particle operations are
plain PyTorch.
"""

from __future__ import annotations

import math

import torch

from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs
from justrelax_tpu_torch.core.device import resolve_device
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.core.state import StokesState
from justrelax_tpu_torch.ops.bc import Faces, VelocityBoundaryConditions
from justrelax_tpu_torch.particles.particles3d import (
    advect_rk2_3d,
    init_particles_3d,
    inject_particles_3d,
    move_particles_3d,
    phase_ratios_from_particles_3d,
)
from justrelax_tpu_torch.solvers.stokes3d import solve_ve_3d
from justrelax_tpu_torch.utils.timestep import compute_dt

__all__ = ["MANTLE", "BLOB", "run"]

MANTLE, BLOB = 0, 1


def run(n=16, nt=4, d_rho=-100.0, eta0=1.0e21, R=0.12, dtype=None, seed=0,
        use_kernel=None, device=None):
    """``nt`` steps on an n³ grid; returns (stokes, particles, the particle
    phase, the last Stokes solve's info, the blob centroid's height after
    each step). ``device`` defaults to the card; ``use_kernel`` reaches the
    Stokes solve (B7 on the card by default, the plain path on the CPU)."""
    device = resolve_device(device)
    L = 1.0e6  # 1000 km box
    ni = (n, n, n)
    geometry = Geometry(ni, (L, L, L))
    stokes = StokesState.make(ni, dtype=dtype, device=device)
    f = dict(dtype=stokes.P.dtype, device=device)

    particles = init_particles_3d(geometry, nxcell=8, max_xcell=20, min_xcell=4, seed=seed,
                                  **f)
    blob0 = (
        (particles.px - 0.5 * L) ** 2
        + (particles.py - 0.5 * L) ** 2
        + (particles.pz - 0.3 * L) ** 2
    ) < (R * L) ** 2
    p_phase = blob0.to(f["dtype"])

    stokes = stokes.replace(
        viscosity=stokes.viscosity.replace(eta=torch.full(ni, eta0, **f))
    )
    pt = PTStokesCoeffs.make(
        geometry.li, geometry.di, eps_rel=1.0e-6, CFL=0.9 / math.sqrt(3.1)
    )
    bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True, front=True, back=True)
    )
    zeros = torch.zeros(ni, **f)
    G = torch.full(ni, math.inf, **f)
    K = torch.tensor(math.inf, **f)
    g = 9.81
    rho_m = 3.3e3

    info = None
    zc_hist = []
    for _ in range(nt):
        center, _ = phase_ratios_from_particles_3d(particles, p_phase, 2, geometry)
        rho = rho_m + d_rho * center[..., BLOB]
        # positive ρg ⇒ gravity along −z
        stokes, info = solve_ve_3d(
            stokes, pt, geometry, bc, (zeros, zeros, rho * g), G, K, math.inf,
            iter_max=20_000, nout=500, use_kernel=use_kernel,
        )
        dt = float(compute_dt(stokes.V.components, geometry.di))

        particles = advect_rk2_3d(
            particles, (stokes.V.Vx, stokes.V.Vy, stokes.V.Vz), geometry, dt
        )
        particles, fields = move_particles_3d(particles, geometry, {"phase": p_phase})
        particles, fields = inject_particles_3d(particles, geometry, {}, phases=2,
                                                fields=fields)
        p_phase = fields["phase"]

        a = particles.active & (p_phase > 0.5)
        zc_hist.append(float(particles.pz[a].mean()))
    return stokes, particles, p_phase, info, zc_hist
