"""Van Keken Rayleigh-Taylor benchmark (reference test_VanKeken.jl).

Counterpart of ``justrelax_tpu/models/vankeken.py``: a unit box, a dense
layer (ρ = 2) above a buoyant one (ρ = 1) separated by the cosine interface
y = 0.2 + 0.02·cos(πx/0.9142); η = 1, g = 1; free slip on the sides, no
slip at top and bottom. The composition rides particles (40 per cell, 80
slots, at least 20), advected with RK2 and re-slotted each step, the phase
ratios refreshed from them.

Oracle at 32², 100 steps (tests/test_vankeken.py): the last Stokes residual
< 1e-4, Urms = √(Σ|V|²·dx·dy) < 1e-2 at every step and growing, and at
least ``min_xcell`` particles in every cell.

On the card the Stokes solve runs through the VEP chunk kernel (B2/B3: a
linear two-phase table, free-slip/no-slip faces); the particle operations
are plain PyTorch.
"""

from __future__ import annotations

import math

import torch

from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs
from justrelax_tpu_torch.core.device import resolve_device
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.core.state import StokesState
from justrelax_tpu_torch.ops.bc import Faces, VelocityBoundaryConditions
from justrelax_tpu_torch.ops.interpolation import velocity2vertex
from justrelax_tpu_torch.particles.particles import (
    advect_rk2,
    init_particles,
    inject_particles,
    move_particles,
    phase_ratios_from_particles,
)
from justrelax_tpu_torch.rheology.materials import Material, MaterialStack
from justrelax_tpu_torch.solvers.stokes2d_vep import solve_vep
from justrelax_tpu_torch.utils.timestep import compute_dt

__all__ = ["LAMBDA", "run"]

LAMBDA = 0.9142


def run(nx=32, ny=32, nt=500, nxcell=40, max_xcell=80, min_xcell=20, dtype=None,
        device=None, use_kernel=None):
    """``nt`` coupled steps; returns (Urms per step, the last Stokes solve's
    info, stokes, particles, the particle phase). ``device`` defaults to the
    card; ``use_kernel`` reaches the Stokes solve (the VEP chunk kernel on
    the card by default, the plain path on the CPU)."""
    device = resolve_device(device)
    ni = (nx, ny)
    geometry = Geometry(ni, (1.0, 1.0))
    stokes = StokesState.make(ni, dtype=dtype, device=device)
    f = stokes.P.dtype
    material = MaterialStack.make(
        [
            Material(rho0=1.0, eta0=1.0, gravity=1.0),
            Material(rho0=2.0, eta0=1.0, gravity=1.0),
        ],
        dtype=f, device=device,
    )
    pt_stokes = PTStokesCoeffs.make(
        geometry.li, geometry.di, r=1.0, eps_abs=1.0e-8, CFL=1.0 / math.sqrt(2.1)
    )
    flow_bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True),
        no_slip=Faces(top=True, bot=True),
    )

    particles = init_particles(geometry, nxcell, max_xcell, min_xcell, dtype=f, device=device)
    phase = torch.where(
        particles.py > 0.2 + 0.02 * torch.cos(math.pi * particles.px / LAMBDA), 1.0, 0.0
    ).to(f)
    pr_c, pr_v = phase_ratios_from_particles(particles, phase, 2, geometry)

    dt = 1.0
    Urms = []
    info = None
    di = geometry.di
    for _ in range(nt):
        stokes, info = solve_vep(
            stokes, pt_stokes, geometry, flow_bc, material, pr_c, pr_v, dt,
            iter_max=10_000, nout=50, use_kernel=use_kernel,
        )
        dt = float(compute_dt(stokes.V.components, di)) / 10.0

        Vx_v, Vy_v = velocity2vertex(stokes.V.Vx, stokes.V.Vy)
        Urms.append(float(torch.sqrt(torch.sum(Vx_v**2 + Vy_v**2) * di[0] * di[1])))

        particles = advect_rk2(particles, stokes.V.components, geometry, dt)
        particles, fields = move_particles(particles, geometry, {"phase": phase})
        phase = fields["phase"]
        particles, fields = inject_particles(
            particles, geometry, {}, phases=2, fields={"phase": phase}, phase_field="phase",
        )
        phase = fields["phase"]
        pr_c, pr_v = phase_ratios_from_particles(particles, phase, 2, geometry)

    return Urms, info, stokes, particles, phase
