"""The free-surface-stabilization models (reference
miniapps/benchmarks/stokes2D/free_surface_stabilization/).

Counterpart of ``justrelax_tpu/models/rayleigh_taylor.py``:

``run``: the Rayleigh-Taylor overturn with sticky air
(RayleighTaylor2D.jl:77-250). A 500 km box plus 100 km of sticky air: air
(ρ=1, η=1e16) over dense crust (ρ=3300, η=1e21) over a lighter mantle
(ρ=3200, η=1e20) whose interface at 200 km depth carries a 5 km sinusoid.
The air is excised by the variational (rock-ratio masked) solve, with the
stabilization term off, as in the reference.

``run_plume_variational``: the rising plume on the variational path with
the masked stabilization term on (PlumeFreeSurface_VariationalStokes.jl).

``run_plume``: the rising plume (PlumeFreeSurface_2D.jl:106-205), air
(ρ=10, η=1e17) over a mantle (ρ=3300, η=1e21) with a buoyant plume
(ρ=3200, η=1e20), through the plain multi-phase solve with the
free-surface term Vy·∂(ρg)/∂y·θ·dt.

The phases ride particles, advected with RK2, re-slotted and injected each
step. On the card the variational solves' chunks are CUDA graph replays;
``run_plume``'s ``solve_vep(free_surface=True)`` is plain by contract (the
VEP chunk kernel, B2/B3, refuses a free-surface term), so the model passes
``use_kernel=False``. The models run no kernel of the port.
"""

from __future__ import annotations

import math

import torch

from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs
from justrelax_tpu_torch.core.device import resolve_device
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.core.state import StokesState
from justrelax_tpu_torch.ops.bc import Faces, VelocityBoundaryConditions
from justrelax_tpu_torch.ops.rock_ratio import update_rock_ratio
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
    compute_density,
    phase_average,
)
from justrelax_tpu_torch.rheology.phases import PhaseRatios, phase_ratios_from_field
from justrelax_tpu_torch.solvers.stokes2d_variational import solve_variational
from justrelax_tpu_torch.solvers.stokes2d_vep import solve_vep
from justrelax_tpu_torch.utils.timestep import compute_dt

__all__ = ["YR", "AIR", "CRUST", "MANTLE", "run", "run_plume", "run_plume_variational"]

YR = 365.25 * 24 * 3600
AIR, CRUST, MANTLE = 0, 1, 2


def _phase_of_rt(px, py, A=5.0e3, lam=500.0e3):
    """RayleighTaylor2D.jl:40-64 init_phases! (0-based phase ids)."""
    depth = -py
    interface = -(A * torch.sin(math.pi * px / lam)) + (200.0e3 - A)
    ph = torch.full_like(px, float(CRUST))
    ph = torch.where(depth <= 100.0e3, float(AIR), ph)
    return torch.where(depth > interface, float(MANTLE), ph)


def _phase_of_plume(px, py, cx=250.0e3, cdepth=250.0e3, radius=100.0e3):
    """PlumeFreeSurface_2D.jl:59-93 init_phases!."""
    depth = -py
    ph = torch.full_like(px, float(CRUST))  # the mantle
    ph = torch.where(depth <= 100.0e3, float(AIR), ph)
    inside = (px - cx) ** 2 + (depth - cdepth) ** 2 < radius**2
    return torch.where((depth > 100.0e3) & inside, float(MANTLE), ph)


def _ratios_and_phi(particles, phase, geometry):
    rc, rv = phase_ratios_from_particles(particles, phase, 3, geometry)
    full = phase_ratios_from_field(rc)
    pr = PhaseRatios(center=rc, vertex=rv, face_x=full.face_x, face_y=full.face_y)
    return pr, update_rock_ratio(pr, air_phase=AIR)


def _lithostatic_P(material, pr_c, geometry, f):
    """init_P!: P = |ρg·z|·(z < 0) at the cell centers (RayleighTaylor2D.jl:32-36)."""
    rho = compute_density(material, phase_ratios=pr_c)
    z_c = torch.as_tensor(geometry.xci[1], **f)[None, :].expand(rho.shape)
    return torch.where(z_c < 0.0, rho * 9.81 * (-z_c), 0.0)


def _materials(rho, etas, f):
    return MaterialStack.make(
        [Material(rho0=r, eta0=e, gravity=9.81, G=math.inf, Kb=math.inf)
         for r, e in zip(rho, etas)], **f)


def _initial_stokes(ni, etas, material, pr_c, pr_v, geometry, dtype, device):
    stokes = StokesState.make(ni, dtype=dtype, device=device)
    f = dict(dtype=stokes.P.dtype, device=device)
    eta_tab = torch.as_tensor(etas, **f)
    return stokes.replace(
        viscosity=stokes.viscosity.replace(
            eta=phase_average(eta_tab, pr_c), eta_v=phase_average(eta_tab, pr_v)),
        P=_lithostatic_P(material, pr_c, geometry, f),
    )


def _advance(particles, phase, stokes, geometry, dt):
    """RK2 advection, re-slotting and injection of the phase particles."""
    particles = advect_rk2(particles, stokes.V.components, geometry, dt)
    particles, fields = move_particles(particles, geometry, {"phase": phase})
    particles, fields = inject_particles(particles, geometry, {}, phases=3,
                                         fields={"phase": fields["phase"]},
                                         phase_field="phase")
    return particles, fields["phase"]


def run(nx=32, ny=32, nt=3, nxcell=24, max_xcell=48, min_xcell=12,
        dt0_kyr=10.0, dt_max_kyr=50.0, iter_max=50_000, nout=2_000,
        dtype=None, device=None):
    """The Rayleigh-Taylor overturn on the variational sticky-air path;
    returns (stokes, particles, the particle phase, the last solve's info,
    max |Vy| per step, the time). ``device`` defaults to the card."""
    device = resolve_device(device)
    thick_air = 100.0e3
    lx, ly = 500.0e3, 500.0e3 + thick_air
    ni = (nx, ny)
    geometry = Geometry(ni, (lx, ly), origin=(0.0, -ly))
    dtype = torch.float64 if dtype is None else dtype
    f = dict(dtype=dtype, device=device)
    etas = (1.0e16, 1.0e21, 1.0e20)
    material = _materials((1.0, 3.3e3, 3.2e3), etas, f)

    particles = init_particles(geometry, nxcell, max_xcell, min_xcell, **f)
    phase = _phase_of_rt(particles.px, particles.py)
    pr, phi = _ratios_and_phi(particles, phase, geometry)
    stokes = _initial_stokes(ni, etas, material, pr.center, pr.vertex, geometry, dtype, device)

    # RayleighTaylor2D.jl:146: ϵ_abs=1e-6, ϵ_rel=1e-4, Re=3, r=0.7, CFL=0.98/√2.1
    pt = PTStokesCoeffs.make(
        geometry.li, geometry.di, Re=3.0, r=0.7, CFL=0.98 / math.sqrt(2.1),
        eps_abs=1.0e-6, eps_rel=1.0e-4,
    )
    # free slip left, right and top, no slip at the bottom (RayleighTaylor2D.jl:158-162)
    bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True), no_slip=Faces(bot=True),
        free_surface=True,
    )

    dt = dt0_kyr * 1.0e3 * YR
    dt_max = dt_max_kyr * 1.0e3 * YR
    info = None
    vmax_hist = []
    t = 0.0
    for _ in range(nt):
        stokes, info = solve_variational(
            stokes, pt, geometry, bc, material, pr.center, pr.vertex, phi, dt,
            iter_max=iter_max, iter_min=1_000, nout=nout, viscosity_relaxation=1.0e-2,
        )
        dt = min(float(compute_dt(stokes.V.components, geometry.di)), dt_max)
        particles, phase = _advance(particles, phase, stokes, geometry, dt)
        pr, phi = _ratios_and_phi(particles, phase, geometry)
        t += dt
        vmax_hist.append(float(stokes.V.Vy.abs().max()))

    return stokes, particles, phase, info, vmax_hist, t


def _plume_setup(nx, ny, nxcell, max_xcell, min_xcell, dtype, device):
    thick_air = 100.0e3
    lx, ly = 500.0e3, 400.0e3 + thick_air
    ni = (nx, ny)
    geometry = Geometry(ni, (lx, ly), origin=(0.0, -ly))
    dtype = torch.float64 if dtype is None else dtype
    f = dict(dtype=dtype, device=device)
    etas = (1.0e17, 1.0e21, 1.0e20)
    material = _materials((1.0e1, 3.3e3, 3.2e3), etas, f)
    particles = init_particles(geometry, nxcell, max_xcell, min_xcell, **f)
    phase = _phase_of_plume(particles.px, particles.py)
    return ni, geometry, dtype, etas, material, particles, phase


def run_plume_variational(nx=32, ny=32, nt=2, nxcell=24, max_xcell=48, min_xcell=12,
                          iter_max=50_000, nout=2_000, dtype=None, device=None):
    """The rising plume on the variational path with the masked
    stabilization term on (PlumeFreeSurface_VariationalStokes.jl:192-210);
    returns as :func:`run`."""
    device = resolve_device(device)
    ni, geometry, dtype, etas, material, particles, phase = _plume_setup(
        nx, ny, nxcell, max_xcell, min_xcell, dtype, device)
    pr, phi = _ratios_and_phi(particles, phase, geometry)
    stokes = _initial_stokes(ni, etas, material, pr.center, pr.vertex, geometry, dtype, device)
    pt = PTStokesCoeffs.make(
        geometry.li, geometry.di, Re=3.0 * math.pi, r=1.0,
        CFL=0.98 / math.sqrt(2.1), eps_abs=1.0e-6, eps_rel=1.0e-5,
    )
    bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True), free_surface=True)

    dt = 1.0e3 * YR
    # the CFL dt capped at 10 kyr: at ~nm/s plume velocities it reaches ~80
    # kyr, where the explicit stabilization term becomes unstable (the JAX
    # package's deviation from the reference script)
    dt_max = 10.0e3 * YR
    info = None
    vmax_hist = []
    t = 0.0
    for _ in range(nt):
        stokes, info = solve_variational(
            stokes, pt, geometry, bc, material, pr.center, pr.vertex, phi, dt,
            iter_max=iter_max, iter_min=1_000, nout=nout, viscosity_relaxation=1.0e-2,
            air_phase=AIR, free_surface=True, mask_step_floor=0.05,
        )
        dt = min(float(compute_dt(stokes.V.components, geometry.di)) * 0.95, dt_max)
        particles, phase = _advance(particles, phase, stokes, geometry, dt)
        pr, phi = _ratios_and_phi(particles, phase, geometry)
        t += dt
        vmax_hist.append(float(stokes.V.Vy.abs().max()))

    return stokes, particles, phase, info, vmax_hist, t


def run_plume(nx=32, ny=32, nt=3, nxcell=24, max_xcell=48, min_xcell=12,
              iter_max=50_000, nout=1_000, dtype=None, device=None):
    """The rising plume with the free-surface stabilization
    (PlumeFreeSurface_2D.jl:106-205) through the plain multi-phase solve;
    returns as :func:`run`."""
    device = resolve_device(device)
    ni, geometry, dtype, etas, material, particles, phase = _plume_setup(
        nx, ny, nxcell, max_xcell, min_xcell, dtype, device)
    pr_c, pr_v = phase_ratios_from_particles(particles, phase, 3, geometry)
    stokes = _initial_stokes(ni, etas, material, pr_c, pr_v, geometry, dtype, device)
    # PlumeFreeSurface_2D.jl:157: ϵ_rel=1e-6, Re=15π, r=1, CFL=0.98/√2.1
    pt = PTStokesCoeffs.make(
        geometry.li, geometry.di, Re=15.0 * math.pi, r=1.0,
        CFL=0.98 / math.sqrt(2.1), eps_abs=1.0e-6, eps_rel=1.0e-6,
    )
    bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True), free_surface=True)

    dt = 1.0e3 * YR  # PlumeFreeSurface_2D.jl:185
    info = None
    vmax_hist = []
    t = 0.0
    for _ in range(nt):
        stokes, info = solve_vep(
            stokes, pt, geometry, bc, material, pr_c, pr_v, dt,
            free_surface=True, iter_max=iter_max, iter_min=200, nout=nout, use_kernel=False,
        )
        dt = float(compute_dt(stokes.V.components, geometry.di)) * 0.95
        particles, phase = _advance(particles, phase, stokes, geometry, dt)
        pr_c, pr_v = phase_ratios_from_particles(particles, phase, 3, geometry)
        t += dt
        vmax_hist.append(float(stokes.V.Vy.abs().max()))

    return stokes, particles, phase, info, vmax_hist, t
