"""2D visco-elasto-plastic shear band benchmark.

Counterpart of ``justrelax_tpu/models/shearband.py``: a unit box under pure
shear (ε̇bg = 1) with a weak circular inclusion (softer shear modulus) and
regularized Drucker-Prager plasticity (C = 1.6/cos30°, φ = 30°, η_vp = 8e-3)
on a Maxwell VE background (η0 = G0 = 1, Kb = 4, dt = Maxwell time / 4).

Frozen f64 values of the JAX package at n=32, nt=10 (consistent ∂Q/∂τ
convention, tests/test_shearband2d.py): τII extrema (1.512963, 1.641536),
max τxx at the last step 1.637653, final residual < 1e-6.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs
from justrelax_tpu_torch.core.device import resolve_device
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.core.state import StokesState
from justrelax_tpu_torch.ops.bc import (
    DisplacementBoundaryConditions,
    Faces,
    VelocityBoundaryConditions,
    flow_bcs,
)
from justrelax_tpu_torch.ops.displacement import displacement2velocity, velocity2displacement
from justrelax_tpu_torch.ops.stokes import tensor_invariant_staggered_2d
from justrelax_tpu_torch.rheology.materials import Material, MaterialStack
from justrelax_tpu_torch.solvers.stokes2d_vep import solve_vep

__all__ = ["run", "run_softening", "run_dpcap"]


def _circle_phase_ratios(xs, ys, origin, radius):
    """One-hot (…, 2) phase ratios: phase 0 outside the circle, 1 inside."""
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    inside = (X - origin[0]) ** 2 + (Y - origin[1]) ** 2 <= radius**2
    ratios = np.zeros(X.shape + (2,))
    ratios[..., 0] = ~inside
    ratios[..., 1] = inside
    return ratios


def _setup(n, common, G_inclusion, dtype, device, eps_bg=1.0, dt=None, **pt_kw):
    """Grid, two-phase material, phase ratios, pure-shear initial state and
    PT coefficients shared by the shear band variants, on ``device`` (the
    card unless given). With ``dt`` the problem is displacement-driven: the
    BCs act on U = V·dt, and V is converted from U."""
    device = resolve_device(device)
    ni = (n, n)
    geometry = Geometry(ni, (1.0, 1.0))
    xci, xvi = geometry.xci, geometry.xvi
    stokes = StokesState.make(ni, dtype=dtype, device=device)
    f = stokes.P.dtype
    material = MaterialStack.make(
        [Material(G=1.0, **common), Material(G=G_inclusion, **common)],
        dtype=f, device=device,
    )

    def ratios(xs, ys):
        return torch.as_tensor(
            _circle_phase_ratios(xs, ys, (0.5, 0.5), 0.1), dtype=f, device=device)

    pr_center, pr_vertex = ratios(xci[0], xci[1]), ratios(xvi[0], xvi[1])
    pt_stokes = PTStokesCoeffs.make(geometry.li, geometry.di, **pt_kw)
    xv = torch.as_tensor(xvi[0], dtype=f, device=device)
    yv = torch.as_tensor(xvi[1], dtype=f, device=device)
    Vx = (eps_bg * xv)[:, None].expand(n + 1, n + 2)
    Vy = (-eps_bg * yv)[None, :].expand(n + 2, n + 1)
    faces = Faces(left=True, right=True, top=True, bot=True)
    if dt is not None:
        flow_bc = DisplacementBoundaryConditions(free_slip=faces)
        Ux, Uy = flow_bcs((Vx * dt, Vy * dt), flow_bc)
        stokes = stokes.replace(U=stokes.U.replace(Ux=Ux, Uy=Uy))
        stokes = displacement2velocity(stokes, dt, flow_bc)
    else:
        flow_bc = VelocityBoundaryConditions(free_slip=faces)
        Vx, Vy = flow_bcs((Vx, Vy), flow_bc)
        stokes = stokes.replace(V=stokes.V.replace(Vx=Vx, Vy=Vy))
    return geometry, material, pr_center, pr_vertex, stokes, pt_stokes, flow_bc


def run(n=32, nt=10, eps_bg=1.0, dtype=None, displacement_driven=False,
        dilation_angle=0.0, use_kernel=None, dqdtau_alt=0.0,
        visc_plastic_tau=False, device=None, iter_max=50_000, nout=100):
    """The base shear band over ``nt`` steps; returns (stokes, info,
    max τxx per step, the analytic VE curve per step, τII).
    ``device`` defaults to the card; ``use_kernel`` to the Hopper kernel
    on the card and the plain path on the CPU (``False`` asks for the plain
    path); ``iter_max``/``nout`` set the solve's iteration cap and chunk
    length. ``displacement_driven`` drives the BCs through the displacement
    U = V·dt (``DisplacementBoundaryConditions``) and keeps U = V·dt after
    every step; with a fixed dt it is the velocity-driven band."""
    tau_y, phi, eta0, G0 = 1.6, 30.0, 1.0, 1.0
    dt = eta0 / G0 / 4.0
    common = dict(
        rho0=0.0, Kb=4.0, eta0=eta0, is_plastic=1.0,
        C=tau_y / math.cos(math.radians(phi)), friction_angle=phi,
        dilation_angle=dilation_angle, eta_reg=8.0e-3, dqdtau_alt=dqdtau_alt,
    )
    geometry, material, pr_c, pr_v, stokes, pt_stokes, flow_bc = _setup(
        n, common, G0 / (6.0 - 4.0), dtype, device, eps_bg=eps_bg,
        dt=dt if displacement_driven else None,
        eps_rel=1.0e-6, CFL=0.75 / math.sqrt(2.1),
    )
    t = 0.0
    tau_max_hist, sol_hist = [], []
    info = None
    for _ in range(nt):
        stokes, info = solve_vep(
            stokes, pt_stokes, geometry, flow_bc, material, pr_c, pr_v, dt,
            iter_max=iter_max, nout=nout, use_kernel=use_kernel,
            visc_plastic_tau=visc_plastic_tau,
        )
        if displacement_driven:
            stokes = velocity2displacement(stokes, dt)
        tau_max_hist.append(float(stokes.tau.xx.max()))
        t += dt
        sol_hist.append(2.0 * eps_bg * eta0 * (1.0 - math.exp(-G0 * t / eta0)))
    tau_II = tensor_invariant_staggered_2d(stokes.tau.xx, stokes.tau.yy, stokes.tau.xy)
    return stokes, info, tau_max_hist, sol_hist, tau_II


def run_softening(n=32, nt=5, eps_bg=1.0, device=None, use_kernel=None):
    """Non-linear cohesion softening shear band (ξ₀ = τ_y, Δ = τ_y/2 on both
    phases, dt = Maxwell/4/5 over 5 steps); returns (stokes, info, max τxx
    per step, the analytic VE curve per step). ``device`` and
    ``use_kernel`` as in :func:`run`."""
    tau_y, phi, eta0, G0 = 1.6, 30.0, 1.0, 1.0
    dt = eta0 / G0 / 4.0 / 5.0
    common = dict(
        rho0=0.0, Kb=4.0, eta0=eta0, is_plastic=1.0,
        C=tau_y / math.cos(math.radians(phi)), friction_angle=phi,
        eta_reg=8.0e-3, soft_C_nl=1.0, soft_C_nl_xi0=tau_y,
        soft_C_nl_delta=tau_y / 2.0,
    )
    geometry, material, pr_c, pr_v, stokes, pt_stokes, flow_bc = _setup(
        n, common, G0 / (6.0 - 4.0), None, device, eps_bg=eps_bg,
        eps_rel=1.0e-6, CFL=0.75 / math.sqrt(2.1),
    )
    t = 0.0
    tau_max_hist, sol_hist = [], []
    info = None
    for _ in range(nt):
        stokes, info = solve_vep(
            stokes, pt_stokes, geometry, flow_bc, material, pr_c, pr_v, dt,
            iter_max=50_000, nout=100, use_kernel=use_kernel,
        )
        tau_max_hist.append(float(stokes.tau.xx.max()))
        t += dt
        sol_hist.append(2.0 * eps_bg * eta0 * (1.0 - math.exp(-G0 * t / eta0)))
    return stokes, info, tau_max_hist, sol_hist


def run_dpcap(n=32, nt=10, device=None, use_kernel=None):
    """Dilatant Drucker-Prager shear band with a tension cap (ψ = 3°,
    pT = −0.5); returns (stokes, info, τII). ``device`` and ``use_kernel``
    as in :func:`run`."""
    tau_y, phi, eta0, G0 = 1.6, 30.0, 1.0, 1.0
    dt = eta0 / G0 / 8.0
    common = dict(
        rho0=0.0, Kb=4.0, eta0=eta0, is_plastic=1.0,
        C=tau_y / math.cos(math.radians(phi)), friction_angle=phi,
        dilation_angle=3.0, eta_reg=1.0e-3, tension_pT=-0.5,
    )
    geometry, material, pr_c, pr_v, stokes, pt_stokes, flow_bc = _setup(
        n, common, G0 / 2.0, None, device,
        eps_abs=1.0e-6, eps_rel=1.0e-6, CFL=0.95 / math.sqrt(2.1),
    )
    info = None
    for _ in range(nt):
        stokes, info = solve_vep(
            stokes, pt_stokes, geometry, flow_bc, material, pr_c, pr_v, dt,
            iter_max=50_000, nout=1000, use_kernel=use_kernel,
        )
    tau_II = tensor_invariant_staggered_2d(stokes.tau.xx, stokes.tau.yy, stokes.tau.xy)
    return stokes, info, tau_II
