"""3D visco-elasto-plastic shear bands around weak inclusions.

Counterpart of ``justrelax_tpu/models/shearband3d.py``. A unit box under
pure shear (ε̇bg·x, −ε̇bg·z), with Drucker-Prager plasticity C·cosφ = τ_y =
1.6, φ = 30°, ψ = 0, η_reg = 1.25e-2, Kb = ∞, dt = η0/G0/8 on a Maxwell
background η0 = G0 = 1. ``run``: one spherical inclusion of radius 0.1 with
η0/10 and G0/2; before yield the stress follows the Maxwell build-up
2ε̇η(1 − exp(−G t/η)), after yield it is capped near the DP envelope and
plastic strain localises in bands through the inclusion. ``run_multi``:
five inclusions (four of radius 0.075 and a central one of 0.1) with G0/2
and the background viscosity. Frozen f64 values of the JAX package at n=12,
nt=14 (tests/test_shearband3d.py): max τII at the last step 1.625106, max
EII 0.3258544082022995.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs
from justrelax_tpu_torch.core.device import resolve_device
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.core.state import StokesState
from justrelax_tpu_torch.ops.bc import Faces, VelocityBoundaryConditions, flow_bcs
from justrelax_tpu_torch.ops.stokes3d import tensor_invariant_staggered_3d
from justrelax_tpu_torch.rheology.materials import Material, MaterialStack
from justrelax_tpu_torch.rheology.phases import phase_ratios_from_field
from justrelax_tpu_torch.solvers.stokes3d_vep import solve_vep_3d

__all__ = ["run", "run_multi"]

ETA0, G0 = 1.0, 1.0
DT = ETA0 / G0 / 8.0


def _inclusions(geometry, centers, radii, strict):
    X, Y, Z = np.meshgrid(*[np.asarray(c) for c in geometry.xci], indexing="ij")
    inside = np.zeros(X.shape, bool)
    for (cx, cy, cz), rad in zip(centers, radii):
        d2 = (X - cx) ** 2 + (Y - cy) ** 2 + (Z - cz) ** 2
        inside |= d2 < rad**2 if strict else d2 <= rad**2
    return inside


def _setup(n, dtype=None, device=None, eps_bg=1.0, multi=False):
    """Grid, two-phase material, phase ratios, pure-shear initial state, BCs
    and PT coefficients of :func:`run` (``multi=False``) or
    :func:`run_multi`, on ``device`` (the card unless given). Returns
    (geometry, stokes, material, phase ratios (center, (yz, xz, xy)),
    flow_bc, pt_stokes, dt)."""
    device = resolve_device(device)
    ni = (n, n, n)
    geometry = Geometry(ni, (1.0, 1.0, 1.0))
    tau_y, phi = 1.6, 30.0
    common = dict(rho0=0.0, Kb=math.inf, is_plastic=1.0,
                  C=tau_y / math.cos(math.radians(phi)), friction_angle=phi,
                  dilation_angle=0.0, eta_reg=1.25e-2)
    if multi:
        eta_i = ETA0
        inside = _inclusions(geometry, ((0.4, 0.25, 0.25), (0.25, 0.6, 0.25),
                                        (0.25, 0.85, 0.75), (0.75, 0.35, 0.75),
                                        (0.5, 0.5, 0.5)),
                             (0.075, 0.075, 0.075, 0.075, 0.1), strict=True)
    else:
        eta_i = ETA0 / 10.0
        inside = _inclusions(geometry, ((0.5, 0.5, 0.5),), (0.1,), strict=False)
    stokes = StokesState.make(ni, dtype=dtype, device=device)
    f = stokes.P.dtype
    kw = dict(dtype=f, device=device)
    material = MaterialStack.make([Material(G=G0, eta0=ETA0, **common),
                                   Material(G=G0 / 2.0, eta0=eta_i, **common)], **kw)
    pr = phase_ratios_from_field(torch.as_tensor(inside.astype(np.int64), device=device), 2,
                                 dtype=f)
    eta_c = torch.where(torch.as_tensor(inside, device=device), eta_i, ETA0).to(f)
    stokes = stokes.replace(viscosity=stokes.viscosity.replace(eta=eta_c))

    xv = torch.as_tensor(geometry.xvi[0], **kw)
    zv = torch.as_tensor(geometry.xvi[2], **kw)
    Vx = (eps_bg * xv)[:, None, None].expand(n + 1, n + 2, n + 2)
    Vy = torch.zeros((n + 2, n + 1, n + 2), **kw)
    Vz = (-eps_bg * zv)[None, None, :].expand(n + 2, n + 2, n + 1)
    bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True, front=True, back=True))
    Vx, Vy, Vz = flow_bcs((Vx, Vy, Vz), bc)
    stokes = stokes.replace(V=stokes.V.replace(Vx=Vx, Vy=Vy, Vz=Vz))
    tol = 1.0e-5 if multi else 1.0e-6
    pt = PTStokesCoeffs.make(geometry.li, geometry.di, CFL=0.75 / math.sqrt(3.1),
                             eps_rel=tol, eps_abs=tol)
    ratios = (pr.center, (pr.edge_yz, pr.edge_xz, pr.edge_xy))
    return geometry, stokes, material, ratios, bc, pt, DT


def _steps(n, nt, eps_bg, dtype, device, use_kernel, iter_max, nout, multi):
    geometry, stokes, material, (pr_c, pr_e), bc, pt, dt = _setup(
        n, dtype, device, eps_bg=eps_bg, multi=multi)
    t = 0.0
    tau_hist, sol_hist = [], []
    info = None
    for _ in range(nt):
        stokes, info = solve_vep_3d(
            stokes, pt, geometry, bc, material, pr_c, pr_e, dt,
            iter_max=iter_max, iter_min=100, nout=nout, viscosity_relaxation=1.0,
            use_kernel=use_kernel)
        t += dt
        if multi:
            tau_hist.append(float(stokes.tau.xx.max()))
        else:
            tau = stokes.tau
            tau_hist.append(float(tensor_invariant_staggered_3d(
                tau.xx, tau.yy, tau.zz, tau.yz, tau.xz, tau.xy).max()))
        sol_hist.append(2.0 * eps_bg * ETA0 * (1.0 - math.exp(-G0 * t / ETA0)))
    return stokes, info, tau_hist, sol_hist


def run(n=16, nt=8, eps_bg=1.0, dtype=None, device=None, use_kernel=None,
        iter_max=30_000, nout=200):
    """The single-inclusion shear band over ``nt`` steps; returns (stokes,
    info, max τII per step, the Maxwell curve per step). ``device``
    defaults to the card; ``use_kernel`` to the edge kernel (B6) on the card
    and the serial path on the CPU (``solve_vep_3d``'s routes);
    ``iter_max``/``nout`` set each solve's iteration cap and chunk length."""
    return _steps(n, nt, eps_bg, dtype, device, use_kernel, iter_max, nout, multi=False)


def run_multi(n=16, nt=6, eps_bg=1.0, dtype=None, device=None, use_kernel=None,
              iter_max=30_000, nout=200):
    """Five weak inclusions under pure shear; returns (stokes, info, max τxx
    per step, the Maxwell curve per step). The shear bands link the
    inclusions; τxx follows the Maxwell build-up until the DP cap.
    ``device``, ``use_kernel``, ``iter_max`` and ``nout`` as in
    :func:`run`."""
    return _steps(n, nt, eps_bg, dtype, device, use_kernel, iter_max, nout, multi=True)
