"""The 2D visco-elasto-plastic shear band on a refined (nonuniform) grid.

Counterpart of ``justrelax_tpu/models/shearband_refined.py`` (the
reference's ShearBand2D_refined.jl): the x vertices equidistribute a window
monitor clustered around the inclusion (≈10× finer there than at the
edges), y stays uniform, and the shear band's configuration and time loop
(``models/shearband.py``) run on that ``NonuniformGeometry``.

Before yield the VE stress build-up 2·ε̇·η·(1 − e^{−Gt/η}) is uniform in
space, so the stretched grid tracks the analytic curve as the uniform one
does; after yield the τII extrema land near the uniform grid's. Frozen f64
values of the JAX package at n=32, nt=10 (tests/test_shearband_refined.py):
τII extrema (1.51336, 1.63926) within 2e-3, max τxx at the last step
1.64586 within 2e-3, final residual < 1e-6.

The solve runs plain by contract (``use_kernel=False``): the VEP chunk
kernel needs a uniform grid.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs
from justrelax_tpu_torch.core.device import resolve_device
from justrelax_tpu_torch.core.grid import NonuniformGeometry
from justrelax_tpu_torch.core.state import StokesState
from justrelax_tpu_torch.models.shearband import _circle_phase_ratios
from justrelax_tpu_torch.ops.bc import Faces, VelocityBoundaryConditions, flow_bcs
from justrelax_tpu_torch.ops.stokes import tensor_invariant_staggered_2d
from justrelax_tpu_torch.rheology.materials import Material, MaterialStack
from justrelax_tpu_torch.solvers.stokes2d_vep import solve_vep

__all__ = ["refined_axis", "run"]


def refined_axis(n, lo=0.0, hi=1.0, center=0.5, amplitude=9.0, width=0.1):
    """n + 1 vertex coordinates on [lo, hi] that equidistribute the window
    monitor M(x) = 1 + amplitude·exp(−((x − center)/width)²): the cells
    cluster where M is large, ≈(1 + amplitude)× finer at the center."""
    xs = np.linspace(lo, hi, 8 * n + 1)
    M = 1.0 + amplitude * np.exp(-(((xs - center) / width) ** 2))
    cdf = np.concatenate([[0.0], np.cumsum(0.5 * (M[1:] + M[:-1]) * np.diff(xs))])
    cdf /= cdf[-1]
    xv = np.interp(np.linspace(0.0, 1.0, n + 1), cdf, xs)
    xv[0], xv[-1] = lo, hi
    return xv


def run(n=32, nt=10, eps_bg=1.0, dtype=None, device=None):
    """The shear band on the refined n × n grid over ``nt`` steps; returns
    (stokes, info, max τxx per step, the analytic VE curve per step, τII).
    ``device`` defaults to the card."""
    device = resolve_device(device)
    ni = (n, n)
    geometry = NonuniformGeometry((refined_axis(n), np.linspace(0.0, 1.0, n + 1)))
    xci, xvi = geometry.xci, geometry.xvi

    tau_y, phi, eta0, G0 = 1.6, 30.0, 1.0, 1.0
    dt = eta0 / G0 / 4.0
    common = dict(
        rho0=0.0, Kb=4.0, eta0=eta0, is_plastic=1.0, C=tau_y / math.cos(math.radians(phi)),
        friction_angle=phi, dilation_angle=0.0, eta_reg=8.0e-3,
    )
    stokes = StokesState.make(ni, dtype=dtype, device=device)
    f = dict(dtype=stokes.P.dtype, device=device)
    material = MaterialStack.make(
        [Material(G=G0, **common), Material(G=G0 / (6.0 - 4.0), **common)], **f)

    def ratios(xs, ys):
        return torch.as_tensor(_circle_phase_ratios(xs, ys, (0.5, 0.5), 0.1), **f)

    pr_center, pr_vertex = ratios(xci[0], xci[1]), ratios(xvi[0], xvi[1])
    pt_stokes = PTStokesCoeffs.make(geometry.li, geometry.di, eps_rel=1.0e-6,
                                    CFL=0.75 / math.sqrt(2.1))

    # pure shear from the nonuniform vertex coordinates
    xv = torch.as_tensor(xvi[0], **f)
    yv = torch.as_tensor(xvi[1], **f)
    Vx = (eps_bg * xv)[:, None].expand(n + 1, n + 2)
    Vy = (-eps_bg * yv)[None, :].expand(n + 2, n + 1)
    flow_bc = VelocityBoundaryConditions(free_slip=Faces(left=True, right=True, top=True,
                                                         bot=True))
    Vx, Vy = flow_bcs((Vx, Vy), flow_bc)
    stokes = stokes.replace(V=stokes.V.replace(Vx=Vx, Vy=Vy))

    t = 0.0
    tau_max_hist, sol_hist = [], []
    info = None
    for _ in range(nt):
        stokes, info = solve_vep(
            stokes, pt_stokes, geometry, flow_bc, material, pr_center, pr_vertex, dt,
            iter_max=50_000, nout=100, use_kernel=False,
        )
        tau_max_hist.append(float(stokes.tau.xx.max()))
        t += dt
        sol_hist.append(2.0 * eps_bg * eta0 * (1.0 - math.exp(-G0 * t / eta0)))
    tau_II = tensor_invariant_staggered_2d(stokes.tau.xx, stokes.tau.yy, stokes.tau.xy)
    return stokes, info, tau_max_hist, sol_hist, tau_II
