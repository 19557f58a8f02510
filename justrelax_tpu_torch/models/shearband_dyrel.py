"""The visco-elasto-plastic shear band solved with DYREL.

Counterpart of ``justrelax_tpu/models/shearband_dyrel.py``: the geometry of
``models/shearband.py`` with Kb = 5, Gi = G0/2, η_vp = 1e-2, and the
pure-shear velocity on the boundary only (interior zeroed). On the card
every DR chunk of ``solve_dyrel`` is a CUDA graph replay.

The JAX test's assertions at n=32, nt=10 (tests/test_dyrel.py): final
residual < 1e-6, the analytic VE curve 1.8358, τII max 1.639 (±1e-3) and
min 1.53835 (±1e-2), max τxx at the last step 1.63771 (±5e-3), fewer than
20 000 DR iterations in the last step.
"""

from __future__ import annotations

import math

from justrelax_tpu_torch.models import shearband
from justrelax_tpu_torch.ops.bc import flow_bcs
from justrelax_tpu_torch.rheology.plasticity import second_invariant_staggered
from justrelax_tpu_torch.solvers.dyrel import solve_dyrel

__all__ = ["run", "run_dpcap"]


def _g4(A):
    return (A[:-1, :-1], A[1:, :-1], A[:-1, 1:], A[1:, 1:])


def _setup(n, common, eps_bg, boundary_only, dtype, device):
    """``models/shearband.py``'s grid, two-phase material (Gi = G0/2),
    phase ratios and pure-shear initial state on ``device`` (the card
    unless given), the velocity on the boundary only with
    ``boundary_only``."""
    geometry, material, pr_c, pr_v, stokes, _, flow_bc = shearband._setup(
        n, common, 0.5, dtype, device, eps_bg=eps_bg)
    if boundary_only:
        Vx, Vy = stokes.V.Vx.clone(), stokes.V.Vy.clone()
        Vx[1:-1, 1:-1] = 0.0
        Vy[1:-1, 1:-1] = 0.0
        Vx, Vy = flow_bcs((Vx, Vy), flow_bc)
        stokes = stokes.replace(V=stokes.V.replace(Vx=Vx, Vy=Vy))
    return geometry, material, pr_c, pr_v, stokes, flow_bc


def run(n=32, nt=10, eps_bg=1.0, dtype=None, device=None, iter_max=50_000,
        total_iter_max=50_000):
    """The DYREL shear band over ``nt`` steps; returns (stokes, info of the
    last solve, max τxx per step, the analytic VE curve per step, τII).
    ``device`` defaults to the card; ``iter_max``/``total_iter_max`` cap
    each solve's inner solve and its DR iterations."""
    tau_y, phi, eta0, G0 = 1.6, 30.0, 1.0, 1.0
    dt = eta0 / G0 / 4.0
    common = dict(
        rho0=0.0, Kb=5.0, eta0=eta0, is_plastic=1.0,
        C=tau_y / math.cos(math.radians(phi)), friction_angle=phi,
        dilation_angle=0.0, eta_reg=1.0e-2,
    )
    geometry, material, pr_c, pr_v, stokes, flow_bc = _setup(
        n, common, eps_bg, True, dtype, device)
    t = 0.0
    tau_max_hist, sol_hist = [], []
    info = None
    for _ in range(nt):
        stokes, info = solve_dyrel(
            stokes, geometry, flow_bc, material, pr_c, pr_v, dt,
            eps=1.0e-6, nout=50, rel_drop=0.5, iter_max=iter_max,
            total_iter_max=total_iter_max,
        )
        tau_max_hist.append(float(stokes.tau.xx.max()))
        t += dt
        sol_hist.append(2.0 * eps_bg * eta0 * (1.0 - math.exp(-G0 * t / eta0)))
    tau_II = second_invariant_staggered(stokes.tau.xx, stokes.tau.yy, _g4(stokes.tau.xy))
    return stokes, info, tau_max_hist, sol_hist, tau_II


def run_dpcap(n=32, nt=10, eps_bg=1.0, dtype=None, device=None):
    """The dilatant Drucker-Prager shear band with a tension cap under DYREL
    (ψ = 3°, pT = −0.5, Kb = 4, Gi = G0/2, η_vp = 1e-3, dt = 1/8, the
    pure-shear velocity on every node); returns (stokes, info, τII). The
    JAX test's envelope: converged below 1e-5, τII max < 2, ε_pl > 0
    somewhere, EVol_pl > 0 somewhere, ε_vol_pl ≥ 0 everywhere (dilation)
    and > 0 somewhere."""
    tau_y, phi, eta0, G0 = 1.6, 30.0, 1.0, 1.0
    dt = eta0 / G0 / 8.0
    common = dict(
        rho0=0.0, Kb=4.0, eta0=eta0, is_plastic=1.0,
        C=tau_y / math.cos(math.radians(phi)), friction_angle=phi,
        dilation_angle=3.0, eta_reg=1.0e-3, tension_pT=-0.5,
    )
    geometry, material, pr_c, pr_v, stokes, flow_bc = _setup(
        n, common, eps_bg, False, dtype, device)
    info = None
    for _ in range(nt):
        stokes, info = solve_dyrel(
            stokes, geometry, flow_bc, material, pr_c, pr_v, dt,
            eps=1.0e-6, nout=50, rel_drop=0.5,
        )
    tau_II = second_invariant_staggered(stokes.tau.xx, stokes.tau.yy, _g4(stokes.tau.xy))
    return stokes, info, tau_II
