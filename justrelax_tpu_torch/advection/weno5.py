"""WENO-5 advection with SSP-RK3 time integration (2D).

Counterpart of ``justrelax_tpu/advection/weno5.py``: Jiang–Shu (method=1)
or WENO-Z (method=2) weights, upwind/downwind flux reconstruction with
boundary-clamped stencils, and a 3-stage strong-stability-preserving
Runge-Kutta step:

    u¹ = u − Δt·R(u)
    u² = ¾u + ¼u¹ − ¼Δt·R(u¹)
    u  ← ⅓u + ⅔u² − ⅔Δt·R(u²)

The advected field and both velocity components live on the same grid.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["weno_advect"]

# upwind / downwind optimal weights
D_L = (1.0 / 10.0, 3.0 / 5.0, 3.0 / 10.0)
D_R = (3.0 / 10.0, 3.0 / 5.0, 1.0 / 10.0)
C1, C2 = 13.0 / 12.0, 1.0 / 4.0
SC = (1.0 / 3.0, 7.0 / 6.0, 11.0 / 6.0, 1.0 / 6.0, 5.0 / 6.0)
EPS = 1.0e-6


def _cshift(u, axis: int, k: int):
    """u[clamp(i+k, 0, n-1)] along ``axis`` (boundary-clamped stencil)."""
    if k == 0:
        return u
    n = u.shape[axis]
    if k > 0:
        edge = u.narrow(axis, n - 1, 1)
        return torch.cat([u.narrow(axis, k, n - k)] + [edge] * k, dim=axis)
    edge = u.narrow(axis, 0, 1)
    return torch.cat([edge] * (-k) + [u.narrow(axis, 0, n + k)], dim=axis)


def _betas(u1, u2, u3, u4, u5):
    b0 = C1 * (u1 - 2 * u2 + u3) ** 2 + C2 * (u1 - 4 * u2 + 3 * u3) ** 2
    b1 = C1 * (u2 - 2 * u3 + u4) ** 2 + C2 * (u2 - u4) ** 2
    b2 = C1 * (u3 - 2 * u4 + u5) ** 2 + C2 * (3 * u3 - 4 * u4 + u5) ** 2
    return b0, b1, b2


def _alphas(d, betas, method):
    if method == 1:  # Jiang-Shu (a tensor numerator: float / tensor is reciprocal·float)
        return tuple(torch.full_like(bi, di) / (bi + EPS) ** 2 for di, bi in zip(d, betas))
    tau = torch.abs(betas[0] - betas[2])  # WENO-Z
    return tuple(di * (1 + (tau / (bi + EPS)) ** 2) for di, bi in zip(d, betas))


def _weno_u(u1, u2, u3, u4, u5, method, upwind: bool):
    betas = _betas(u1, u2, u3, u4, u5)
    a = _alphas(D_L if upwind else D_R, betas, method)
    inv_sum = 1.0 / (a[0] + a[1] + a[2])
    w = tuple(ai * inv_sum for ai in a)
    sc1, sc2, sc3, sc4, sc5 = SC
    if upwind:
        s0 = sc1 * u1 - sc2 * u2 + sc3 * u3
        s1 = -sc4 * u2 + sc5 * u3 + sc1 * u4
        s2 = sc1 * u3 + sc5 * u4 - sc4 * u5
    else:
        s0 = -sc4 * u1 + sc5 * u2 + sc1 * u3
        s1 = sc1 * u2 + sc5 * u3 - sc4 * u4
        s2 = sc3 * u3 - sc2 * u4 + sc1 * u5
    return w[0] * s0 + w[1] * s1 + w[2] * s2


def _fluxes(u, axis, method):
    st = tuple(_cshift(u, axis, k) for k in (-2, -1, 0, 1, 2))
    return (_weno_u(*st, method, upwind=True), _weno_u(*st, method, upwind=False))


def _rhs(u, vx, vy, inv_dx, inv_dy, method):
    """Upwind-split advective derivative. fB/fT are the x-direction fluxes
    and fL/fR the y-direction ones."""
    fB, fT = _fluxes(u, 0, method)
    fL, fR = _fluxes(u, 1, method)
    return (
        torch.clamp_min(vx, 0.0) * (fB - _cshift(fB, 0, -1)) * inv_dx
        + torch.clamp_max(vx, 0.0) * (_cshift(fT, 0, +1) - fT) * inv_dx
        + torch.clamp_min(vy, 0.0) * (fL - _cshift(fL, 1, -1)) * inv_dy
        + torch.clamp_max(vy, 0.0) * (_cshift(fR, 1, +1) - fR) * inv_dy
    )


def weno_advect(u, V: Tuple[torch.Tensor, torch.Tensor], di, dt, method: int = 2):
    """Advect ``u`` by one SSP-RK3 step with velocities ``V = (vx, vy)`` on
    the same grid. ``method``: 1 = Jiang-Shu, 2 = WENO-Z weights."""
    vx, vy = V
    inv_dx, inv_dy = 1.0 / di[0], 1.0 / di[1]
    r1 = _rhs(u, vx, vy, inv_dx, inv_dy, method)
    ut = u - dt * r1
    r2 = _rhs(ut, vx, vy, inv_dx, inv_dy, method)
    ut = 0.75 * u + 0.25 * ut - 0.25 * dt * r2
    r3 = _rhs(ut, vx, vy, inv_dx, inv_dy, method)
    return u / 3.0 + (2.0 / 3.0) * ut - (2.0 / 3.0) * dt * r3
