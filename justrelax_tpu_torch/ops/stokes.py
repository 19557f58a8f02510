"""Stokes stencil functions (2D): divergence, strain rate, pressure, velocity
update, residuals, invariants, vorticity.

Counterpart of ``justrelax_tpu/ops/stokes.py`` on a uniform grid, with the
same staggered shapes. The damped PT updates (Räss et al. 2022):

  P  ← P + ψ·RP/(1+ψ/(K dt)),  ψ = (1/η + 1/(G dt))⁻¹ · r/θ_dτ
  V  ← V + (∇·τ − ∇P − ρg) · ηdτ / ητ̄
"""

from __future__ import annotations

from typing import Optional

import torch.nn.functional as F

__all__ = [
    "compute_grad_V",
    "compute_strain_rate",
    "compute_P",
    "compute_V",
    "compute_Res",
    "tensor_invariant_2d",
    "tensor_invariant_staggered_2d",
    "compute_vorticity",
]


def compute_grad_V(Vx, Vy, inv_dx, inv_dy):
    """∇·V at cell centers."""
    return (Vx[1:, 1:-1] - Vx[:-1, 1:-1]) * inv_dx + (
        Vy[1:-1, 1:] - Vy[1:-1, :-1]
    ) * inv_dy


def compute_strain_rate(grad_V, Vx, Vy, inv_dx, inv_dy):
    """(εxx, εyy) at centers, εxy at vertices."""
    third = 1.0 / 3.0
    exx = (Vx[1:, 1:-1] - Vx[:-1, 1:-1]) * inv_dx - grad_V * third
    eyy = (Vy[1:-1, 1:] - Vy[1:-1, :-1]) * inv_dy - grad_V * third
    exy = 0.5 * ((Vx[:, 1:] - Vx[:, :-1]) * inv_dy + (Vy[1:, :] - Vy[:-1, :]) * inv_dx)
    return exx, eyy, exy


def compute_P(P, P0, grad_V, Q, eta, K, G, dt, r, theta_dtau):
    """Compressible visco-elastic pressure update; returns (RP, P_new).
    ``K``/``G`` may be ∞ (incompressible / purely viscous)."""
    _Kdt = 1.0 / (K * dt)
    _Gdt = 1.0 / (G * dt)
    _dt = 1.0 / dt
    rhs = -grad_V + Q * _dt
    RP = -(P - P0) * _Kdt + rhs
    psi = 1.0 / (1.0 / eta + _Gdt) * (r / theta_dtau)
    P_new = ((P0 * _Kdt + rhs) * psi + P) / (1.0 + _Kdt * psi)
    return RP, P_new


def _x_momentum(P, txx, txy, rho_gx, inv_dx, inv_dy):
    """x-momentum balance on the interior x-faces (nx-1, ny)."""
    txy_f = txy[1:-1, :]
    return (
        (txx[1:, :] - txx[:-1, :]) * inv_dx
        + (txy_f[:, 1:] - txy_f[:, :-1]) * inv_dy
        - (P[1:, :] - P[:-1, :]) * inv_dx
        - 0.5 * (rho_gx[1:, :] + rho_gx[:-1, :])
    )


def _y_momentum(P, tyy, txy, rho_gy, inv_dx, inv_dy):
    """y-momentum balance on the interior y-faces (nx, ny-1)."""
    txy_f = txy[:, 1:-1]
    return (
        (tyy[:, 1:] - tyy[:, :-1]) * inv_dy
        + (txy_f[1:, :] - txy_f[:-1, :]) * inv_dx
        - (P[:, 1:] - P[:, :-1]) * inv_dy
        - 0.5 * (rho_gy[:, 1:] + rho_gy[:, :-1])
    )


def _free_surface_correction(Vy, rho_gy, inv_dy, dt):
    """Vy·∂(ρg)/∂y·dt on the interior Vy nodes."""
    return Vy[1:-1, 1:-1] * ((rho_gy[:, 1:] - rho_gy[:, :-1]) * inv_dy) * dt


def compute_V(Vx, Vy, P, txx, tyy, txy, etadtau, rho_gx, rho_gy, eta_tau,
              inv_dx, inv_dy, free_surface_dt: Optional[float] = None):
    """Damped velocity update on the interior faces."""
    rx = _x_momentum(P, txx, txy, rho_gx, inv_dx, inv_dy)
    ry = _y_momentum(P, tyy, txy, rho_gy, inv_dx, inv_dy)
    if free_surface_dt is not None:
        ry = ry + _free_surface_correction(Vy, rho_gy, inv_dy, free_surface_dt)
    etax = 0.5 * (eta_tau[1:, :] + eta_tau[:-1, :])
    etay = 0.5 * (eta_tau[:, 1:] + eta_tau[:, :-1])
    Vx = Vx + F.pad(rx * etadtau / etax, (1, 1, 1, 1))
    Vy = Vy + F.pad(ry * etadtau / etay, (1, 1, 1, 1))
    return Vx, Vy


def compute_Res(P, txx, tyy, txy, rho_gx, rho_gy, inv_dx, inv_dy, Vy=None,
                free_surface_dt=None):
    """Momentum residuals Rx (nx-1, ny), Ry (nx, ny-1)."""
    Rx = _x_momentum(P, txx, txy, rho_gx, inv_dx, inv_dy)
    Ry = _y_momentum(P, tyy, txy, rho_gy, inv_dx, inv_dy)
    if free_surface_dt is not None:
        Ry = Ry + _free_surface_correction(Vy, rho_gy, inv_dy, free_surface_dt)
    return Rx, Ry


def tensor_invariant_2d(xx, yy, xy_c):
    """Second invariant at centers √(½(xx²+yy²) + xy²)."""
    return (0.5 * (xx**2 + yy**2) + xy_c**2).sqrt()


def tensor_invariant_staggered_2d(xx, yy, xy_v):
    """Staggered second invariant at centers: the shear term is the mean of
    the squared 4 surrounding vertex values."""
    xy2 = 0.25 * (
        xy_v[:-1, :-1] ** 2 + xy_v[1:, :-1] ** 2 + xy_v[:-1, 1:] ** 2 + xy_v[1:, 1:] ** 2
    )
    return (0.5 * (xx**2 + yy**2) + xy2).sqrt()


def compute_vorticity(Vx, Vy, inv_dx, inv_dy):
    """ω_xy = ½(∂Vx/∂y − ∂Vy/∂x) at vertices."""
    return 0.5 * ((Vx[:, 1:] - Vx[:, :-1]) * inv_dy - (Vy[1:, :] - Vy[:-1, :]) * inv_dx)
