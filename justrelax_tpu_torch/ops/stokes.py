"""Stokes stencil functions (2D): divergence, strain rate, pressure, stress,
velocity update, residuals, invariants, vorticity.

Counterpart of ``justrelax_tpu/ops/stokes.py``, with the same staggered
shapes. Derivatives that land at the centers divide by the cell widths (the
center family, ``inv_dx``/``inv_dy``); those that land on the faces or
vertices by the distance between adjacent centers (the vertex family). On a
uniform grid both are the scalar ``1/di``; a ``NonuniformGeometry`` passes
broadcastable tensors of both (``spacing_families_2d``). The damped PT
updates (Räss et al. 2022):

  P  ← P + ψ·RP/(1+ψ/(K dt)),  ψ = (1/η + 1/(G dt))⁻¹ · r/θ_dτ
  τ  ← τ + (2η ε − (τ−τ_o)·η/(G dt) − τ) / (θ_dτ + η/(G dt) + 1)
  V  ← V + (∇·τ − ∇P − ρg) · ηdτ / ητ̄
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from justrelax_tpu_torch.core.grid import spacing_tensors
from justrelax_tpu_torch.ops.bc import flow_bcs
from justrelax_tpu_torch.ops.stencil import av_a

__all__ = [
    "spacing_families_2d",
    "compute_grad_V",
    "compute_strain_rate",
    "compute_P",
    "compute_tau_visc",
    "compute_tau_ve",
    "compute_V",
    "compute_Res",
    "tensor_invariant_2d",
    "tensor_invariant_staggered_2d",
    "compute_vorticity",
    "ve_iteration",
]


def spacing_families_2d(geometry, like):
    """``(inv_dx, inv_dy, strain_v, mom_spacings)`` of the 2D solvers: the
    center family (1/cell width), ``strain_v``, the vertex family of the
    shear strain rate and the vorticity (``inv_dx_v``, ``inv_dy_v``), and
    the momentum bundle of :func:`compute_V` (vertex-x on the interior x
    faces and center-y; vertex-y on the interior y faces and center-x). On
    a uniform grid each is the scalar ``1/di`` of its axis. On a
    ``NonuniformGeometry`` they are broadcastable ((nx, 1), (1, ny), …)
    views of ``core/grid.py::spacing_tensors``, in ``like``'s dtype and on
    its device."""
    tensors = spacing_tensors(geometry, like)
    if tensors is None:
        inv_dx, inv_dy = 1.0 / geometry.di[0], 1.0 / geometry.di[1]
        return (inv_dx, inv_dy, dict(inv_dx_v=inv_dx, inv_dy_v=inv_dy),
                (inv_dx, inv_dy, inv_dy, inv_dx))
    (inv_dvx, inv_dvy), (inv_dcx, inv_dcy) = tensors
    strain_v = dict(inv_dx_v=inv_dvx, inv_dy_v=inv_dvy)
    mom_spacings = (inv_dvx[1:-1], inv_dcy, inv_dvy[:, 1:-1], inv_dcx)
    return inv_dcx, inv_dcy, strain_v, mom_spacings


def compute_grad_V(Vx, Vy, inv_dx, inv_dy):
    """∇·V at cell centers."""
    return (Vx[1:, 1:-1] - Vx[:-1, 1:-1]) * inv_dx + (
        Vy[1:-1, 1:] - Vy[1:-1, :-1]
    ) * inv_dy


def compute_strain_rate(grad_V, Vx, Vy, inv_dx, inv_dy, inv_dx_v=None, inv_dy_v=None):
    """(εxx, εyy) at centers, εxy at vertices (its derivatives by the vertex
    family ``inv_dx_v``/``inv_dy_v``, by default the center one)."""
    inv_dx_v = inv_dx if inv_dx_v is None else inv_dx_v
    inv_dy_v = inv_dy if inv_dy_v is None else inv_dy_v
    third = 1.0 / 3.0
    exx = (Vx[1:, 1:-1] - Vx[:-1, 1:-1]) * inv_dx - grad_V * third
    eyy = (Vy[1:-1, 1:] - Vy[1:-1, :-1]) * inv_dy - grad_V * third
    exy = 0.5 * ((Vx[:, 1:] - Vx[:, :-1]) * inv_dy_v + (Vy[1:, :] - Vy[:-1, :]) * inv_dx_v)
    return exx, eyy, exy


def compute_P(P, P0, grad_V, Q, eta, K, G, dt, r, theta_dtau, alpha_dT=None):
    """Compressible visco-elastic pressure update; returns (RP, P_new).
    ``K``/``G`` may be ∞ (incompressible / purely viscous). With
    ``alpha_dT = α·ΔT`` the thermal-stress source of Kiss et al. (2023) is
    added."""
    _Kdt = 1.0 / (K * dt)
    _Gdt = 1.0 / (G * dt)
    _dt = 1.0 / dt
    rhs = -grad_V + Q * _dt
    if alpha_dT is not None:
        rhs = rhs + alpha_dT * _dt
    RP = -(P - P0) * _Kdt + rhs
    psi = 1.0 / (1.0 / eta + _Gdt) * (r / theta_dtau)
    P_new = ((P0 * _Kdt + rhs) * psi + P) / (1.0 + _Kdt * psi)
    return RP, P_new


def _dtau_r(theta_dtau, eta, _Gdt):
    return 1.0 / (theta_dtau + eta * _Gdt + 1.0)


def _stress_increment(tau, tau_o, eta, eps, _Gdt, dtau_r):
    """dτ = dτ_r · (2η ε − (τ−τ_o)·η/(G dt) − τ)."""
    return dtau_r * (2.0 * eta * eps - (tau - tau_o) * eta * _Gdt - tau)


def compute_tau_visc(txx, tyy, txy, exx, eyy, exy, eta, theta_dtau):
    """Purely viscous PT stress update (the VE update with G = ∞)."""
    return compute_tau_ve(
        txx, tyy, txy, torch.zeros_like(txx), torch.zeros_like(tyy),
        torch.zeros_like(txy), exx, eyy, exy, eta,
        torch.full_like(eta, float("inf")), theta_dtau, 1.0,
    )


def compute_tau_ve(txx, tyy, txy, txx_o, tyy_o, txy_o, exx, eyy, exy, eta, G,
                   theta_dtau, dt, eta_v=None, G_v=None):
    """Visco-elastic PT stress update: normal components at centers, shear at
    vertices.

    Serial form (``eta_v``/``G_v`` omitted): shear on the interior vertices
    from arithmetic 4-cell averages of η and G; boundary vertices of τxy are
    left untouched.

    Distributed compute-in-halo form: ``eta_v``/``G_v`` at *every* local
    vertex (built from ghost-extended center fields, see
    ``parallel/stokes2d.py``) update every vertex of ``txy``; the caller
    freezes the physical-boundary rows (``_freeze_rows``), which gives the
    serial untouched-boundary result."""
    _Gdt = 1.0 / (G * dt)
    dtau_r = _dtau_r(theta_dtau, eta, _Gdt)
    txx = txx + _stress_increment(txx, txx_o, eta, exx, _Gdt, dtau_r)
    tyy = tyy + _stress_increment(tyy, tyy_o, eta, eyy, _Gdt, dtau_r)
    if eta_v is not None:
        _Gdt_v = 1.0 / (G_v * dt)
        dtau_r_v = _dtau_r(theta_dtau, eta_v, _Gdt_v)
        return txx, tyy, txy + _stress_increment(txy, txy_o, eta_v, exy, _Gdt_v, dtau_r_v)
    eta_vi = av_a(eta)
    _Gdt_v = 1.0 / (av_a(G) * dt)
    dtau_r_v = _dtau_r(theta_dtau, eta_vi, _Gdt_v)
    inc = _stress_increment(
        txy[1:-1, 1:-1], txy_o[1:-1, 1:-1], eta_vi, exy[1:-1, 1:-1], _Gdt_v, dtau_r_v
    )
    txy = txy + F.pad(inc, (1, 1, 1, 1))
    return txx, tyy, txy


def _x_momentum(P, txx, txy, rho_gx, inv_dx, inv_dy, inv_dx_v=None, inv_dy_c=None):
    """x-momentum balance on the interior x-faces (nx-1, ny). The τxx and P
    differences span adjacent centers (vertex family ``inv_dx_v``), the τxy
    ones adjacent vertices (center family ``inv_dy_c``); both default to the
    uniform ``inv_dx``/``inv_dy``. In the distributed compute-in-halo form
    (``parallel/stokes2d.py``) the center arrays arrive ghost-extended along
    x (nxl+2, nyl) beside the (nxl+1, nyl+1) local vertex block, and the
    balance lands on all local faces (nxl+1, nyl): the shapes select it."""
    inv_dx_v = inv_dx if inv_dx_v is None else inv_dx_v
    inv_dy_c = inv_dy if inv_dy_c is None else inv_dy_c
    txy_f = txy if txy.shape[0] == P.shape[0] - 1 else txy[1:-1, :]
    return (
        (txx[1:, :] - txx[:-1, :]) * inv_dx_v
        + (txy_f[:, 1:] - txy_f[:, :-1]) * inv_dy_c
        - (P[1:, :] - P[:-1, :]) * inv_dx_v
        - 0.5 * (rho_gx[1:, :] + rho_gx[:-1, :])
    )


def _y_momentum(P, tyy, txy, rho_gy, inv_dx, inv_dy, inv_dy_v=None, inv_dx_c=None):
    """y-momentum balance on the interior y-faces (nx, ny-1), or on all local
    faces in the ghost-extended form; the mirror of :func:`_x_momentum`."""
    inv_dy_v = inv_dy if inv_dy_v is None else inv_dy_v
    inv_dx_c = inv_dx if inv_dx_c is None else inv_dx_c
    txy_f = txy if txy.shape[1] == P.shape[1] - 1 else txy[:, 1:-1]
    return (
        (tyy[:, 1:] - tyy[:, :-1]) * inv_dy_v
        + (txy_f[1:, :] - txy_f[:-1, :]) * inv_dx_c
        - (P[:, 1:] - P[:, :-1]) * inv_dy_v
        - 0.5 * (rho_gy[:, 1:] + rho_gy[:, :-1])
    )


def _free_surface_correction(Vy, rho_gy, inv_dy, dt):
    """Vy·∂(ρg)/∂y·dt on the interior Vy nodes."""
    return Vy[1:-1, 1:-1] * ((rho_gy[:, 1:] - rho_gy[:, :-1]) * inv_dy) * dt


def _momentum(P, txx, tyy, txy, rho_gx, rho_gy, inv_dx, inv_dy, Vy, free_surface_dt,
              spacings):
    sx = (None, None) if spacings is None else spacings[:2]
    sy = (None, None) if spacings is None else spacings[2:]
    Rx = _x_momentum(P, txx, txy, rho_gx, inv_dx, inv_dy, *sx)
    Ry = _y_momentum(P, tyy, txy, rho_gy, inv_dx, inv_dy, *sy)
    if free_surface_dt is not None:
        fs_inv_dy = inv_dy if spacings is None else spacings[2]
        Ry = Ry + _free_surface_correction(Vy, rho_gy, fs_inv_dy, free_surface_dt)
    return Rx, Ry


def compute_V(Vx, Vy, P, txx, tyy, txy, etadtau, rho_gx, rho_gy, eta_tau,
              inv_dx, inv_dy, free_surface_dt: Optional[float] = None, spacings=None):
    """Damped velocity update on the interior faces. ``spacings`` is the
    nonuniform momentum bundle ``(inv_dx_v, inv_dy_c, inv_dy_v, inv_dx_c)``
    on the interior faces (``spacing_families_2d``); the free-surface
    correction's ∂(ρg)/∂y then takes ``inv_dy_v``, as ∂P/∂y does."""
    rx, ry = _momentum(P, txx, tyy, txy, rho_gx, rho_gy, inv_dx, inv_dy, Vy,
                       free_surface_dt, spacings)
    etax = 0.5 * (eta_tau[1:, :] + eta_tau[:-1, :])
    etay = 0.5 * (eta_tau[:, 1:] + eta_tau[:, :-1])
    Vx = Vx + F.pad(rx * etadtau / etax, (1, 1, 1, 1))
    Vy = Vy + F.pad(ry * etadtau / etay, (1, 1, 1, 1))
    return Vx, Vy


def compute_Res(P, txx, tyy, txy, rho_gx, rho_gy, inv_dx, inv_dy, Vy=None,
                free_surface_dt=None, spacings=None):
    """Momentum residuals Rx (nx-1, ny), Ry (nx, ny-1); ``spacings`` as in
    :func:`compute_V`."""
    return _momentum(P, txx, tyy, txy, rho_gx, rho_gy, inv_dx, inv_dy, Vy, free_surface_dt,
                     spacings)


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


def ve_iteration(Vx, Vy, P, txx, tyy, txy, eta, eta_tau, rho_gx, rho_gy, G, K,
                 P0, Q, tau_o, dt, inv_dx, inv_dy, r, theta_dtau, etadtau,
                 flow_bc=None, free_surface_dt=None, alpha_dT=None, strain_v=None,
                 spacings=None):
    """One VE PT iteration of ``solve_ve``'s array path: divergence →
    pressure (ψ from ``eta_tau``) → strain rate → VE stress → damped
    velocity update → velocity BCs (none when ``flow_bc`` is ``None``).
    ``strain_v`` and ``spacings`` are a nonuniform grid's vertex family and
    momentum bundle (``spacing_families_2d``). Returns (Vx, Vy, P, τxx, τyy,
    τxy)."""
    grad_V = compute_grad_V(Vx, Vy, inv_dx, inv_dy)
    _, P = compute_P(P, P0, grad_V, Q, eta_tau, K, G, dt, r, theta_dtau,
                     alpha_dT=alpha_dT)
    exx, eyy, exy = compute_strain_rate(grad_V, Vx, Vy, inv_dx, inv_dy, **(strain_v or {}))
    txx, tyy, txy = compute_tau_ve(txx, tyy, txy, *tau_o, exx, eyy, exy, eta, G,
                                   theta_dtau, dt)
    Vx, Vy = compute_V(Vx, Vy, P, txx, tyy, txy, etadtau, rho_gx, rho_gy, eta_tau,
                       inv_dx, inv_dy, free_surface_dt=free_surface_dt, spacings=spacings)
    if flow_bc is not None:
        Vx, Vy = flow_bcs((Vx, Vy), flow_bc)
    return Vx, Vy, P, txx, tyy, txy
