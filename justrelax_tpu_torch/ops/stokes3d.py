"""Stokes stencil functions, 3D: divergence, strain rate, VE stress, damped
velocity update with the momentum residuals, and the staggered second
invariant.

Counterpart of ``justrelax_tpu/ops/stokes3d.py``, with the same staggered
shapes (``core/state.py``); axis order (x, y, z). A ``NonuniformGeometry``
passes its spacing families as broadcastable tensors
(``spacing_families_3d``). Shear
components live on cell edges: εyz/τyz ``(nx, ny+1, nz+1)``, εxz/τxz
``(nx+1, ny, nz+1)``, εxy/τxy ``(nx+1, ny+1, nz)``. The pressure update is
the 2D one, ``ops/stokes.py::compute_P``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from justrelax_tpu_torch.core.grid import spacing_tensors
from justrelax_tpu_torch.ops.stencil import expand_edges

__all__ = [
    "compute_grad_V_3d",
    "compute_strain_rate_3d",
    "compute_tau_ve_3d",
    "compute_V_3d",
    "momentum_families_3d",
    "momentum_residuals_3d",
    "spacing_families_3d",
    "tensor_invariant_staggered_3d",
]


def spacing_families_3d(geometry, like):
    """``(inv_di, inv_di_v, mom_spacings)`` for the 3D functions. On a
    uniform grid: the scalar reciprocals, ``None`` and ``None``. On a
    ``NonuniformGeometry``: per axis, broadcastable reciprocals of the
    center family (cell widths: divergence and normal strain rates), of the
    vertex family (center-to-center distances, boundary-clamped: the edge
    shear strain rates), and the momentum bundle ``(inv_dv_in, inv_dc)`` of
    :func:`compute_V_3d` (the vertex family on the interior faces of each
    component's own axis, and the center family). They are views of
    ``core/grid.py::spacing_tensors``, in ``like``'s dtype and on its
    device."""
    tensors = spacing_tensors(geometry, like)
    if tensors is None:
        return tuple(1.0 / d for d in geometry.di), None, None
    inv_dv, inv_dc = tensors
    inv_dv_in = tuple(v.narrow(d, 1, v.shape[d] - 2) for d, v in enumerate(inv_dv))
    return inv_dc, inv_dv, (inv_dv_in, inv_dc)


def compute_grad_V_3d(Vx, Vy, Vz, inv_di):
    """∇·V at cell centers."""
    return (
        (Vx[1:, 1:-1, 1:-1] - Vx[:-1, 1:-1, 1:-1]) * inv_di[0]
        + (Vy[1:-1, 1:, 1:-1] - Vy[1:-1, :-1, 1:-1]) * inv_di[1]
        + (Vz[1:-1, 1:-1, 1:] - Vz[1:-1, 1:-1, :-1]) * inv_di[2]
    )


def compute_strain_rate_3d(grad_V, Vx, Vy, Vz, inv_di, inv_di_v=None):
    """Deviatoric strain rate (εxx, εyy, εzz, εyz, εxz, εxy): normal at
    centers, shear on all edges. ``inv_di_v`` (the vertex spacing family)
    defaults to ``inv_di``."""
    _dx, _dy, _dz = inv_di
    _dxv, _dyv, _dzv = inv_di if inv_di_v is None else inv_di_v
    third = 1.0 / 3.0
    exx = (Vx[1:, 1:-1, 1:-1] - Vx[:-1, 1:-1, 1:-1]) * _dx - grad_V * third
    eyy = (Vy[1:-1, 1:, 1:-1] - Vy[1:-1, :-1, 1:-1]) * _dy - grad_V * third
    ezz = (Vz[1:-1, 1:-1, 1:] - Vz[1:-1, 1:-1, :-1]) * _dz - grad_V * third
    eyz = 0.5 * (
        (Vy[1:-1, :, 1:] - Vy[1:-1, :, :-1]) * _dzv
        + (Vz[1:-1, 1:, :] - Vz[1:-1, :-1, :]) * _dyv
    )
    exz = 0.5 * (
        (Vx[:, 1:-1, 1:] - Vx[:, 1:-1, :-1]) * _dzv
        + (Vz[1:, 1:-1, :] - Vz[:-1, 1:-1, :]) * _dxv
    )
    exy = 0.5 * (
        (Vx[:, 1:, 1:-1] - Vx[:, :-1, 1:-1]) * _dyv
        + (Vy[1:, :, 1:-1] - Vy[:-1, :, 1:-1]) * _dxv
    )
    return exx, eyy, ezz, eyz, exz, exy


def _av_edge_xy(A):
    """Centers → interior xy-edges (nx-1, ny-1, nz)."""
    return 0.25 * (A[:-1, :-1, :] + A[1:, :-1, :] + A[:-1, 1:, :] + A[1:, 1:, :])


def _av_edge_xz(A):
    return 0.25 * (A[:-1, :, :-1] + A[1:, :, :-1] + A[:-1, :, 1:] + A[1:, :, 1:])


def _av_edge_yz(A):
    return 0.25 * (A[:, :-1, :-1] + A[:, 1:, :-1] + A[:, :-1, 1:] + A[:, 1:, 1:])


def _dtau_r(theta_dtau, eta, _Gdt):
    return 1.0 / (theta_dtau + eta * _Gdt + 1.0)


def _inc(tau, tau_o, eta, eps, _Gdt, dtau_r):
    return dtau_r * (2.0 * eta * eps - (tau - tau_o) * eta * _Gdt - tau)


def _pad_edge2(A, ax0, ax1):
    """``A`` with one edge-replicated layer on both sides of two axes."""
    sl = [slice(1, -1)] * 3
    sl[ax0] = sl[ax1] = slice(None)
    return expand_edges(A)[tuple(sl)]


def _pad2(A, ax0, ax1):
    """Zero-pad one layer on both sides of two axes."""
    pads = [0] * 6
    for ax in (ax0, ax1):
        pads[2 * (2 - ax)] = pads[2 * (2 - ax) + 1] = 1
    return F.pad(A, pads)


def compute_tau_ve_3d(tau, tau_o, eps, eta, G, theta_dtau, dt, boundary_shear=False):
    """VE PT stress update. ``tau``/``tau_o``/``eps`` are 6-tuples (xx, yy,
    zz, yz, xz, xy).

    With ``boundary_shear=False`` the shear components update on interior
    edges only (boundary edges keep their value, right for free slip where
    the boundary shear stress is 0). With ``True`` every edge updates, with
    η and G averaged from the edge-clamped cells, as Dirichlet-velocity
    problems (Burstedde, Taylor-Green) need."""
    txx, tyy, tzz, tyz, txz, txy = tau
    txx_o, tyy_o, tzz_o, tyz_o, txz_o, txy_o = tau_o
    exx, eyy, ezz, eyz, exz, exy = eps

    _Gdt = 1.0 / (G * dt)
    dr = _dtau_r(theta_dtau, eta, _Gdt)
    txx = txx + _inc(txx, txx_o, eta, exx, _Gdt, dr)
    tyy = tyy + _inc(tyy, tyy_o, eta, eyy, _Gdt, dr)
    tzz = tzz + _inc(tzz, tzz_o, eta, ezz, _Gdt, dr)

    if boundary_shear:
        def upd(t, t_o, e, av, ax0, ax1):
            eta_e = av(_pad_edge2(eta, ax0, ax1))
            G_e = av(_pad_edge2(G, ax0, ax1))
            _G_e = 1.0 / (G_e * dt)
            dr_e = _dtau_r(theta_dtau, eta_e, _G_e)
            return t + _inc(t, t_o, eta_e, e, _G_e, dr_e)

        txy = upd(txy, txy_o, exy, _av_edge_xy, 0, 1)
        txz = upd(txz, txz_o, exz, _av_edge_xz, 0, 2)
        tyz = upd(tyz, tyz_o, eyz, _av_edge_yz, 1, 2)
        return txx, tyy, tzz, tyz, txz, txy

    eta_xy, G_xy = _av_edge_xy(eta), _av_edge_xy(G)
    _G_xy = 1.0 / (G_xy * dt)
    dr_xy = _dtau_r(theta_dtau, eta_xy, _G_xy)
    txy = txy + _pad2(
        _inc(txy[1:-1, 1:-1, :], txy_o[1:-1, 1:-1, :], eta_xy, exy[1:-1, 1:-1, :], _G_xy, dr_xy),
        0, 1,
    )
    eta_xz, G_xz = _av_edge_xz(eta), _av_edge_xz(G)
    _G_xz = 1.0 / (G_xz * dt)
    dr_xz = _dtau_r(theta_dtau, eta_xz, _G_xz)
    txz = txz + _pad2(
        _inc(txz[1:-1, :, 1:-1], txz_o[1:-1, :, 1:-1], eta_xz, exz[1:-1, :, 1:-1], _G_xz, dr_xz),
        0, 2,
    )
    eta_yz, G_yz = _av_edge_yz(eta), _av_edge_yz(G)
    _G_yz = 1.0 / (G_yz * dt)
    dr_yz = _dtau_r(theta_dtau, eta_yz, _G_yz)
    tyz = tyz + _pad2(
        _inc(tyz[:, 1:-1, 1:-1], tyz_o[:, 1:-1, 1:-1], eta_yz, eyz[:, 1:-1, 1:-1], _G_yz, dr_yz),
        1, 2,
    )
    return txx, tyy, tzz, tyz, txz, txy


def momentum_families_3d(inv_di, spacings=None):
    """``((∂x, ∂y, ∂z) center family, (∂x, ∂y, ∂z) interior vertex family)``
    of the momentum residuals: the normal-stress and pressure gradients of
    a component's own axis span adjacent centers (vertex family), the
    shear-stress gradients adjacent edges (center family). Both are
    ``inv_di`` on a uniform grid (``spacings`` ``None``)."""
    if spacings is None:
        return tuple(inv_di), tuple(inv_di)
    inv_dv_in, inv_dc = spacings
    return tuple(inv_dc), tuple(inv_dv_in)


def momentum_residuals_3d(P, tau, fx, fy, fz, inv_di, spacings=None):
    """Momentum residuals Rx (nx-1, ny, nz), Ry (nx, ny-1, nz) and Rz (nx,
    ny, nz-1) on the interior faces: ∇·τ − ∇P − ρg. ``spacings`` is the
    nonuniform momentum bundle (``spacing_families_3d``)."""
    (_dx, _dy, _dz), (_dxv, _dyv, _dzv) = momentum_families_3d(inv_di, spacings)
    txx, tyy, tzz, tyz, txz, txy = tau
    Rx = (
        (txx[1:, :, :] - txx[:-1, :, :]) * _dxv
        + (txy[1:-1, 1:, :] - txy[1:-1, :-1, :]) * _dy
        + (txz[1:-1, :, 1:] - txz[1:-1, :, :-1]) * _dz
        - (P[1:, :, :] - P[:-1, :, :]) * _dxv
        - 0.5 * (fx[1:, :, :] + fx[:-1, :, :])
    )
    Ry = (
        (txy[1:, 1:-1, :] - txy[:-1, 1:-1, :]) * _dx
        + (tyy[:, 1:, :] - tyy[:, :-1, :]) * _dyv
        + (tyz[:, 1:-1, 1:] - tyz[:, 1:-1, :-1]) * _dz
        - (P[:, 1:, :] - P[:, :-1, :]) * _dyv
        - 0.5 * (fy[:, 1:, :] + fy[:, :-1, :])
    )
    Rz = (
        (txz[1:, :, 1:-1] - txz[:-1, :, 1:-1]) * _dx
        + (tyz[:, 1:, 1:-1] - tyz[:, :-1, 1:-1]) * _dy
        + (tzz[:, :, 1:] - tzz[:, :, :-1]) * _dzv
        - (P[:, :, 1:] - P[:, :, :-1]) * _dzv
        - 0.5 * (fz[:, :, 1:] + fz[:, :, :-1])
    )
    return Rx, Ry, Rz


def compute_V_3d(Vx, Vy, Vz, P, tau, fx, fy, fz, eta_tau, etadtau, inv_di,
                 spacings=None):
    """Fused residual and damped velocity update on the interior faces.
    ``spacings`` is the nonuniform momentum bundle ``(inv_dv_in, inv_dc)``
    of ``spacing_families_3d``. Returns (Vx, Vy, Vz, Rx, Ry, Rz)."""
    Rx, Ry, Rz = momentum_residuals_3d(P, tau, fx, fy, fz, inv_di, spacings)
    etax = 0.5 * (eta_tau[1:, :, :] + eta_tau[:-1, :, :])
    etay = 0.5 * (eta_tau[:, 1:, :] + eta_tau[:, :-1, :])
    etaz = 0.5 * (eta_tau[:, :, 1:] + eta_tau[:, :, :-1])
    p1 = (1, 1) * 3
    Vx = Vx + F.pad(Rx * etadtau / etax, p1)
    Vy = Vy + F.pad(Ry * etadtau / etay, p1)
    Vz = Vz + F.pad(Rz * etadtau / etaz, p1)
    return Vx, Vy, Vz, Rx, Ry, Rz


def tensor_invariant_staggered_3d(xx, yy, zz, yz, xz, xy):
    """Second invariant at centers: the normal terms pointwise, each shear
    term the mean of the squared four surrounding edge values."""
    yz2 = 0.25 * (yz[:, :-1, :-1] ** 2 + yz[:, 1:, :-1] ** 2 + yz[:, :-1, 1:] ** 2 + yz[:, 1:, 1:] ** 2)
    xz2 = 0.25 * (xz[:-1, :, :-1] ** 2 + xz[1:, :, :-1] ** 2 + xz[:-1, :, 1:] ** 2 + xz[1:, :, 1:] ** 2)
    xy2 = 0.25 * (xy[:-1, :-1, :] ** 2 + xy[1:, :-1, :] ** 2 + xy[:-1, 1:, :] ** 2 + xy[1:, 1:, :] ** 2)
    return (0.5 * (xx**2 + yy**2 + zz**2) + yz2 + xz2 + xy2).sqrt()
