"""Collocated-canvas form of the 3D VE Stokes iteration: the contract of the
3D VE chunk kernel (``ops/hopper_stokes3d.py``) and its plain version.

Counterpart of the parts of ``justrelax_tpu/ops/stokes3d_canvas.py`` that the
kernel's contract needs. Every field is embedded in one (nx+2, ny+2, nz+2)
canvas, so one index (a, b, c) serves all ten unknowns:

  cell (i,j,k)        -> (i+1, j+1, k+1)   P, τxx, τyy, τzz + cell coeffs
  Vx face i           -> a=i   (b=j+1, c=k+1; transverse ghosts included)
  Vy face j           -> b=j   (a=i+1, c=k+1)
  Vz face k           -> c=k   (a=i+1, b=j+1)
  τyz edge (i,j,k)    -> (i+1, j,   k)
  τxz edge (i,j,k)    -> (i,   j+1, k)
  τxy edge (i,j,k)    -> (i,   j,   k+1)

VE/compressible physics enters through chunk-invariant coefficients:

    P   <- P*c1 + c2 - grad_V*c3
    tau <- a*tau + b*eps + d        (per cell and per edge family;
                                     d folds eta*_Gdt*tau_o)

with the viscous incompressible limit c1 = 1, c2 = 0, c3 = ψ, a = 1 − dτ_r
(a scalar), b = 2η·dτ_r, d = 0; coefficients that are absent (``None``) are
left out of the expression, and any coefficient may be a scalar in place of
a canvas that holds one value. The JAX iteration shifts with ``jnp.roll`` and
selects with iota band masks; here each update is a slice assignment on the
same slots, and the slots the masks leave alone keep their values. The TPU
lowering choices (the "slice"/"roll" shift, ``x_off``/``y_off`` windows, the
lean constants of ``stokes3d_chunk_canvas_lean``) are not ported.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F

from justrelax_tpu_torch.ops.stencil import expand_edges

Tensor = Any

__all__ = [
    "CanvasCoeffs3D",
    "ve3d_canvas_coefficients",
    "viscous_canvas_coefficients",
    "iteration3d_canvas",
    "stokes3d_chunk_canvas",
    "pack_carry",
    "unpack_carry",
]

_P1 = (1, 1) * 3


def pack_carry(Vx, Vy, Vz, P, txx, tyy, tzz, tyz, txz, txy):
    """Staggered arrays → stacked carry canvas (10, nx+2, ny+2, nz+2), the
    slots no field owns set to 0."""
    return torch.stack([
        F.pad(Vx, (0, 0, 0, 0, 0, 1)),
        F.pad(Vy, (0, 0, 0, 1, 0, 0)),
        F.pad(Vz, (0, 1, 0, 0, 0, 0)),
        F.pad(P, _P1),
        F.pad(txx, _P1),
        F.pad(tyy, _P1),
        F.pad(tzz, _P1),
        F.pad(tyz, (0, 1, 0, 1, 1, 1)),
        F.pad(txz, (0, 1, 1, 1, 0, 1)),
        F.pad(txy, (1, 1, 0, 1, 0, 1)),
    ])


def unpack_carry(C, nx, ny, nz):
    """Inverse of :func:`pack_carry` (views of ``C``)."""
    return (
        C[0][:-1, :, :],                # Vx (nx+1, ny+2, nz+2)
        C[1][:, :-1, :],                # Vy
        C[2][:, :, :-1],                # Vz
        C[3][1:-1, 1:-1, 1:-1],         # P
        C[4][1:-1, 1:-1, 1:-1],
        C[5][1:-1, 1:-1, 1:-1],
        C[6][1:-1, 1:-1, 1:-1],
        C[7][1:-1, :-1, :-1],           # tyz (nx, ny+1, nz+1)
        C[8][:-1, 1:-1, :-1],           # txz
        C[9][:-1, :-1, 1:-1],           # txy
    )


class CanvasCoeffs3D(NamedTuple):
    """Chunk-invariant coefficient canvases (None ⇒ statically absent)."""

    c1: Optional[Tensor]          # pressure decay (None ⇒ 1, incompressible)
    c2: Optional[Tensor]          # pressure source (None ⇒ 0)
    c3: Tensor                    # pressure relaxation ψ·c1
    a_c: Any                      # normal-stress decay (scalar in viscous limit)
    b_c: Tensor                   # 2η·dτ_r at cells
    d_c: Optional[tuple]          # (dxx, dyy, dzz) elastic memory (None ⇒ 0)
    a_e: tuple                    # edge-family decay (yz, xz, xy)
    b_e: tuple                    # edge-family 2η_e·dτ_r
    d_e: Optional[tuple]          # edge elastic memory
    inv_eta: tuple                # ηdτ / face-averaged ητ (x, y, z)
    f: tuple                      # face-averaged body forces (x, y, z)


def _sm1(A, ax):
    """``A`` shifted by −1 along ``ax`` (``A[k+1]`` at ``k``, wrapping)."""
    return torch.roll(A, -1, dims=ax)


def _sp1(A, ax):
    """``A`` shifted by +1 along ``ax`` (``A[k-1]`` at ``k``, wrapping)."""
    return torch.roll(A, 1, dims=ax)


def _band(shape, axis, lo, hi, device=None):
    """Boolean mask of ``shape`` that holds where the index along ``axis``
    lies in [lo, hi], broadcastable (size 1 on the other axes)."""
    i = torch.arange(shape[axis], device=device)
    view = [1] * len(shape)
    view[axis] = shape[axis]
    return ((i >= lo) & (i <= hi)).reshape(view)


def _edge_avg(C, ax0, ax1):
    """Cell canvas -> edge-collocated 4-point average (values land at the
    (ax0, ax1)-decremented canvas slots)."""
    e = 0.5 * (C + _sm1(C, ax0))
    return 0.5 * (e + _sm1(e, ax1))


# edge collocations: τyz at (i+1, j, k) averages cells (j, j+1)×(k, k+1)
# → roll axes (1, 2); τxz → (0, 2); τxy → (0, 1)
_EDGE_AXES = ((1, 2), (0, 2), (0, 1))


def _face_coefficients(etat_c, f_cells, etadtau):
    """``inv_eta`` and ``f`` from the edge-padded ητ and body-force cell
    canvases."""
    inv_eta = tuple(etadtau / (0.5 * (etat_c + _sm1(etat_c, ax))) for ax in range(3))
    f = tuple(0.5 * (c + _sm1(c, ax)) for ax, c in enumerate(f_cells))
    return inv_eta, f


def ve3d_canvas_coefficients(
    eta, eta_tau, r, theta_dtau, etadtau,
    fx=None, fy=None, fz=None,
    G=None, K=None, P0=None, Q=None, tau_o=None, dt=None,
    psi_eta=None,
) -> CanvasCoeffs3D:
    """Build the coefficient canvases from (nx, ny, nz) cell fields.

    ``G=None`` selects the viscous incompressible limit, with the trivial
    coefficients left out (``c1 = c2 = d_c = d_e = None``, scalar ``a_c`` and
    ``a_e``). Otherwise the general VE/compressible form: 23 canvases, ``K``,
    ``dt`` of ∞ (or None) the incompressible and viscous limits. ``psi_eta``
    is the viscosity in the pressure relaxation ψ (default ``eta_tau``;
    ``solve_ve_3d`` passes ``eta``, as its ``compute_P`` call does).
    """
    ni = tuple(eta.shape)
    kw = dict(dtype=eta.dtype, device=eta.device)
    zero = torch.zeros(ni, **kw)
    fx = zero if fx is None else fx
    fy = zero if fy is None else fy
    fz = zero if fz is None else fz
    etat_c = expand_edges(eta_tau)
    eta_c = expand_edges(eta)
    inv_eta, f = _face_coefficients(
        etat_c, tuple(expand_edges(c) for c in (fx, fy, fz)), etadtau)

    if psi_eta is None:
        psi_eta = eta_tau
    if G is None:
        dtau_r = 1.0 / (theta_dtau + 1.0)
        a_c = 1.0 - dtau_r
        b_c = expand_edges(2.0 * eta * dtau_r)
        b_e = tuple(2.0 * _edge_avg(eta_c, *ax) * dtau_r for ax in _EDGE_AXES)
        if K is not None or P0 is not None or Q is not None:
            raise ValueError("compressible sources require G (use G=∞ array)")
        c3 = expand_edges(psi_eta * (r / theta_dtau))
        return CanvasCoeffs3D(None, None, c3, a_c, b_c, None, (a_c, a_c, a_c), b_e,
                              None, inv_eta, f)

    # general VE / compressible form
    if dt is None:
        dt = math.inf
    G = torch.as_tensor(G, **kw).expand(ni)
    K = torch.full(ni, math.inf, **kw) if K is None else K
    P0 = zero if P0 is None else P0
    Q = zero if Q is None else Q
    if tau_o is None:
        tau_o = (zero, zero, zero,
                 torch.zeros((ni[0], ni[1] + 1, ni[2] + 1), **kw),
                 torch.zeros((ni[0] + 1, ni[1], ni[2] + 1), **kw),
                 torch.zeros((ni[0] + 1, ni[1] + 1, ni[2]), **kw))
    txx_o, tyy_o, tzz_o, tyz_o, txz_o, txy_o = tau_o

    _Gdt = 1.0 / (G * dt)
    _Kdt = 1.0 / (K * dt)
    if isinstance(dt, torch.Tensor):
        inv_dt = torch.where(torch.isinf(dt), 0.0, 1.0 / dt)
    else:
        inv_dt = 0.0 if math.isinf(dt) else 1.0 / dt
    psi = 1.0 / (1.0 / psi_eta + _Gdt) * (r / theta_dtau)
    c1v = 1.0 / (1.0 + _Kdt * psi)
    c2v = (P0 * _Kdt + Q * inv_dt) * psi * c1v
    c3 = expand_edges(psi * c1v)
    c1 = expand_edges(c1v)
    c2 = F.pad(c2v, _P1)
    dtau_r_c = 1.0 / (theta_dtau + eta * _Gdt + 1.0)
    a_c = expand_edges(1.0 - dtau_r_c * (1.0 + eta * _Gdt))
    b_c = expand_edges(2.0 * eta * dtau_r_c)
    coef = dtau_r_c * eta * _Gdt
    d_c = (F.pad(coef * txx_o, _P1), F.pad(coef * tyy_o, _P1), F.pad(coef * tzz_o, _P1))

    G_c = expand_edges(G)
    # interior-edge τ_o embedded at their canvas slots (zero elsewhere; the
    # boundary-edge rows are masked off in the iteration anyway)
    to_c = (F.pad(tyz_o, (0, 1, 0, 1, 1, 1)),
            F.pad(txz_o, (0, 1, 1, 1, 0, 1)),
            F.pad(txy_o, (1, 1, 0, 1, 0, 1)))
    a_e, b_e, d_e = [], [], []
    for (ax0, ax1), t_c in zip(_EDGE_AXES, to_c):
        eta_e = _edge_avg(eta_c, ax0, ax1)
        _Gdt_e = 1.0 / (_edge_avg(G_c, ax0, ax1) * dt)
        dr_e = 1.0 / (theta_dtau + eta_e * _Gdt_e + 1.0)
        a_e.append(1.0 - dr_e * (1.0 + eta_e * _Gdt_e))
        b_e.append(2.0 * eta_e * dr_e)
        d_e.append(dr_e * eta_e * _Gdt_e * t_c)
    return CanvasCoeffs3D(c1, c2, c3, a_c, b_c, d_c, tuple(a_e), tuple(b_e), tuple(d_e),
                          inv_eta, f)


def viscous_canvas_coefficients(viscous_consts, pt_scalars) -> CanvasCoeffs3D:
    """The viscous-limit coefficients of the chunk's ``viscous_consts`` route
    from (η, ητ, fx, fy, fz) cell fields and ``pt_scalars`` = (r/θ_dτ, θ_dτ,
    ηdτ), in the operation order of the TPU kernel's in-kernel derivation
    (``justrelax_tpu/ops/pallas_stokes3d_blocked.py:243-271``): ψ comes from
    ητ, and 2·dτ_r multiplies η from the left."""
    eta_w, etat_w, *f_cells = (expand_edges(a) for a in viscous_consts)
    r_theta, theta_dtau, etadtau = pt_scalars
    dtau_r = 1.0 / (theta_dtau + 1.0)
    inv_eta, f = _face_coefficients(etat_w, f_cells, etadtau)
    return CanvasCoeffs3D(
        c1=None, c2=None, c3=etat_w * r_theta,
        a_c=1.0 - dtau_r, b_c=2.0 * dtau_r * eta_w, d_c=None,
        a_e=(1.0 - dtau_r,) * 3,
        b_e=tuple(2.0 * dtau_r * _edge_avg(eta_w, *ax) for ax in _EDGE_AXES),
        d_e=None, inv_eta=inv_eta, f=f,
    )


def _at(c, sl):
    """A coefficient at the slots ``sl``: a canvas is sliced, a scalar
    stays."""
    return c[sl] if isinstance(c, torch.Tensor) and c.ndim == 3 else c


def iteration3d_canvas(carry, co: CanvasCoeffs3D, inv_di, *, nx, ny, nz,
                       free_slip=True):
    """One fused 3D VE PT iteration on the 10 collocated canvases; returns
    new canvases.

    Equivalent to compute_grad_V_3d → compute_P → compute_strain_rate_3d →
    compute_tau_ve_3d → compute_V_3d → flow_bcs(free-slip) on the staggered
    arrays (ops/stokes3d.py): the pressure and normal stresses update on the
    cells, the shear stresses on the interior edges, both from the old
    velocities; the velocities on the interior faces from the new P and τ;
    then, with ``free_slip``, the tangential ghosts mirror in the order
    front, back, top, bot, left, right.
    """
    Vx, Vy, Vz, P, txx, tyy, tzz, tyz, txz, txy = (t.clone() for t in carry)
    inv_dx, inv_dy, inv_dz = inv_di
    third = 1.0 / 3.0

    def s(lo, hi):
        return slice(lo, hi + 1)

    # cells: a in [1, nx], b in [1, ny], c in [1, nz]
    C = (s(1, nx), s(1, ny), s(1, nz))
    dVxdx = (Vx[C] - Vx[s(0, nx - 1), s(1, ny), s(1, nz)]) * inv_dx
    dVydy = (Vy[C] - Vy[s(1, nx), s(0, ny - 1), s(1, nz)]) * inv_dy
    dVzdz = (Vz[C] - Vz[s(1, nx), s(1, ny), s(0, nz - 1)]) * inv_dz
    grad_V = dVxdx + dVydy + dVzdz
    P_new = P[C] if co.c1 is None else P[C] * _at(co.c1, C)
    if co.c2 is not None:
        P_new = P_new + _at(co.c2, C)
    P[C] = P_new - grad_V * _at(co.c3, C)

    dxx, dyy, dzz = co.d_c if co.d_c is not None else (None, None, None)
    for t, e, d in ((txx, dVxdx, dxx), (tyy, dVydy, dyy), (tzz, dVzdz, dzz)):
        t_new = _at(co.a_c, C) * t[C] + _at(co.b_c, C) * (e - grad_V * third)
        t[C] = t_new if d is None else t_new + _at(d, C)

    # shear strain + stress on the interior edges
    def upd_e(t, e, i, sl):
        t_new = _at(co.a_e[i], sl) * t[sl] + _at(co.b_e[i], sl) * e
        d = None if co.d_e is None else co.d_e[i]
        t[sl] = t_new if d is None else t_new + _at(d, sl)

    E = (s(1, nx), s(1, ny - 1), s(1, nz - 1))
    eyz = 0.5 * ((Vy[s(1, nx), s(1, ny - 1), s(2, nz)] - Vy[E]) * inv_dz
                 + (Vz[s(1, nx), s(2, ny), s(1, nz - 1)] - Vz[E]) * inv_dy)
    upd_e(tyz, eyz, 0, E)
    E = (s(1, nx - 1), s(1, ny), s(1, nz - 1))
    exz = 0.5 * ((Vx[s(1, nx - 1), s(1, ny), s(2, nz)] - Vx[E]) * inv_dz
                 + (Vz[s(2, nx), s(1, ny), s(1, nz - 1)] - Vz[E]) * inv_dx)
    upd_e(txz, exz, 1, E)
    E = (s(1, nx - 1), s(1, ny - 1), s(1, nz))
    exy = 0.5 * ((Vx[s(1, nx - 1), s(2, ny), s(1, nz)] - Vx[E]) * inv_dy
                 + (Vy[s(2, nx), s(1, ny - 1), s(1, nz)] - Vy[E]) * inv_dx)
    upd_e(txy, exy, 2, E)

    # damped velocity update on the interior faces
    Fx = (s(1, nx - 1), s(1, ny), s(1, nz))
    rx = (
        (txx[s(2, nx), s(1, ny), s(1, nz)] - txx[Fx]) * inv_dx
        + (txy[Fx] - txy[s(1, nx - 1), s(0, ny - 1), s(1, nz)]) * inv_dy
        + (txz[Fx] - txz[s(1, nx - 1), s(1, ny), s(0, nz - 1)]) * inv_dz
        - (P[s(2, nx), s(1, ny), s(1, nz)] - P[Fx]) * inv_dx
        - _at(co.f[0], Fx)
    )
    Vx[Fx] = Vx[Fx] + rx * _at(co.inv_eta[0], Fx)
    Fy = (s(1, nx), s(1, ny - 1), s(1, nz))
    ry = (
        (txy[Fy] - txy[s(0, nx - 1), s(1, ny - 1), s(1, nz)]) * inv_dx
        + (tyy[s(1, nx), s(2, ny), s(1, nz)] - tyy[Fy]) * inv_dy
        + (tyz[Fy] - tyz[s(1, nx), s(1, ny - 1), s(0, nz - 1)]) * inv_dz
        - (P[s(1, nx), s(2, ny), s(1, nz)] - P[Fy]) * inv_dy
        - _at(co.f[1], Fy)
    )
    Vy[Fy] = Vy[Fy] + ry * _at(co.inv_eta[1], Fy)
    Fz = (s(1, nx), s(1, ny), s(1, nz - 1))
    rz = (
        (txz[Fz] - txz[s(0, nx - 1), s(1, ny), s(1, nz - 1)]) * inv_dx
        + (tyz[Fz] - tyz[s(1, nx), s(0, ny - 1), s(1, nz - 1)]) * inv_dy
        + (tzz[s(1, nx), s(1, ny), s(2, nz)] - tzz[Fz]) * inv_dz
        - (P[s(1, nx), s(1, ny), s(2, nz)] - P[Fz]) * inv_dz
        - _at(co.f[2], Fz)
    )
    Vz[Fz] = Vz[Fz] + rz * _at(co.inv_eta[2], Fz)

    if free_slip:
        # tangential mirrors on every row: front, back, top, bot, left, right
        for A in (Vx, Vz):
            A[:, 0, :] = A[:, 1, :]
        for A in (Vx, Vz):
            A[:, ny + 1, :] = A[:, ny, :]
        for A in (Vx, Vy):
            A[:, :, 0] = A[:, :, 1]
        for A in (Vx, Vy):
            A[:, :, nz + 1] = A[:, :, nz]
        for A in (Vy, Vz):
            A[0] = A[1]
        for A in (Vy, Vz):
            A[nx + 1] = A[nx]
    return (Vx, Vy, Vz, P, txx, tyy, tzz, tyz, txz, txy)


def stokes3d_chunk_canvas(carry, co: CanvasCoeffs3D, inv_di, nout, *, free_slip=True):
    """Advance ``nout`` fused canvas iterations. ``carry`` is the tuple of
    10 canvases (``pack_carry`` layout unstacked)."""
    X, Y, Z = carry[3].shape
    carry = tuple(carry)
    for _ in range(int(nout)):
        carry = iteration3d_canvas(carry, co, inv_di, nx=X - 2, ny=Y - 2, nz=Z - 2,
                                   free_slip=free_slip)
    return carry
