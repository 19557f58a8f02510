"""Explicit thermal diffusion with upwind advection (1D/2D/3D) and the 1D
accelerated-PT diffusion solve.

Counterpart of ``justrelax_tpu/solvers/thermal_explicit.py``:
``ThermalParameters(K, ρCp)`` holds κ = K/ρCp; a forward-Euler step takes
face-averaged κ fluxes of the ghosted T, their divergence and optionally
the first-order upwind advection by cell-centered velocities, then applies
the thermal BCs. The time loops are Python loops; ``solve_pt_1d`` reads its
residual on the host once per chunk of ``nout`` iterations. On a
``NonuniformGeometry`` the fluxes and the upwind differences take the face
spacings, the divergence the cell widths.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from justrelax_tpu_torch.ops.bc import Faces, TemperatureBoundaryConditions, thermal_bcs
from justrelax_tpu_torch.ops.thermal import thermal_spacings

__all__ = [
    "ThermalParameters",
    "stable_dt_explicit",
    "explicit_diffusion_step",
    "solve_explicit",
    "solve_pt_1d",
]


class ThermalParameters(NamedTuple):
    """κ = K/ρCp at cell centers."""

    kappa: torch.Tensor

    @classmethod
    def make(cls, K, rhoCp) -> "ThermalParameters":
        return cls(kappa=K / rhoCp)


def stable_dt_explicit(params: ThermalParameters, di: Tuple[float, ...]) -> float:
    """Forward-Euler stability bound dt ≤ min(di)²/κ_max/(2.1·ndim)."""
    ndim = params.kappa.ndim
    return float(min(di)) ** 2 / float(torch.max(params.kappa)) / (2.1 * ndim)


def _edge_pad(A, axis: int):
    """``A`` padded by one edge-replicated slab at both ends of ``axis``."""
    lo = A.narrow(axis, 0, 1)
    hi = A.narrow(axis, A.shape[axis] - 1, 1)
    return torch.cat([lo, A, hi], dim=axis)


def _sl(ndim, axis, sl, other=slice(None)):
    return tuple(sl if a == axis else other for a in range(ndim))


def _face_kappa(kappa):
    """Arithmetic face averages of κ, edge-replicated at the domain faces."""
    out = []
    for axis in range(kappa.ndim):
        kp = _edge_pad(kappa, axis)
        out.append(0.5 * (kp[_sl(kappa.ndim, axis, slice(0, -1))]
                          + kp[_sl(kappa.ndim, axis, slice(1, None))]))
    return tuple(out)


def _interior_slab(T, axis: int, sl: slice):
    """``T`` sliced by ``sl`` along ``axis`` and ghost-stripped across it."""
    return T[_sl(T.ndim, axis, sl, slice(1, -1))]


def _diffusive_fluxes(T, kappa_faces, inv_flux_di):
    """q_axis = −κ_face ∂T/∂axis on all n_axis + 1 cell faces."""
    q = []
    for axis in range(T.ndim):
        dT = _interior_slab(T, axis, slice(1, None)) - _interior_slab(T, axis, slice(0, -1))
        q.append(-kappa_faces[axis] * dT * inv_flux_di[axis])
    return tuple(q)


def _div(q, inv_div_di):
    out = 0.0
    n = len(q)
    for axis in range(n):
        out = out + (q[axis][_sl(n, axis, slice(1, None))]
                     - q[axis][_sl(n, axis, slice(0, -1))]) * inv_div_di[axis]
    return out


def _center_velocities(V):
    """Cell-centered velocity from the staggered components."""
    ndim = len(V)
    return tuple(
        0.5 * (Vc[_sl(ndim, axis, slice(0, -1), slice(1, -1))]
               + Vc[_sl(ndim, axis, slice(1, None), slice(1, -1))])
        for axis, Vc in enumerate(V))


def _upwind_advection(T, V, inv_flux_di):
    """First-order upwind −V·∇T at cell centers, donor-cell differences
    picked by the velocity's sign."""
    Vc = _center_velocities(V)
    adv = 0.0
    for axis in range(T.ndim):
        T_c = _interior_slab(T, axis, slice(1, -1))
        T_m = _interior_slab(T, axis, slice(0, -2))
        T_p = _interior_slab(T, axis, slice(2, None))
        dm = (T_c - T_m) * _donor_spacing(inv_flux_di[axis], axis, "lo")
        dp = (T_p - T_c) * _donor_spacing(inv_flux_di[axis], axis, "hi")
        v = Vc[axis]
        adv = adv + torch.where(v > 0, v * dm, 0.0) + torch.where(v < 0, v * dp, 0.0)
    return -adv


def _donor_spacing(inv_face, axis: int, side: str):
    """The upwind spacing per cell: a uniform grid's scalar as it is; a
    nonuniform grid's face spacings (n + 1 along ``axis``) sliced to the n
    cells, the donor side's face."""
    if not isinstance(inv_face, torch.Tensor):
        return inv_face
    return inv_face[_sl(inv_face.ndim, axis, slice(0, -1) if side == "lo" else slice(1, None))]


def explicit_diffusion_step(thermal, params: ThermalParameters, geometry,
                            bcs: TemperatureBoundaryConditions, dt,
                            V: Optional[Tuple[torch.Tensor, ...]] = None):
    """One forward-Euler step: Told ← T; q = −κ∇T; dT/dt = −∇·q (− V·∇T
    upwind with ``V``); T_interior += dT/dt·dt; thermal BCs. Returns a new
    ``ThermalState`` with ΔT, dT/dt and the fluxes filled."""
    T = thermal.T
    inv_flux_di, inv_div_di = thermal_spacings(geometry, T)
    Told = T
    q = _diffusive_fluxes(T, _face_kappa(params.kappa), inv_flux_di)
    dT_dt = -_div(q, inv_div_di)
    if V is not None:
        dT_dt = dT_dt + _upwind_advection(T, V, inv_flux_di)
    T = T + F.pad(dT_dt * dt, (1, 1) * T.ndim)
    T = thermal_bcs(T, bcs)
    new = thermal.replace(T=T, Told=Told, dT=T - Told, dT_dt=dT_dt, qTx=q[0], qTy=q[1])
    if len(q) == 3:
        new = new.replace(qTz=q[2])
    return new


def solve_explicit(thermal, params: ThermalParameters, geometry,
                   bcs: TemperatureBoundaryConditions, dt, nt: int,
                   V: Optional[Tuple[torch.Tensor, ...]] = None):
    """``nt`` explicit steps."""
    for _ in range(int(nt)):
        thermal = explicit_diffusion_step(thermal, params, geometry, bcs, dt, V=V)
    return thermal


class PT1DResult(NamedTuple):
    T: torch.Tensor
    err: torch.Tensor
    iters: int


def _bcs_1d(T, bcs: TemperatureBoundaryConditions):
    """1D ghost-cell BCs (left/right faces only), in place."""
    cv, nf = bcs.constant_value, bcs.no_flux
    if Faces.active(cv.left):
        T[0] = 2.0 * cv.left - T[1]
    if Faces.active(cv.right):
        T[-1] = 2.0 * cv.right - T[-2]
    if Faces.on(nf.left):
        T[0] = T[1]
    if Faces.on(nf.right):
        T[-1] = T[-2]
    return T


def solve_pt_1d(T, K, rhoCp, dx: float, dt, bcs: TemperatureBoundaryConditions,
                CFL: float = 0.95, Re: float = 3.0 * math.pi, eps: float = 1.0e-8,
                iter_max: int = 50_000, nout: int = 100) -> PT1DResult:
    """One implicit step of 1D diffusion by accelerated PT iteration.

    ``T`` is ghosted (nx+2,); K and ρCp at the nx cell centers. Vpdτ =
    CFL·dx, Re_T = π+√(π²+ρCp·L²/(K·dt)); the residual's norm is read every
    ``nout`` iterations and the solve stops once it is ≤ ``eps`` or after
    ``iter_max`` iterations (rounded up to whole chunks)."""
    nx = K.shape[0]
    L = nx * dx
    Vpdt = CFL * dx
    ReT = math.pi + torch.sqrt(math.pi**2 + rhoCp * L**2 / (K * dt))
    theta_r_dt = L / Vpdt / ReT
    dtau_rho = Vpdt * L / ReT / K
    inv_dx = 1.0 / dx
    Told = T
    T = T.clone()
    qTx = torch.zeros((nx + 1,), dtype=T.dtype, device=T.device)
    Kp = _edge_pad(K, 0)
    Kf = 0.5 * (Kp[:-1] + Kp[1:])
    thp = _edge_pad(theta_r_dt, 0)
    thr_f = 0.5 * (thp[:-1] + thp[1:])

    def residual(T):
        qTx2 = -Kf * ((T[1:] - T[:-1]) * inv_dx)
        res = -rhoCp * (T[1:-1] - Told[1:-1]) / dt - (qTx2[1:] - qTx2[:-1]) * inv_dx
        return torch.linalg.vector_norm(res) / math.sqrt(res.numel())

    err = torch.tensor(math.inf, dtype=T.dtype, device=T.device)
    it = 0
    while it < iter_max and bool(err > eps):
        for _ in range(int(nout)):
            dT = (T[1:] - T[:-1]) * inv_dx
            qTx = (qTx * thr_f - Kf * dT) / (1.0 + thr_f)
            dTdt = -(qTx[1:] - qTx[:-1]) * inv_dx - rhoCp * (T[1:-1] - Told[1:-1]) / dt
            T[1:-1] = T[1:-1] + dTdt * dtau_rho / rhoCp
            _bcs_1d(T, bcs)
        it += int(nout)
        err = residual(T)
    return PT1DResult(T=T, err=err, iters=it)
