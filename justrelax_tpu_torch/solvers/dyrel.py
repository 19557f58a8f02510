"""DYREL self-tuning dynamic-relaxation Stokes solver, 2D (Duretz et al.
2025).

Counterpart of ``justrelax_tpu/solvers/dyrel.py``. Outer Powell–Hestenes
pressure iterations around inner damped dynamic-relaxation velocity solves:

- penalty γ_eff = harmonic(γfact·η, Kb·dt);
- Gershgorin bounds of the velocity Schur complement give the diagonal
  preconditioner D and λmax per velocity node;
- a Rayleigh quotient of the damped increments estimates λmin after every
  chunk of ``nout`` DR iterations, setting the damping c = 2√λmin·c_fact,
  the pseudo-step dτ = 2/√λmax·CFL, α = (2−c·dτ)/(2+c·dτ) and
  β = 2dτ/(2+c·dτ);
- the stress pass evaluates the visco-elasto-plastic return mapping at
  centers and vertices, phase by phase, with the ratio-weighted blend;
- after each inner solve, P += γ_eff·RP.

The inner solve runs in chunks of ``nout`` DR iterations with one host read
per chunk (and one per outer iteration). A chunk updates the solve's static
tensors in place (:meth:`_DyrelSolve.iteration`). On the CPU it runs
eagerly; on the card ``solve_dyrel`` captures it once per call as CUDA
graphs and replays them for every chunk (``solvers/graphed_chunk.py``): the
counterpart of the JAX package's device-resident ``fori_loop``, without one
host launch per operation. A failed capture raises; there is no eager
fallback on the card.

Within a call the material's constants are read to the host once, in the
field's dtype, and every per-phase quantity that depends only on them, on
the old stress or on P is evaluated once per call or per inner solve,
outside the chunk, in the order of operations the JAX package uses.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from justrelax_tpu_torch.core.grid import NonuniformGeometry
from justrelax_tpu_torch.ops.bc import _free_slip_velocity_2d, _no_slip_velocity_2d
from justrelax_tpu_torch.ops.stencil import av_a, expand_edges
from justrelax_tpu_torch.ops.stokes import spacing_families_2d
from justrelax_tpu_torch.rheology.materials import (
    _as_stack,
    get_bulk_modulus,
    get_shear_modulus,
)
from justrelax_tpu_torch.rheology.plasticity import (
    second_invariant,
    second_invariant_staggered,
)
from justrelax_tpu_torch.rheology.viscosity import compute_viscosity_fields
from justrelax_tpu_torch.solvers.graphed_chunk import GraphedChunk
from justrelax_tpu_torch.solvers.stokes2d import StokesSolveInfo, _norm

__all__ = ["solve_dyrel", "compute_bulk_viscosity_and_penalty", "gershgorin_schur_2d"]

_INF = math.inf
# the outputs of the stress pass, in the JAX package's order
TXX, TYY, TXY, EPL_XX, EPL_YY, EPL_XY, TII, LAM, DPPSI, ETA_VEP, EPS_VOL = range(11)
ALL = tuple(range(11))


def _clamped_av(A):
    return av_a(expand_edges(A))


# --- penalty / preconditioner ----------------------------------------------
def compute_bulk_viscosity_and_penalty(material, pr_center, eta, gfact, dt, sums=None):
    """(Kb·dt, γ_eff) per cell: γ_num = gfact·η (∞ cells take the mean of
    the finite ones), γ_phy = Kb·dt (γ_num where that is ∞), γ_eff their
    harmonic composition. ``sums`` (the distributed layer's reduction, see
    :func:`solve_dyrel`) takes the mean over every rank's cells."""
    Kbdt = get_bulk_modulus(material, pr_center, like=eta) * dt
    inf = torch.isinf(eta)
    if sums is None:
        eta_mean = torch.mean(torch.where(inf, 0.0, eta)) / torch.mean(
            torch.where(inf, 0.0, 1.0).to(eta.dtype))
    else:
        total, finite = sums([torch.where(inf, 0.0, eta),
                              torch.where(inf, 0.0, 1.0).to(eta.dtype)])
        eta_mean = total / finite
    eta_local = torch.where(inf, eta_mean, eta)
    gamma_num = gfact * eta_local
    gamma_phy = torch.where(torch.isinf(Kbdt), gamma_num, Kbdt)
    gamma_eff = gamma_phy * gamma_num / (gamma_phy + gamma_num)
    return Kbdt, gamma_eff


def _gershgorin_factors(di, inv_spacings, like):
    """The inverse spacings of the Gershgorin bound: (1/dx at the x faces,
    1/dy at the x faces, 1/dy at the y faces, 1/dx at the y faces). With
    ``inv_spacings = (1/dcx, 1/dcy, 1/dvx, 1/dvy)`` (a nonuniform grid's
    reciprocal cell widths and face spacings, broadcastable float64 arrays)
    each is the per-face maximum over both families touching the row, as
    the JAX package takes it: the momentum rows mix center and vertex
    spacings, so the bound must majorize every product. Taken in float64
    numpy and made tensors in ``like``'s dtype and on its device."""
    if inv_spacings is None:
        return 1.0 / di[0], 1.0 / di[1], 1.0 / di[1], 1.0 / di[0]
    inv_dcx, inv_dcy, inv_dvx, inv_dvy = inv_spacings
    factors = (
        np.maximum(inv_dvx[1:-1], np.maximum(inv_dcx[:-1], inv_dcx[1:])),  # (nx-1, 1)
        np.maximum(inv_dcy, np.maximum(inv_dvy[:, :-1], inv_dvy[:, 1:])),  # (1, ny)
        np.maximum(inv_dvy[:, 1:-1], np.maximum(inv_dcy[:, :-1], inv_dcy[:, 1:])),  # (1, ny-1)
        np.maximum(inv_dcx, np.maximum(inv_dvx[:-1], inv_dvx[1:])),  # (nx, 1)
    )
    return tuple(torch.as_tensor(a, dtype=like.dtype, device=like.device) for a in factors)


def gershgorin_schur_2d(eta, eta_v, gamma_eff, pr_center, pr_vertex, material,
                        di, dt, spacings=None):
    """Diagonal preconditioners (Dx, Dy) and Gershgorin λmax estimates for
    the velocity Schur complement. ``spacings = (dcx, dcy, dvx, dvy)`` (a
    nonuniform grid's spacing families as float64 arrays) takes the
    per-face bound of :func:`_gershgorin_factors`."""
    inv_spacings = None if spacings is None else tuple(
        1.0 / np.asarray(a, dtype=float) for a in spacings)
    return _gershgorin(eta, eta_v, gamma_eff, pr_center, pr_vertex, material, dt,
                       _gershgorin_factors(di, inv_spacings, eta))


def _gershgorin(eta, eta_v, gamma_eff, pr_center, pr_vertex, material, dt, factors):
    _dx_x, _dy_x, _dy_y, _dx_y = factors
    c43, c23 = 4.0 / 3.0, 2.0 / 3.0

    G_c = get_shear_modulus(material, pr_center, like=eta)
    G_v = get_shear_modulus(material, pr_vertex, like=eta)
    eta_ve_c = 1.0 / (1.0 / eta + 1.0 / (G_c * dt))
    eta_ve_v = 1.0 / (1.0 / eta_v + 1.0 / (G_v * dt))

    # Dx on interior x faces: (nx-1, ny)
    eN, eS = eta_ve_v[1:-1, 1:], eta_ve_v[1:-1, :-1]
    eW, eE = eta_ve_c[:-1, :], eta_ve_c[1:, :]
    gW, gE = gamma_eff[:-1, :], gamma_eff[1:, :]
    Dx = (eN + eS) * _dy_x * _dy_x + (gE + gW + c43 * (eE + eW)) * _dx_x * _dx_x
    Cxx = (
        torch.abs(eN * _dy_x * _dy_x)
        + torch.abs(eS * _dy_x * _dy_x)
        + torch.abs((gE + c43 * eE) * _dx_x * _dx_x)
        + torch.abs((gW + c43 * eW) * _dx_x * _dx_x)
        + torch.abs(Dx)
    )
    Cxy = (
        torch.abs((gE - c23 * eE + eN) * _dx_x * _dy_x)
        + torch.abs((gE - c23 * eE + eS) * _dx_x * _dy_x)
        + torch.abs((gW + eN - c23 * eW) * _dx_x * _dy_x)
        + torch.abs((gW + eS - c23 * eW) * _dx_x * _dy_x)
    )
    lmax_x = (Cxx + Cxy) / Dx

    # Dy on interior y faces: (nx, ny-1)
    eE2, eW2 = eta_ve_v[1:, 1:-1], eta_ve_v[:-1, 1:-1]
    eS2, eN2 = eta_ve_c[:, :-1], eta_ve_c[:, 1:]
    gS, gN = gamma_eff[:, :-1], gamma_eff[:, 1:]
    Dy = (gN + gS + c43 * (eN2 + eS2)) * _dy_y * _dy_y + (eE2 + eW2) * _dx_y * _dx_y
    Cyy = (
        torch.abs(eE2 * _dx_y * _dx_y)
        + torch.abs(eW2 * _dx_y * _dx_y)
        + torch.abs((gN + c43 * eN2) * _dy_y * _dy_y)
        + torch.abs((gS + c43 * eS2) * _dy_y * _dy_y)
        + torch.abs(Dy)
    )
    Cyx = (
        torch.abs((gN + eE2 - c23 * eN2) * _dx_y * _dy_y)
        + torch.abs((gN - c23 * eN2 + eW2) * _dx_y * _dy_y)
        + torch.abs((gS + eE2 - c23 * eS2) * _dx_y * _dy_y)
        + torch.abs((gS - c23 * eS2 + eW2) * _dx_y * _dy_y)
    )
    lmax_y = (Cyx + Cyy) / Dy
    return Dx, Dy, lmax_x, lmax_y


def _alpha_beta(lmax, cV, CFL):
    dtau = 2.0 / torch.sqrt(lmax) * CFL
    beta = 2.0 * dtau / (2.0 + cV * dtau)
    alpha = (2.0 - cV * dtau) / (2.0 + cV * dtau)
    return dtau, alpha, beta


# --- local VEP stress (per phase, ratio-weighted) ---------------------------
class _Phase(NamedTuple):
    """One phase's constants as Python floats, each evaluated in the field's
    dtype as the JAX package evaluates it (G or Kb of 0 or nan is ∞)."""

    inv_Gdt: float  # 1/(G·dt)
    inv2Gdt: float  # 1/(2G·dt), 0 where G = ∞
    Kb: float
    Kb_inf: bool
    Kbdt: float
    is_pl: bool
    eta_reg: float
    Ccphi: float  # C·cosϕ
    sphi: float
    spsi: float
    pT: float  # the cap's closure pressure, −∞ without a cap
    pT2: float  # pT², ∞ without a cap


def _phases(material, dtype, dt):
    """The per-phase constants of ``material`` (one host read)."""
    m = material.params
    names = ("G", "Kb", "is_plastic", "eta_reg", "C", "friction_angle",
             "dilation_angle", "tension_pT")
    host = {k: getattr(m, k).detach().to("cpu", dtype) for k in names}
    deg = math.pi / 180.0
    out = []
    for p in range(host["G"].shape[0]):
        def inf_if_zero(v):
            return torch.where((v == 0) | torch.isnan(v), _INF, v)

        G, Kb = inf_if_zero(host["G"][p]), inf_if_zero(host["Kb"][p])
        C = host["C"][p]
        sphi = torch.sin(host["friction_angle"][p] * deg)
        cphi = torch.cos(host["friction_angle"][p] * deg)
        spsi = torch.sin(host["dilation_angle"][p] * deg)
        pT = host["tension_pT"][p]
        pT = torch.where(pT == 0.0, -_INF, pT)
        out.append(_Phase(
            inv_Gdt=float(1.0 / (G * dt)),
            inv2Gdt=0.0 if bool(torch.isinf(G)) else float(1.0 / (2.0 * G * dt)),
            Kb=float(Kb), Kb_inf=bool(torch.isinf(Kb)), Kbdt=float(Kb * dt),
            is_pl=bool(host["is_plastic"][p] > 0), eta_reg=float(host["eta_reg"][p]),
            Ccphi=float(C * cphi), sphi=float(sphi), spsi=float(spsi),
            pT=float(pT), pT2=float(torch.where(torch.isinf(pT), _INF, pT**2)),
        ))
    return out


def _yield_terms(P, ph: _Phase):
    """The P-only terms of one phase's return mapping: the yield stress
    min(cone, cap), ∂Q/∂P and the volumetric term Kb·dt·∂F/∂P·∂Q/∂P of the
    λ denominator (0.0 where Kb = ∞)."""
    tau_cone = ph.Ccphi + P * ph.sphi
    ratio = torch.clamp(P / ph.pT, 0.0, 1.0)
    root = torch.sqrt(torch.clamp_min(1.0 - ratio**2, 1e-12))
    tau_cap = torch.where(P < 0.0, ph.Ccphi * root, _INF)
    on_cap = tau_cap < tau_cone
    Y = torch.minimum(tau_cone, tau_cap)
    dFdP_cap = ph.Ccphi * P / ph.pT2 / root
    dQdP = torch.where(on_cap, dFdP_cap, -ph.spsi)
    dFdP = torch.where(on_cap, dFdP_cap, -ph.sphi)
    vol = 0.0 if ph.Kb_inf else ph.Kbdt * dFdP * dQdP
    return Y, dQdP, vol


def _eta_terms(inv_eta, ph: _Phase, vol):
    """(2·η_ve, η_ve + η_reg + vol) of one phase from 1/η."""
    eta_ve = 1.0 / (inv_eta + ph.inv_Gdt)
    den = eta_ve + ph.eta_reg
    if not (isinstance(vol, float) and vol == 0.0):
        den = den + vol
    return 2.0 * eta_ve, den


def _phase_stress(e3, two_eta_ve, den, Y, dQdP, lam, ph: _Phase, lam_relax, dt,
                  need, eII_den):
    """One phase's return mapping on the elastic trial strain rates ``e3``:
    the requested outputs (``None`` where one is 0 everywhere) and the live
    mask (ε̇II ≠ 0)."""
    eII = second_invariant(*e3)
    live = eII != 0.0
    t = [two_eta_ve * e for e in e3]
    tII = second_invariant(*t)
    vals = {}
    need_tII = TII in need or ETA_VEP in need
    if ph.is_pl:
        F = tII - Y
        yielding = (F >= 0.0) & live
        q = F / den
        lam_new = q if lam_relax == 1.0 else lam_relax * q + (1.0 - lam_relax) * lam
        lam_p = torch.where(yielding, lam_new, 0.0)
        corrected = lam_p > 0.0
        k = lam_p * (0.5 / torch.where(tII == 0, 1.0, tII))
        for i in range(3):
            if need_tII or TXX + i in need or EPL_XX + i in need:
                epl = torch.where(corrected, k * t[i], 0.0)
                vals[EPL_XX + i] = epl
                t[i] = t[i] - two_eta_ve * epl
        if need_tII:
            tII = second_invariant(*t)
        if LAM in need:
            vals[LAM] = lam_p
        if DPPSI in need or EPS_VOL in need:
            m = -lam_p * dQdP
            if DPPSI in need and not ph.Kb_inf:
                vals[DPPSI] = torch.where(corrected, m * ph.Kb * dt, 0.0)
            vals[EPS_VOL] = torch.where(yielding, m, 0.0)
    for i in (TXX, TYY, TXY):
        vals[i] = t[i]
    vals[TII] = tII
    if ETA_VEP in need:
        vals[ETA_VEP] = tII * 0.5 / eII_den
    return vals, live


def _stress_location(eps3, lam, ratios, consts, phases, lam_relax, dt, need, eta,
                     zeros=True):
    """The ratio-weighted stress pass at one location (centers or
    vertices): per phase the return mapping, its outputs filled where
    ε̇II = 0 (with η for η_vep, 0 otherwise), weighted by the phase's ratio
    and summed over the phases in order. ``consts[p]`` is the phase's
    (trial shift τ_o/(2G·dt) or None, 2η_ve, λ denominator, Y, ∂Q/∂P).
    Returns the 11 outputs in the JAX package's order, ``None`` for those
    not in ``need`` and, with ``zeros=False``, for those that are 0
    everywhere."""
    eII_den = None
    if ETA_VEP in need:
        eII_raw = second_invariant(*eps3)
        eII_den = torch.where(eII_raw == 0, 1.0, eII_raw)
    outs = [None] * 11
    for p, ph in enumerate(phases):
        o3, two_eta_ve, den, Y, dQdP = consts[p]
        e3 = eps3 if o3 is None else [e + o for e, o in zip(eps3, o3)]
        vals, live = _phase_stress(e3, two_eta_ve, den, Y, dQdP, lam, ph, lam_relax,
                                   dt, need, eII_den)
        r = ratios[p]
        for i in need:
            v = vals.get(i)
            if v is None:
                continue
            c = r * torch.where(live, v, eta if i == ETA_VEP else 0.0)
            outs[i] = c if outs[i] is None else outs[i] + c
    if zeros:
        outs = [torch.zeros_like(eps3[0]) if o is None and i in need else o
                for i, o in enumerate(outs)]
    return outs


def _shift(tau_o3, ph: _Phase):
    """τ_o/(2G·dt) of one phase, ``None`` where G = ∞ (the shift is 0)."""
    if ph.inv2Gdt == 0.0:
        return None
    return [o * ph.inv2Gdt for o in tau_o3]


def _location_consts(inv_eta, tau_o3, P, phases):
    """Each phase's stress-pass constants at one location (see
    :func:`_stress_location`)."""
    out = []
    for ph in phases:
        Y, dQdP, vol = _yield_terms(P, ph)
        two_eta_ve, den = _eta_terms(inv_eta, ph, vol)
        out.append((_shift(tau_o3, ph), two_eta_ve, den, Y, dQdP))
    return out


def _local_stress(eps_ij, tau_o_ij, eta, P, lam, lam_relax, material, pr, dt, EII):
    """The VEP stress of every phase, ratio-weighted (the JAX package's
    ``_local_stress``): (τxx, τyy, τxy, ε_pl xx, yy, xy, τII, λ, ΔPψ,
    η_vep, ε_vol_pl). ``EII`` is not used, as in the JAX package."""
    material = _as_stack(material, eta)
    phases = _phases(material, eta.dtype, dt)
    consts = _location_consts(1.0 / eta, tau_o_ij, P, phases)
    ratios = [pr[..., p] for p in range(len(phases))]
    return tuple(_stress_location(list(eps_ij), lam, ratios, consts, phases, lam_relax,
                                  dt, ALL, eta))


def _flow_bcs_(Vx, Vy, bc):
    """The 2D velocity BCs, in place (``ops.bc.flow_bcs`` without its
    copies)."""
    if bc.no_slip.any():
        _no_slip_velocity_2d(Vx, Vy, bc.no_slip)
    if bc.free_slip.any():
        _free_slip_velocity_2d(Vx, Vy, bc.free_slip)


class _DyrelSolve(GraphedChunk):
    """One ``solve_dyrel`` call's static state: the carried fields of the
    inner solve (updated in place by :meth:`iteration`; a chunk of them
    replayed as CUDA graphs on the card, ``solvers/graphed_chunk.py``), the
    tuning fields, and the constants of the call and of the current inner
    solve. With a ``halo`` hook (see :func:`solve_dyrel`) the chunk runs
    eagerly on every device, and capturing it raises."""

    def __init__(self, stokes, geometry, flow_bc, material, pr_center, pr_vertex, dt,
                 rho_g, gfact, lambda_relax, linear_viscosity, viscosity_relaxation,
                 viscosity_cutoff, T, alpha_dT, halo=None):
        nx, ny = stokes.P.shape
        dtype = stokes.P.dtype
        self.halo = halo
        self.flow_bc, self.dt = flow_bc, dt
        self.material, self.pr_center, self.pr_vertex = material, pr_center, pr_vertex
        self.lambda_relax, self.linear = lambda_relax, linear_viscosity
        self.viscosity_relaxation, self.viscosity_cutoff = viscosity_relaxation, viscosity_cutoff
        # the spacing families (tensors on a nonuniform grid, made before any
        # capture); mom: ∂x and ∂y at the x faces, ∂y and ∂x at the y faces
        self.inv_dx, self.inv_dy, strain_v, self.mom = spacing_families_2d(geometry, stokes.P)
        self.inv_dx_v, self.inv_dy_v = strain_v.values()
        inv_spacings = (geometry.inv_div_di + geometry.inv_flux_di
                        if isinstance(geometry, NonuniformGeometry) else None)
        self.gersh = _gershgorin_factors(geometry.di, inv_spacings, stokes.P)
        gx, gy = (nx, ny) if halo is None else halo.ni  # the norms' node counts
        self.v_dofs = ((gx - 2) * (gy - 1), (gx - 1) * (gy - 2))
        self.p_dof = gx * gy

        eta, eta_v = stokes.viscosity.eta, stokes.viscosity.eta_v
        self.P0, self.Q = stokes.P, stokes.Q
        self.to_c = [stokes.tau_o.xx, stokes.tau_o.yy, stokes.tau_o.xy_c]
        self.to_v = [stokes.tau_o.xx_v, stokes.tau_o.yy_v, stokes.tau_o.xy]
        if rho_g is None:
            rho_gx = rho_gy = torch.zeros((nx, ny), dtype=dtype, device=eta.device)
        else:
            rho_gx, rho_gy = rho_g
        self.rho_x = 0.5 * (rho_gx[1:, :] + rho_gx[:-1, :])
        self.rho_y = 0.5 * (rho_gy[:, 1:] + rho_gy[:, :-1])
        self.etab, self.gamma_eff = compute_bulk_viscosity_and_penalty(
            material, pr_center, eta, gfact, dt, sums=None if halo is None else halo.sums)
        Dx, Dy, lmx, lmy = _gershgorin(eta, eta_v, self.gamma_eff, pr_center, pr_vertex,
                                       material, dt, self.gersh)
        self.rp_src = self.Q / dt if alpha_dT is None else (self.Q + alpha_dT) / dt
        self.T = T
        self.T_v = None if T is None else _clamped_av(T)

        self.phases = _phases(material, dtype, dt)
        np_ = len(self.phases)
        self.r_c = [pr_center[..., p].contiguous() for p in range(np_)]
        self.r_v = [pr_vertex[..., p].contiguous() for p in range(np_)]
        self.shift_c = [_shift(self.to_c, ph) for ph in self.phases]
        self.shift_v = [_shift(self.to_v, ph) for ph in self.phases]
        # the carried fields of the inner solve
        self.Vx, self.Vy = stokes.V.Vx.clone(), stokes.V.Vy.clone()
        self.lam = torch.zeros_like(stokes.P)
        self.lam_v = torch.zeros_like(stokes.tau.xy)
        self.dVx = torch.zeros((nx - 1, ny), dtype=dtype, device=eta.device)
        self.dVy = torch.zeros((nx, ny - 1), dtype=dtype, device=eta.device)
        self.Rx, self.Ry = torch.zeros_like(self.dVx), torch.zeros_like(self.dVy)
        self.Rx0, self.Ry0 = torch.zeros_like(self.dVx), torch.zeros_like(self.dVy)
        self.eta, self.eta_v = eta.clone(), eta_v.clone()
        self.Dx_f, self.Dy_f, self.lmx, self.lmy = Dx, Dy, lmx, lmy
        self.tun = [torch.zeros_like(self.dVx) for _ in range(3)] + \
            [torch.zeros_like(self.dVy) for _ in range(3)]
        self.P = torch.empty_like(stokes.P)
        self._p = None  # the constants of the current inner solve

    # ---- the operators of the solve -------------------------------------
    def strain(self, Vx, Vy):
        exx = (Vx[1:, 1:-1] - Vx[:-1, 1:-1]) * self.inv_dx
        eyy = (Vy[1:-1, 1:] - Vy[1:-1, :-1]) * self.inv_dy
        div = exx + eyy
        third = div / 3.0
        exy = 0.5 * ((Vx[:, 1:] - Vx[:, :-1]) * self.inv_dy_v
                     + (Vy[1:, :] - Vy[:-1, :]) * self.inv_dx_v)
        return exx - third, eyy - third, exy, div

    def strain_RP(self, Vx, Vy, P):
        exx, eyy, exy, div = self.strain(Vx, Vy)
        RP = -div - (P - self.P0) / self.etab + self.rp_src
        return exx, eyy, exy, RP

    def stress_pass(self, exx, eyy, exy, P, lam, lam_v, eta, eta_v, need=ALL):
        """(center outputs, vertex outputs) of the stress pass, every
        constant evaluated here (the residual checks and the final state)."""
        P_v = _clamped_av(P)
        eps_v = [_clamped_av(exx), _clamped_av(eyy), exy]
        out_v = _stress_location(
            eps_v, lam_v, self.r_v, _location_consts(1.0 / eta_v, self.to_v, P_v, self.phases),
            self.phases, self.lambda_relax, self.dt, need, eta_v)
        eps_c = [exx, eyy, av_a(exy)]
        out_c = _stress_location(
            eps_c, lam, self.r_c, _location_consts(1.0 / eta, self.to_c, P, self.phases),
            self.phases, self.lambda_relax, self.dt, need, eta)
        return out_c, out_v

    def momentum_residual(self, dPx, dPy, theta_c, txx, tyy, txy):
        dx_x, dy_x, dy_y, dx_y = self.mom
        Ptot_x = (dPx + theta_c[1:, :] - theta_c[:-1, :]) * dx_x
        Rx = ((txx[1:, :] - txx[:-1, :]) * dx_x
              + (txy[1:-1, 1:] - txy[1:-1, :-1]) * dy_x - Ptot_x - self.rho_x)
        Ptot_y = (dPy + theta_c[:, 1:] - theta_c[:, :-1]) * dy_y
        Ry = ((tyy[:, 1:] - tyy[:, :-1]) * dy_y
              + (txy[1:, 1:-1] - txy[:-1, 1:-1]) * dx_y - Ptot_y - self.rho_y)
        return Rx, Ry

    def residual(self, P, out_c, out_v, theta_c):
        dPx, dPy = P[1:, :] - P[:-1, :], P[:, 1:] - P[:, :-1]
        return self.momentum_residual(dPx, dPy, theta_c, out_c[TXX], out_c[TYY], out_v[TXY])

    # ---- the inner solve ------------------------------------------------
    def set_P(self, P):
        """Take ``P`` for the next inner solve and evaluate its constants:
        P-only terms of each phase and, with a linear viscosity, the
        η-dependent ones. Into the static tensors when they exist (the
        captured chunk reads those)."""
        self.P.copy_(P)
        P_v = _clamped_av(self.P)
        new = {
            "dP_etab": (self.P - self.P0) / self.etab,
            "dPx": self.P[1:, :] - self.P[:-1, :],
            "dPy": self.P[:, 1:] - self.P[:, :-1],
            "yc": [_yield_terms(self.P, ph) for ph in self.phases],
            "yv": [_yield_terms(P_v, ph) for ph in self.phases],
        }
        if self.linear:
            inv_c, inv_v = 1.0 / self.eta, 1.0 / self.eta_v
            new["ec"] = [_eta_terms(inv_c, ph, y[2]) for ph, y in zip(self.phases, new["yc"])]
            new["ev"] = [_eta_terms(inv_v, ph, y[2]) for ph, y in zip(self.phases, new["yv"])]
        if self._p is None:
            self._p = new
        else:
            _copy_into(self._p, new)

    def set_tuning(self, cV, CFL):
        for buf, v in zip(self.tun, _alpha_beta(self.lmx, cV, CFL) + _alpha_beta(self.lmy, cV, CFL)):
            buf.copy_(v)

    def _consts(self, loc):
        """The stress-pass constants at centers (``"c"``) or vertices of the
        current inner solve; η-dependent ones from the carried η when the
        viscosity is refreshed."""
        yields = self._p["y" + loc]
        shifts = self.shift_c if loc == "c" else self.shift_v
        if self.linear:
            eterms = self._p["e" + loc]
        else:
            inv = 1.0 / (self.eta if loc == "c" else self.eta_v)
            eterms = [_eta_terms(inv, ph, y[2]) for ph, y in zip(self.phases, yields)]
        return [(s, e[0], e[1], y[0], y[1]) for s, e, y in zip(shifts, eterms, yields)]

    def iteration(self):
        """One DR iteration on the carried fields, in place."""
        p = self._p
        exx, eyy, exy, div = self.strain(self.Vx, self.Vy)
        RP = -div - p["dP_etab"] + self.rp_src
        need_c = (TXX, TYY, LAM, DPPSI) if self.linear else (TXX, TYY, TXY, LAM, DPPSI)
        need_v = (TXY, LAM) if self.linear else (TXX, TYY, TXY, LAM)
        eps_v = [_clamped_av(exx), _clamped_av(eyy), exy]
        out_v = _stress_location(eps_v, self.lam_v, self.r_v, self._consts("v"), self.phases,
                                 self.lambda_relax, self.dt, need_v, self.eta_v, zeros=False)
        eps_c = [exx, eyy, av_a(exy)]
        out_c = _stress_location(eps_c, self.lam, self.r_c, self._consts("c"), self.phases,
                                 self.lambda_relax, self.dt, need_c, self.eta, zeros=False)
        theta_c = self.gamma_eff * RP
        if out_c[DPPSI] is not None:
            theta_c = theta_c + out_c[DPPSI]
        Rx, Ry = self.momentum_residual(p["dPx"], p["dPy"], theta_c, out_c[TXX], out_c[TYY],
                                        out_v[TXY])
        torch.div(Rx, self.Dx_f, out=self.Rx)
        torch.div(Ry, self.Dy_f, out=self.Ry)
        dtx, ax, bx, dty, ay, by = self.tun
        self.dVx.mul_(ax).add_(self.Rx)
        self.dVy.mul_(ay).add_(self.Ry)
        self.Vx[1:-1, 1:-1].add_(self.dVx * bx * dtx)
        self.Vy[1:-1, 1:-1].add_(self.dVy * by * dty)
        _flow_bcs_(self.Vx, self.Vy, self.flow_bc)
        for lam, new_lam in ((self.lam, out_c[LAM]), (self.lam_v, out_v[LAM])):
            if new_lam is None:
                lam.zero_()
            else:
                lam.copy_(new_lam)
        if not self.linear:
            eta_n, eta_vn = compute_viscosity_fields(
                self.eta, self.eta_v, self.material,
                out_c[TXX], out_c[TYY], out_c[TXY], out_v[TXX], out_v[TYY], out_v[TXY],
                self.pr_center, self.pr_vertex, T=self.T, T_v=self.T_v, mode="tau",
                relaxation=self.viscosity_relaxation, cutoff=self.viscosity_cutoff)
            self.eta.copy_(eta_n)
            self.eta_v.copy_(eta_vn)
        if self.halo is not None:
            # the velocity halo: the overlap layers from the ranks that own
            # them (the other carried fields are wrong only where nothing
            # owned reads them before the next exchange)
            self.halo.exchange([self.Vx, self.Vy])

    def norms(self, R):
        """‖R‖₂/√dofs of each of the momentum and pressure residuals ``R``
        (Rx, Ry[, RP]); with a halo hook, over every rank's owned nodes (one
        reduction)."""
        dofs = self.v_dofs + (self.p_dof,)
        if self.halo is None:
            return [_norm(x) / math.sqrt(n) for x, n in zip(R, dofs)]
        ss = self.halo.sums([x.square() for x in R])
        return [ss[i].sqrt() / math.sqrt(n) for i, n in zip(range(len(R)), dofs)]

    def chunk_sums(self):
        """After a chunk: the preconditioned momentum norms and the Rayleigh
        quotient's numerator and denominator of the chunk's last increments,
        with the tuning that chunk ran with; with a halo hook, one
        reduction."""
        dtx, _, bx, dty, _, by = self.tun
        dVx_full = self.dVx * bx * dtx
        dVy_full = self.dVy * by * dty
        if self.halo is None:
            errVx = _norm(self.Dx_f * self.Rx) / math.sqrt(self.v_dofs[0])
            errVy = _norm(self.Dy_f * self.Ry) / math.sqrt(self.v_dofs[1])
            num = torch.sum(dVx_full * (self.Rx - self.Rx0)) + torch.sum(
                dVy_full * (self.Ry - self.Ry0))
            den = torch.sum(dVx_full**2) + torch.sum(dVy_full**2)
            return errVx, errVy, num, den
        ss = self.halo.sums([(self.Dx_f * self.Rx).square(), (self.Dy_f * self.Ry).square(),
                             dVx_full * (self.Rx - self.Rx0), dVy_full * (self.Ry - self.Ry0),
                             dVx_full**2, dVy_full**2])
        return (ss[0].sqrt() / math.sqrt(self.v_dofs[0]),
                ss[1].sqrt() / math.sqrt(self.v_dofs[1]), ss[2] + ss[3], ss[4] + ss[5])

    def run_chunk(self, n):
        if self.halo is None:
            super().run_chunk(n)
        else:  # a staged exchange holds a host copy: no graph can hold it
            self.chunk(n)

    def capture(self, n):
        if self.halo is not None:
            raise RuntimeError("the sharded DYREL route runs eagerly: its halo exchanges "
                               "cannot be captured in a CUDA graph")
        super().capture(n)

    def carried(self):
        return [self.Vx, self.Vy, self.lam, self.lam_v, self.dVx, self.dVy, self.Rx,
                self.Ry, self.eta, self.eta_v]


def _copy_into(old, new):
    """Copy the tensors of the nested structure ``new`` into those of
    ``old`` (same structure; floats stand)."""
    if isinstance(old, torch.Tensor):
        old.copy_(new)
    elif isinstance(old, dict):
        for k in old:
            _copy_into(old[k], new[k])
    elif isinstance(old, (list, tuple)):
        for a, b in zip(old, new):
            _copy_into(a, b)


def solve_dyrel(
    stokes,
    geometry,
    flow_bc,
    material,
    pr_center,
    pr_vertex,
    dt,
    rho_g: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    gfact: float = 20.0,
    CFL: float = 0.99,
    c_fact: float = 0.5,
    eps: float = 1.0e-6,
    iter_max: int = 50_000,
    total_iter_max: int = 50_000,
    nout: int = 100,
    rel_drop: float = 1.0e-2,
    lambda_relax: float = 1.0,
    max_ph: int = 1000,
    linear_viscosity: bool = True,
    viscosity_relaxation: float = 1.0e-2,
    viscosity_cutoff: Tuple[float, float] = (-_INF, _INF),
    T: Optional[torch.Tensor] = None,
    alpha_dT: Optional[torch.Tensor] = None,
    halo=None,
):
    """DYREL solve; returns (stokes, :class:`StokesSolveInfo`) as the JAX
    package does (``iters`` the DR iterations of this call, ``err`` the last
    outer error, the histories one nan each).

    ``linear_viscosity=False`` refreshes η/ηv from the stress every DR
    iteration (τII mode, ``viscosity_relaxation``, ``viscosity_cutoff``)
    and the Gershgorin bounds after every chunk. ``alpha_dT = α·ΔT`` adds
    the thermal-stress source α·ΔT/dt to the pressure residual. ``T``
    enters the viscosity refresh. The solve runs on the state's device; on
    the card every chunk is a CUDA graph replay. On a ``NonuniformGeometry``
    the operators take its spacing families and the Gershgorin bound their
    per-face maximum. A bare ``Material`` is stacked once on the state's
    device and in its dtype.

    ``halo`` is the distributed layer's hook (``parallel/dyrel.py``): the
    state is one rank's overlapping window of the global grid, ``halo.ni``
    the global cell counts, ``halo.exchange(tensors)`` refreshes the overlap
    of each tensor in place (after every DR iteration) and
    ``halo.sums(tensors)`` gives each tensor's sum over the nodes the ranks
    own (the norms, the Rayleigh quotient, the mean η). With it the chunk
    runs eagerly on the card too. Without it the solve is the serial one."""
    material = _as_stack(material, stokes.P)
    dtype = stokes.P.dtype
    s = _DyrelSolve(stokes, geometry, flow_bc, material, pr_center, pr_vertex, dt, rho_g,
                    gfact, lambda_relax, linear_viscosity, viscosity_relaxation,
                    viscosity_cutoff, T, alpha_dT, halo)
    dev = stokes.P.device

    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    tiny = torch.finfo(dtype).tiny
    nout_i = int(nout)
    # the outer loop's state; P lives in s.P from the first inner solve on
    P = stokes.P
    o_err, err_min, rel = scalar(_INF), scalar(_INF), scalar(rel_drop)
    errV0x = errV0y = errPt0 = scalar(1.0)
    itPH, itg = 0, 0
    cV, errV00x, errV00y = scalar(0.0), scalar(1.0), scalar(1.0)
    go = True  # o_err > eps, read on the host once per outer iteration

    while go and itPH < max_ph and itg < total_iter_max:
        # Powell–Hestenes residual check (relative or absolute per residual)
        exx, eyy, exy, RP = s.strain_RP(s.Vx, s.Vy, P)
        out_c, out_v = s.stress_pass(exx, eyy, exy, P, s.lam, s.lam_v, s.eta, s.eta_v)
        Rx, Ry = s.residual(P, out_c, out_v, out_c[DPPSI])
        errVx, errVy, errPt = s.norms((Rx, Ry, RP))
        if itPH == 0:
            errV0x, errV0y = errVx + tiny, errVy + tiny
        if itPH <= 1:
            errPt0 = errPt + tiny
        o_err = torch.maximum(
            torch.maximum(torch.minimum(errVx / errV0x, errVx),
                          torch.minimum(errVy / errV0y, errVy)),
            torch.minimum(errPt / errPt0, errPt))
        rel = torch.where(o_err > err_min * 1.05, torch.clamp_min(rel * 0.1, 1.0e-3), rel)
        err_min = torch.minimum(err_min, o_err)
        eps_vel = o_err * rel
        # the one host read of the outer iteration: err > eps, and whether
        # the inner solve's first test (err = ∞ > eps_vel) passes
        go, first = torch.stack([o_err > eps, eps_vel < _INF]).tolist()
        if go:  # once converged the reference breaks: no inner solve, no update
            s.set_P(P)
            # the inner solve: its tuning starts from the carried λmax and c
            s.set_tuning(cV, CFL)
            it, run = 0, first
            while run and it < iter_max:
                s.Rx0.copy_(s.Rx)
                s.Ry0.copy_(s.Ry)
                s.run_chunk(nout_i)
                if not linear_viscosity:
                    Dx2, Dy2, lmx2, lmy2 = _gershgorin(
                        s.eta, s.eta_v, s.gamma_eff, pr_center, pr_vertex, material, dt,
                        s.gersh)
                    s.Dx_f.copy_(Dx2)
                    s.Dy_f.copy_(Dy2)
                    s.lmx, s.lmy = lmx2, lmy2
                # the preconditioned norms, and the Rayleigh quotient of the
                # chunk's last increments
                errVx_i, errVy_i, num, den = s.chunk_sums()
                if itg == 0:  # captured once per call
                    errV00x, errV00y = errVx_i, errVy_i
                c_err = torch.maximum(errVx_i / errV00x, errVy_i / errV00y)
                lmin = torch.abs(num) / torch.where(den == 0, 1.0, den)
                cV = 2.0 * torch.sqrt(lmin) * c_fact
                s.set_tuning(cV, CFL)
                it += nout_i
                itg += nout_i
                run = bool(c_err > eps_vel)
            _, _, _, RP2 = s.strain_RP(s.Vx, s.Vy, s.P)
            P = s.P + s.gamma_eff * RP2
        itPH += 1

    # final state assembly
    exx, eyy, exy, RP = s.strain_RP(s.Vx, s.Vy, P)
    out_c, out_v = s.stress_pass(exx, eyy, exy, P, s.lam, s.lam_v, s.eta, s.eta_v)
    P_final = P + out_c[DPPSI]  # absorb ΔPψ
    grad_V = (s.Vx[1:, 1:-1] - s.Vx[:-1, 1:-1]) * s.inv_dx + (
        s.Vy[1:-1, 1:] - s.Vy[1:-1, :-1]) * s.inv_dy

    def g4(A):
        return (A[:-1, :-1], A[1:, :-1], A[:-1, 1:], A[1:, 1:])

    eps_pl_v = out_v[EPL_XY]
    EII_new = stokes.EII_pl + second_invariant_staggered(
        out_c[EPL_XX], out_c[EPL_YY], g4(eps_pl_v)) * dt
    stress = dict(xx=out_c[TXX], yy=out_c[TYY], xy_c=out_c[TXY],
                  xx_v=out_v[TXX], yy_v=out_v[TYY], xy=out_v[TXY])
    tau = stokes.tau.replace(
        **stress, II=second_invariant_staggered(out_c[TXX], out_c[TYY], g4(out_v[TXY])))
    eps_t = stokes.eps.replace(
        xx=exx, yy=eyy, xy=exy, xy_c=av_a(exy),
        II=second_invariant_staggered(exx, eyy, g4(exy)))
    eps_pl_t = stokes.eps_pl.replace(
        xx=out_c[EPL_XX], yy=out_c[EPL_YY], xy=eps_pl_v, xy_c=av_a(eps_pl_v))
    new_stokes = stokes.replace(
        P=P_final, P0=s.P0,
        V=stokes.V.replace(Vx=s.Vx, Vy=s.Vy),
        grad_V=grad_V,
        tau=tau, tau_o=stokes.tau_o.replace(**stress), eps=eps_t, eps_pl=eps_pl_t,
        EII_pl=EII_new, EVol_pl=stokes.EVol_pl + dt * out_c[EPS_VOL],
        eps_vol_pl=out_c[EPS_VOL],
        lam=s.lam, lam_v=s.lam_v, dP_psi=out_c[DPPSI],
        viscosity=stokes.viscosity.replace(eta=s.eta, eta_v=s.eta_v, eta_vep=out_c[ETA_VEP]),
        R=stokes.R.replace(RP=RP, Rx=s.Rx, Ry=s.Ry),
    )
    nan = torch.full((1,), math.nan, dtype=dtype, device=dev)
    info = StokesSolveInfo(iters=itg, err=o_err, err_history=nan, norm_Rx=nan,
                           norm_Ry=nan, norm_RP=nan)
    return new_stokes, info
