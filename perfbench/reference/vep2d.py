"""Plain reference of the 2D visco-elasto-plastic accelerated
pseudo-transient (APT) Stokes iteration, its chunks and the state a solve
hands back.

Written from JustRelax.jl's 2D VEP solver (``src/stokes/Stokes2D.jl``,
``solve!`` with the multi-phase Drucker-Prager stress update, after Duretz,
de Borst & Le Pourhiet 2019 and Räss et al. 2022): staggered grid with
ghosted velocities, compressible visco-elastic pressure iterate, VE trial
stresses at centers and vertices, regularised Drucker-Prager return mapping
with relaxed plastic multipliers, linear viscosity continuation, damped
velocity update and per-face free-slip / no-slip ghosts. Plain PyTorch on
whatever device the tensors are on; it imports nothing of the program.

It covers what the benchmark's configurations state: linear creep (η0 per
phase, harmonic blend, one dominant phase taken as is), constant moduli
and density per phase, the Drucker-Prager cone without softening or
tension cap, no temperature and no free surface.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

INF = float("inf")

# the carried fields of one iteration, in this order
CARRY = ("Vx", "Vy", "theta", "P", "txx", "tyy", "txy_c", "txy_v",
         "eta", "eta_v", "lam", "lam_v")


def grid(n, lengths=(1.0, 1.0)):
    """(dx, dy, centers, vertices) of a uniform ``n``×``n`` grid from the
    origin; coordinates as numpy float64 vectors."""
    dx, dy = lengths[0] / n, lengths[1] / n
    xc = tuple(np.linspace(d / 2, l - d / 2, n) for d, l in zip((dx, dy), lengths))
    xv = tuple(np.linspace(0.0, l, n + 1) for l in lengths)
    return dx, dy, xc, xv


def pt_coefficients(n, lengths, CFL, r=0.7, Re=3.0 * math.pi):
    """The APT damping (θ_dτ, η_dτ) of Räss et al. (2022) for the grid."""
    ltau = min(lengths)
    Vpdtau = min(l / n for l in lengths) * CFL
    return {"r": float(r),
            "theta_dtau": float(ltau * (r + 4.0 / 3.0) / (Re * Vpdtau)),
            "etadtau": float(Vpdtau * ltau / Re)}


# --- stencils -----------------------------------------------------------------
def _pad1(A):
    """``A`` widened by one node on every face, edge values repeated."""
    return F.pad(A[None], (1, 1, 1, 1), mode="replicate")[0]


def _avg4(A):
    return 0.25 * (A[:-1, :-1] + A[1:, :-1] + A[:-1, 1:] + A[1:, 1:])


def _harm4(A):
    return 4.0 / (1.0 / A[:-1, :-1] + 1.0 / A[1:, :-1] + 1.0 / A[:-1, 1:] + 1.0 / A[1:, 1:])


def _max3x3(A):
    """Maximum over each node's 3×3 neighbourhood, the window clamped into
    the array."""
    B = _pad1(A)
    B = torch.maximum(torch.maximum(B[:-2], B[1:-1]), B[2:])
    return torch.maximum(torch.maximum(B[:, :-2], B[:, 1:-1]), B[:, 2:])


def _inv2(xx, yy, xy):
    return torch.sqrt(0.5 * (xx**2 + yy**2) + xy**2)


def _div0(a, b):
    return a / torch.where(b == 0, 1.0, b)


# --- material fields ------------------------------------------------------------
class Fields(NamedTuple):
    """What a solve's iterations read besides the carry, per center (``c``)
    and per vertex (``v``)."""

    K_c: torch.Tensor
    G_c: torch.Tensor
    K_v: torch.Tensor
    G_v: torch.Tensor
    eta_c: torch.Tensor  # creep viscosity (the continuation's target)
    eta_v: torch.Tensor
    pl_c: Dict[str, torch.Tensor]  # Drucker-Prager parameters
    pl_v: Dict[str, torch.Tensor]
    rho_gy: torch.Tensor


def _blend_inf(values, ratios):
    """Ratio-weighted sum over phases that leaves out absent phases (∞·0)."""
    return torch.sum(torch.where(ratios > 0, values * ratios, 0.0), dim=-1)


def _creep(eta0, ratios):
    """Linear creep: the dominant phase's η0 where one phase fills the
    node, the harmonic blend elsewhere."""
    tiny = torch.finfo(ratios.dtype).tiny
    eta_p = eta0.expand(ratios.shape)
    harm = 1.0 / torch.clamp_min(torch.sum(ratios / torch.clamp_min(eta_p, tiny), dim=-1), tiny)
    dom = torch.gather(eta_p, -1, torch.argmax(ratios, dim=-1, keepdim=True))[..., 0]
    return torch.where(torch.amax(ratios, dim=-1) > 0.999, dom, harm)


def _plastic(phases, ratios):
    deg = math.pi / 180.0
    p = phases
    w = torch.where(p["is_plastic"] > 0, 1.0, 0.0).to(ratios.dtype)
    rw = ratios * w
    pl = torch.sum(rw, dim=-1)
    return {
        "on": pl > 0,
        "frac": pl,
        "C_cosphi": torch.sum(rw * p["C"] * torch.cos(p["friction_angle"] * deg), dim=-1),
        "sinphi": torch.sum(rw * torch.sin(p["friction_angle"] * deg), dim=-1),
        "sinpsi": torch.sum(rw * torch.sin(p["dilation_angle"] * deg), dim=-1),
        "eta_reg": torch.sum(rw * p["eta_reg"], dim=-1),
    }


def phase_table(phases, dtype, device):
    """Per-phase parameters (lists of floats) as tensors; a modulus of 0
    means none (∞)."""
    out = {}
    for k, v in phases.items():
        t = torch.tensor([float(x) for x in v], dtype=dtype, device=device)
        if k in ("G", "Kb"):
            t = torch.where(t == 0, INF, t)
        out[k] = t
    return out


def material_fields(phases, pr_c, pr_v) -> Fields:
    """The per-node material of a solve from the phase ratios."""
    p = phase_table(phases, pr_c.dtype, pr_c.device)
    rho = torch.sum(p["rho0"] * pr_c, dim=-1)
    g = torch.sum(p["gravity"] * pr_c, dim=-1)
    return Fields(
        K_c=_blend_inf(p["Kb"], pr_c), G_c=_blend_inf(p["G"], pr_c),
        K_v=_blend_inf(p["Kb"], pr_v), G_v=_blend_inf(p["G"], pr_v),
        eta_c=_creep(p["eta0"], pr_c), eta_v=_creep(p["eta0"], pr_v),
        pl_c=_plastic(p, pr_c), pl_v=_plastic(p, pr_v),
        rho_gy=rho * g,
    )


# --- one iteration ------------------------------------------------------------------
def _stress_step(tau, tau_o, eta, eps, Gdt_inv, dtau_r):
    return dtau_r * (2.0 * eta * eps - (tau - tau_o) * eta * Gdt_inv - tau)


def _return_map(pl, P, tau_II, K, dt, eta, dtau_r, lam, rel):
    """Drucker-Prager cone F = τII − (C cosϕ + P sinϕ): the yield mask, the
    relaxed multiplier and ∂Q/∂P."""
    dQdP = -pl["sinpsi"]
    dFdP = -pl["sinphi"]
    volume = torch.where(torch.isinf(K), 0.0, K * dt * dFdP * dQdP)
    Fy = tau_II - (pl["C_cosphi"] + P * pl["sinphi"])
    yld = pl["on"] & (tau_II != 0.0) & (Fy > 0.0)
    lam_new = (1.0 - rel) * lam + rel * (torch.clamp_min(Fy, 0.0)
                                         / (eta * dtau_r + pl["eta_reg"] + volume))
    return yld, torch.where(yld, lam_new, lam), dQdP


def _bcs(Vx, Vy, bc):
    """Ghost velocities: every no-slip face, then every free-slip face
    (JustRelax.jl's ``flow_bcs!``; the no-slip bottom keeps its Vx/3 row)."""
    Vx, Vy = Vx.clone(), Vy.clone()
    ns, fs = bc["no_slip"], bc["free_slip"]
    if "left" in ns:
        Vx[0, :] = 0.0
        Vy[0, :] = -Vy[1, :]
    if "right" in ns:
        Vx[-1, :] = 0.0
        Vy[-1, :] = -Vy[-2, :]
    if "bot" in ns:
        Vx[:, 1] = Vx[:, 2] * (1.0 / 3.0)
        Vx[:, 0] = -Vx[:, 1]
        Vy[:, 0] = 0.0
    if "top" in ns:
        Vx[:, -1] = -Vx[:, -2]
        Vy[:, -1] = 0.0
    if "bot" in fs:
        Vx[:, 0] = Vx[:, 1]
    if "top" in fs:
        Vx[:, -1] = Vx[:, -2]
    if "left" in fs:
        Vy[0, :] = Vy[1, :]
    if "right" in fs:
        Vy[-1, :] = Vy[-2, :]
    return Vx, Vy


class Solve(NamedTuple):
    """What stays fixed through one solve: the entry state's P0, Q and old
    stresses, the material, the time step, the grid and the solver's
    coefficients."""

    P0: torch.Tensor
    Q: torch.Tensor
    txx_o: torch.Tensor
    tyy_o: torch.Tensor
    txy_c_o: torch.Tensor
    txy_v_o: torch.Tensor
    mat: Fields
    dt: float
    dx: float
    dy: float
    pt: dict
    rel_lambda: float
    visc_relax: float
    bc: dict


def iteration(c: dict, s: Solve):
    """One APT iteration; returns (carry, diagnostics)."""
    m, dt = s.mat, s.dt
    idx, idy = 1.0 / s.dx, 1.0 / s.dy
    r, theta_dtau, etadtau = s.pt["r"], s.pt["theta_dtau"], s.pt["etadtau"]
    Vx, Vy = c["Vx"], c["Vy"]

    # pressure iterate
    eta_tau = _max3x3(c["eta"])
    div = (Vx[1:, 1:-1] - Vx[:-1, 1:-1]) * idx + (Vy[1:-1, 1:] - Vy[1:-1, :-1]) * idy
    Kdt_inv = 1.0 / (m.K_c * dt)
    Gdt_inv = 1.0 / (m.G_c * dt)
    rhs = -div + s.Q * (1.0 / dt)
    RP = -(c["theta"] - s.P0) * Kdt_inv + rhs
    psi = 1.0 / (1.0 / eta_tau + Gdt_inv) * (r / theta_dtau)
    theta = ((s.P0 * Kdt_inv + rhs) * psi + c["theta"]) / (1.0 + Kdt_inv * psi)

    # strain rates
    exx = (Vx[1:, 1:-1] - Vx[:-1, 1:-1]) * idx - div * (1.0 / 3.0)
    eyy = (Vy[1:-1, 1:] - Vy[1:-1, :-1]) * idy - div * (1.0 / 3.0)
    exy_v = 0.5 * ((Vx[:, 1:] - Vx[:, :-1]) * idy + (Vy[1:, :] - Vy[:-1, :]) * idx)

    # vertices: centre fields carried to the vertices, edges repeated
    rel = s.rel_lambda
    eta = c["eta"]
    Pv, exx_v, eyy_v, txx_v, tyy_v = (_avg4(_pad1(A)) for A in
                                      (theta, exx, eyy, c["txx"], c["tyy"]))
    txx_ov, tyy_ov = _avg4(_pad1(s.txx_o)), _avg4(_pad1(s.tyy_o))
    eta_vs = _harm4(_pad1(eta))
    Gv_inv = 1.0 / (m.G_v * dt)
    dtau_rv = 1.0 / (theta_dtau + eta_vs * Gv_inv + 1.0)
    dxx_v = _stress_step(txx_v, txx_ov, eta_vs, exx_v, Gv_inv, dtau_rv)
    dyy_v = _stress_step(tyy_v, tyy_ov, eta_vs, eyy_v, Gv_inv, dtau_rv)
    dxy_v = _stress_step(c["txy_v"], s.txy_v_o, eta_vs, exy_v, Gv_inv, dtau_rv)
    txy_tv = c["txy_v"] + dxy_v
    tII_v = _inv2(txx_v + dxx_v, tyy_v + dyy_v, txy_tv)
    yld_v, lam_v, _ = _return_map(m.pl_v, Pv, tII_v, m.K_v, dt, eta_vs, dtau_rv,
                                  c["lam_v"], rel)
    epl_xy_v = torch.where(yld_v, lam_v * (m.pl_v["frac"] * 0.5) * _div0(txy_tv, tII_v), 0.0)
    txy_v = c["txy_v"] + torch.where(yld_v, dxy_v - 2.0 * eta_vs * epl_xy_v * dtau_rv, dxy_v)

    # centres
    dtau_r = 1.0 / (theta_dtau + eta * Gdt_inv + 1.0)
    exy_c = _avg4(exy_v)
    txx_t = c["txx"] + _stress_step(c["txx"], s.txx_o, eta, exx, Gdt_inv, dtau_r)
    tyy_t = c["tyy"] + _stress_step(c["tyy"], s.tyy_o, eta, eyy, Gdt_inv, dtau_r)
    txy_t = c["txy_c"] + _stress_step(c["txy_c"], s.txy_c_o, eta, exy_c, Gdt_inv, dtau_r)
    tII_t = _inv2(txx_t, tyy_t, txy_t)
    yld, lam, dQdP = _return_map(m.pl_c, theta, tII_t, m.K_c, dt, eta, dtau_r, c["lam"], rel)
    scale = m.pl_c["frac"] * 0.5
    epl_xx = torch.where(yld, lam * scale * _div0(txx_t, tII_t), 0.0)
    epl_yy = torch.where(yld, lam * scale * _div0(tyy_t, tII_t), 0.0)
    epl_xy = torch.where(yld, lam * scale * _div0(txy_t, tII_t), 0.0)
    corr = 2.0 * eta * dtau_r
    txx = torch.where(yld, txx_t - corr * epl_xx, txx_t)
    tyy = torch.where(yld, tyy_t - corr * epl_yy, tyy_t)
    txy_c = torch.where(yld, txy_t - corr * epl_xy, txy_t)
    tII = torch.where(yld, _inv2(txx, tyy, txy_c), tII_t)
    P = theta - torch.where(torch.isinf(m.K_c), 0.0, m.K_c * dt * lam * dQdP)

    # viscosity continuation towards the creep viscosity
    nu = s.visc_relax
    eta_new = nu * m.eta_c + (1.0 - nu) * eta
    eta_v_new = nu * m.eta_v + (1.0 - nu) * c["eta_v"]

    # damped velocity update on the interior faces
    txy_f = txy_v
    Rx = ((txx[1:] - txx[:-1]) * idx + (txy_f[1:-1, 1:] - txy_f[1:-1, :-1]) * idy
          - (P[1:] - P[:-1]) * idx)
    Ry = ((tyy[:, 1:] - tyy[:, :-1]) * idy + (txy_f[1:, 1:-1] - txy_f[:-1, 1:-1]) * idx
          - (P[:, 1:] - P[:, :-1]) * idy - 0.5 * (m.rho_gy[:, 1:] + m.rho_gy[:, :-1]))
    etax = 0.5 * (eta_tau[1:] + eta_tau[:-1])
    etay = 0.5 * (eta_tau[:, 1:] + eta_tau[:, :-1])
    Vx = Vx + F.pad(Rx * etadtau / etax, (1, 1, 1, 1))
    Vy = Vy + F.pad(Ry * etadtau / etay, (1, 1, 1, 1))
    Vx, Vy = _bcs(Vx, Vy, s.bc)

    carry = {"Vx": Vx, "Vy": Vy, "theta": theta, "P": P, "txx": txx, "tyy": tyy,
             "txy_c": txy_c, "txy_v": txy_v, "eta": eta_new, "eta_v": eta_v_new,
             "lam": lam, "lam_v": lam_v}
    diag = {"tau_II": tII, "epl_xx": epl_xx, "epl_yy": epl_yy,
            "epl_xy_v": epl_xy_v, "RP": RP}
    return carry, diag


def chunk(carry: dict, s: Solve, n: int):
    """``n`` iterations from ``carry``; returns (carry, the last
    iteration's diagnostics)."""
    diag = None
    for _ in range(int(n)):
        carry, diag = iteration(carry, s)
    return carry, diag


def solve_end(carry: dict, diag: dict, EII_pl, dt):
    """The state a solve hands back after its last iteration: the carried
    fields, τII of that iteration, and the plastic strain accumulated over
    the step (the vertex shear as the mean of its four squares). η_vep =
    τII/(2 ε̇II) is left out: it divides by a strain rate that vanishes at
    stagnation points, so its gap there measures that division, not the
    solve; τII and the velocities it comes from are compared."""
    xy = diag["epl_xy_v"]
    xy2 = (xy[:-1, :-1] ** 2 + xy[1:, :-1] ** 2 + xy[:-1, 1:] ** 2 + xy[1:, 1:] ** 2) / 4.0
    EII = EII_pl + torch.sqrt(0.5 * (diag["epl_xx"] ** 2 + diag["epl_yy"] ** 2) + xy2) * dt
    out = {k: carry[k] for k in ("Vx", "Vy", "P", "txx", "tyy", "txy_c", "txy_v",
                                 "eta", "eta_v", "lam", "lam_v")}
    out.update(tau_II=diag["tau_II"], EII_pl=EII)
    return out


def advective_dt(Vx, Vy, dx, dy):
    """The particles' time step of the models that move material: the
    advective CFL limit min_d(d / max|V_d|)·0.9, as a Python float."""
    kw = dict(dtype=Vx.dtype, device=Vx.device)
    t = torch.tensor(INF, **kw)
    for v, d in ((Vx, dx), (Vy, dy)):
        t = torch.minimum(t, torch.tensor(d, **kw) / torch.max(torch.abs(v)))
    return float(t * 0.9)
