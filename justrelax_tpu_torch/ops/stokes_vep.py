"""Fused center+vertex visco-elasto-plastic stress update (2D), and the
array-path VEP pseudo-transient iteration built on it.

Counterpart of ``justrelax_tpu/ops/stokes_vep.py``: one pass computes the VE
trial stress and the Drucker-Prager return mapping at both cell centers and
vertices, with clamped-boundary center→vertex interpolation, relaxed plastic
multipliers λ/λv, the dilatancy pressure correction, τII and the VEP
viscosity. Branchless: the yield branch (``is_pl && τII≠0 && F>0``) is a
``torch.where`` mask and every division by τII is guarded.

``vep_iteration`` is the body of one PT iteration of
``solvers/stokes2d_vep.py::solve_vep`` (the JAX solver's ``one_iteration``):
maxloc preconditioner → divergence → compressible pressure iterate θ →
buoyancy → strain rate → stress update → viscosity continuation → damped
velocity update → BCs. The solver and the plain version of the Hopper chunk
kernel (``ops/hopper_stokes_vep.py``) both run it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from justrelax_tpu_torch.ops import stokes as kernels
from justrelax_tpu_torch.ops.bc import flow_bcs
from justrelax_tpu_torch.ops.stencil import av_a, expand_edges, harm_a, maxloc
from justrelax_tpu_torch.rheology.materials import (
    _as_stack,
    compute_density,
    get_bulk_modulus,
    get_shear_modulus,
    phase_average,
)
from justrelax_tpu_torch.rheology.plasticity import (
    PlasticParams,
    flow_gradients_P,
    plastic_params_phase,
    second_invariant,
    yield_function,
)
from justrelax_tpu_torch.rheology.viscosity import (
    compute_viscosity_fields,
    continuation_linear,
    phase_viscosity,
)

Tensor = torch.Tensor

__all__ = [
    "update_stresses_center_vertex",
    "VEPStressResult",
    "VEPInvariants",
    "vep_invariants",
    "VEPCarry",
    "vep_iteration",
    "linear_viscosity_tables",
    "rho_g_fields",
]


class VEPStressResult(NamedTuple):
    txx: Tensor
    tyy: Tensor
    txy_c: Tensor
    txy_v: Tensor
    lam: Tensor
    lam_v: Tensor
    tau_II: Tensor
    eta_vep: Tensor
    P_corrected: Tensor
    eps_pl_xx: Tensor
    eps_pl_yy: Tensor
    eps_pl_xy_v: Tensor
    eps_vol_pl: Tensor


def _stress_increment(tau, tau_o, eta, eps, _Gdt, dtau_r):
    return dtau_r * (2.0 * eta * eps - (tau - tau_o) * eta * _Gdt - tau)


def _safe_div(a, b):
    return a / torch.where(b == 0, 1.0, b)


def _finite_or_zero(K, value):
    return torch.where(torch.isinf(K), 0.0, value)


class VEPInvariants(NamedTuple):
    """What the stress update reads that stays fixed during a solve: the
    old stresses (and their clamped vertex averages), the moduli and the
    plastic parameters (EII_pl and the phase ratios are frozen; the plastic
    strain is accumulated after the solve)."""

    txx_o: Tensor
    tyy_o: Tensor
    txy_c_o: Tensor
    txy_v_o: Tensor
    txx_ov: Tensor
    tyy_ov: Tensor
    K_c: Tensor
    G_c: Tensor
    K_v: Tensor
    G_v: Tensor
    ppc: PlasticParams
    ppv: PlasticParams


def vep_invariants(txx_o, tyy_o, txy_c_o, txy_v_o, EII_pl, material,
                   phase_ratios_center, phase_ratios_vertex) -> VEPInvariants:
    return VEPInvariants(
        txx_o=txx_o, tyy_o=tyy_o, txy_c_o=txy_c_o, txy_v_o=txy_v_o,
        txx_ov=av_a(expand_edges(txx_o)),
        tyy_ov=av_a(expand_edges(tyy_o)),
        K_c=get_bulk_modulus(material, phase_ratios_center, like=txx_o),
        G_c=get_shear_modulus(material, phase_ratios_center, like=txx_o),
        K_v=get_bulk_modulus(material, phase_ratios_vertex, like=txy_v_o),
        G_v=get_shear_modulus(material, phase_ratios_vertex, like=txy_v_o),
        ppc=plastic_params_phase(material, EII_pl, phase_ratios_center),
        ppv=plastic_params_phase(
            material, av_a(expand_edges(EII_pl)), phase_ratios_vertex),
    )


def update_stresses_center_vertex(
    exx, eyy, exy_v,  # strain rate: centers, centers, vertices
    txx, tyy, txy_c, txy_v,  # current stress
    txx_o, tyy_o, txy_c_o, txy_v_o,  # old (previous time step) stress
    Pr,  # pressure iterate θ (centers)
    eta,  # effective viscosity (centers)
    lam, lam_v,  # plastic multipliers (centers, vertices)
    EII_pl,  # accumulated plastic strain (centers)
    material,
    phase_ratios_center,
    phase_ratios_vertex,
    rel_lambda: float,
    dt,
    theta_dtau,
) -> VEPStressResult:
    inv = vep_invariants(txx_o, tyy_o, txy_c_o, txy_v_o, EII_pl, material,
                         phase_ratios_center, phase_ratios_vertex)
    return _update_stresses(exx, eyy, exy_v, txx, tyy, txy_c, txy_v, Pr, eta,
                            lam, lam_v, inv, rel_lambda, dt, theta_dtau)


def _update_stresses(exx, eyy, exy_v, txx, tyy, txy_c, txy_v, Pr, eta, lam,
                     lam_v, inv: VEPInvariants, rel_lambda, dt, theta_dtau):
    txx_o, tyy_o, txy_c_o, txy_v_o = inv.txx_o, inv.tyy_o, inv.txy_c_o, inv.txy_v_o
    # ---------------- vertex pass -----------------------------------------
    Pv = av_a(expand_edges(Pr))
    exx_v = av_a(expand_edges(exx))
    eyy_v = av_a(expand_edges(eyy))
    txx_v = av_a(expand_edges(txx))
    tyy_v = av_a(expand_edges(tyy))
    txx_ov, tyy_ov = inv.txx_ov, inv.tyy_ov
    ppv, G_v, K_v = inv.ppv, inv.G_v, inv.K_v
    _Gvdt = 1.0 / (G_v * dt)
    eta_v = harm_a(expand_edges(eta))
    dtau_rv = 1.0 / (theta_dtau + eta_v * _Gvdt + 1.0)

    dtxx_v = _stress_increment(txx_v, txx_ov, eta_v, exx_v, _Gvdt, dtau_rv)
    dtyy_v = _stress_increment(tyy_v, tyy_ov, eta_v, eyy_v, _Gvdt, dtau_rv)
    dtxy_v = _stress_increment(txy_v, txy_v_o, eta_v, exy_v, _Gvdt, dtau_rv)
    txy_trial_v = txy_v + dtxy_v
    tau_II_v = second_invariant(txx_v + dtxx_v, tyy_v + dtyy_v, txy_trial_v)

    dFdP_v, dQdP_v = flow_gradients_P(ppv, Pv, tau_II_v)
    volume_v = _finite_or_zero(K_v, K_v * dt * dFdP_v * dQdP_v)
    F_v = yield_function(ppv, Pv, tau_II_v)

    yield_v = ppv.is_pl & (tau_II_v != 0.0) & (F_v > 0.0)
    lam_v_new = (1.0 - rel_lambda) * lam_v + rel_lambda * (
        torch.clamp_min(F_v, 0.0) / (eta_v * dtau_rv + ppv.eta_reg + volume_v)
    )
    lam_v_new = torch.where(yield_v, lam_v_new, lam_v)
    dQdt_xy_v = ppv.pl_frac * 0.5 * ppv.dq_shear * _safe_div(txy_trial_v, tau_II_v)
    eps_pl_xy_v = torch.where(yield_v, lam_v_new * dQdt_xy_v, 0.0)
    txy_v_new = txy_v + torch.where(
        yield_v, dtxy_v - 2.0 * eta_v * eps_pl_xy_v * dtau_rv, dtxy_v
    )

    # ---------------- center pass -----------------------------------------
    ppc, G_c, K_c = inv.ppc, inv.G_c, inv.K_c
    _Gdt = 1.0 / (G_c * dt)
    dtau_r = 1.0 / (theta_dtau + eta * _Gdt + 1.0)

    exy_c = av_a(exy_v)
    dtxx = _stress_increment(txx, txx_o, eta, exx, _Gdt, dtau_r)
    dtyy = _stress_increment(tyy, tyy_o, eta, eyy, _Gdt, dtau_r)
    dtxy = _stress_increment(txy_c, txy_c_o, eta, exy_c, _Gdt, dtau_r)
    txx_t, tyy_t, txy_t = txx + dtxx, tyy + dtyy, txy_c + dtxy
    tau_II_t = second_invariant(txx_t, tyy_t, txy_t)

    dFdP, dQdP = flow_gradients_P(ppc, Pr, tau_II_t)
    volume = _finite_or_zero(K_c, K_c * dt * dFdP * dQdP)
    Fc = yield_function(ppc, Pr, tau_II_t)

    yield_c = ppc.is_pl & (tau_II_t != 0.0) & (Fc > 0.0)
    lam_new = (1.0 - rel_lambda) * lam + rel_lambda * (
        torch.clamp_min(Fc, 0.0) / (eta * dtau_r + ppc.eta_reg + volume)
    )
    lam_new = torch.where(yield_c, lam_new, lam)

    scale = ppc.pl_frac * 0.5
    eps_pl_xx = torch.where(yield_c, lam_new * scale * _safe_div(txx_t, tau_II_t), 0.0)
    eps_pl_yy = torch.where(yield_c, lam_new * scale * _safe_div(tyy_t, tau_II_t), 0.0)
    eps_pl_xy = torch.where(
        yield_c, lam_new * scale * ppc.dq_shear * _safe_div(txy_t, tau_II_t), 0.0
    )

    corr = 2.0 * eta * dtau_r
    txx_new = torch.where(yield_c, txx_t - corr * eps_pl_xx, txx_t)
    tyy_new = torch.where(yield_c, tyy_t - corr * eps_pl_yy, tyy_t)
    txy_c_new = torch.where(yield_c, txy_t - corr * eps_pl_xy, txy_t)
    eps_vol_pl = torch.where(yield_c, -lam_new * dQdP, 0.0)

    tau_II = torch.where(
        yield_c, second_invariant(txx_new, tyy_new, txy_c_new), tau_II_t
    )
    eps_II = second_invariant(exx, eyy, exy_c)
    eta_vep = tau_II * 0.5 * _safe_div(torch.ones_like(eps_II), eps_II)
    P_corr = Pr - _finite_or_zero(K_c, K_c * dt * lam_new * dQdP)

    return VEPStressResult(
        txx=txx_new,
        tyy=tyy_new,
        txy_c=txy_c_new,
        txy_v=txy_v_new,
        lam=lam_new,
        lam_v=lam_v_new,
        tau_II=tau_II,
        eta_vep=eta_vep,
        P_corrected=P_corr,
        eps_pl_xx=eps_pl_xx,
        eps_pl_yy=eps_pl_yy,
        eps_pl_xy_v=eps_pl_xy_v,
        eps_vol_pl=eps_vol_pl,
    )


class VEPCarry(NamedTuple):
    """The 12 fields one VEP PT iteration carries to the next."""

    Vx: Tensor
    Vy: Tensor
    theta: Tensor  # pressure iterate
    P: Tensor  # corrected pressure
    txx: Tensor
    tyy: Tensor
    txy_c: Tensor
    txy_v: Tensor
    eta: Tensor
    eta_v: Tensor
    lam: Tensor
    lam_v: Tensor


def rho_g_fields(material, T, P, phase_ratios_center):
    """Buoyancy (ρg_x, ρg_y) at cell centers: ρ(T, P)·g along y."""
    rho = compute_density(material, T=T, P=P, phase_ratios=phase_ratios_center)
    g = phase_average(_as_stack(material, rho).params.gravity, phase_ratios_center)
    rho_gy = rho * g.expand(rho.shape)
    return torch.zeros_like(rho_gy), rho_gy


def linear_viscosity_tables(material, phase_ratios_center,
                            phase_ratios_vertex, T, T_v, like_c, like_v):
    """The creep viscosity at centers and vertices when the creep table is
    linear (η0 per phase, no creep mechanism): ``phase_viscosity`` does not
    depend on the invariant then, so one evaluation serves the whole solve
    with the same values every iteration would compute."""
    return (
        phase_viscosity(material, torch.ones_like(like_c), T, phase_ratios_center, "tau"),
        phase_viscosity(material, torch.ones_like(like_v), T_v, phase_ratios_vertex, "tau"),
    )


def vep_iteration(
    c: VEPCarry, inv: VEPInvariants, P0, Q, material,
    phase_ratios_center, phase_ratios_vertex, T, T_v,
    dt, inv_dx, inv_dy, r, theta_dtau, etadtau,
    rel_lambda, viscosity_relaxation, viscosity_cutoff,
    flow_bc, free_surface_dt=None, eta_tables=None,
):
    """One array-path VEP PT iteration. ``eta_tables`` are the
    ``linear_viscosity_tables`` of a linear creep table (``None``
    evaluates the creep law every iteration). Returns ``(carry,
    stress_result, RP)``; the result and RP hold the per-iteration
    diagnostics."""
    eta_tau = maxloc(c.eta, window=1)
    grad_V = kernels.compute_grad_V(c.Vx, c.Vy, inv_dx, inv_dy)
    RP, theta = kernels.compute_P(
        c.theta, P0, grad_V, Q, eta_tau, inv.K_c, inv.G_c, dt, r, theta_dtau
    )
    rho_gx, rho_gy = rho_g_fields(material, T, c.P, phase_ratios_center)
    exx, eyy, exy = kernels.compute_strain_rate(grad_V, c.Vx, c.Vy, inv_dx, inv_dy)
    res = _update_stresses(
        exx, eyy, exy, c.txx, c.tyy, c.txy_c, c.txy_v,
        theta, c.eta, c.lam, c.lam_v, inv, rel_lambda, dt, theta_dtau,
    )
    if eta_tables is None:
        zv = torch.zeros_like(c.eta_v)
        eta, eta_v = compute_viscosity_fields(
            c.eta, c.eta_v, material,
            res.txx, res.tyy, res.txy_c, zv, zv, res.txy_v,
            phase_ratios_center, phase_ratios_vertex,
            T=T, T_v=T_v, mode="tau",
            relaxation=viscosity_relaxation, cutoff=viscosity_cutoff,
        )
    else:
        eta, eta_v = (
            torch.clamp(continuation_linear(tab, old, viscosity_relaxation),
                        viscosity_cutoff[0], viscosity_cutoff[1])
            for tab, old in zip(eta_tables, (c.eta, c.eta_v))
        )
    Vx, Vy = kernels.compute_V(
        c.Vx, c.Vy, res.P_corrected, res.txx, res.tyy, res.txy_v,
        etadtau, rho_gx, rho_gy, eta_tau, inv_dx, inv_dy,
        free_surface_dt=free_surface_dt,
    )
    Vx, Vy = flow_bcs((Vx, Vy), flow_bc)
    carry = VEPCarry(
        Vx=Vx, Vy=Vy, theta=theta, P=res.P_corrected,
        txx=res.txx, tyy=res.tyy, txy_c=res.txy_c, txy_v=res.txy_v,
        eta=eta, eta_v=eta_v, lam=res.lam, lam_v=res.lam_v,
    )
    return carry, res, RP
