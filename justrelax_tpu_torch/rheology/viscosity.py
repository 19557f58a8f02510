"""Effective creep viscosity in stress-invariant ("tau") mode.

Counterpart of the "tau" mode of ``justrelax_tpu/rheology/viscosity.py``: the
per-phase creep viscosity is evaluated from τII (linear η0, dislocation,
diffusion, grain-boundary sliding and Peierls creep composed harmonically),
blended harmonically over phases with the dominant-phase exit (ratio > 0.999
takes that phase exactly), relaxed by linear continuation
``η ← ν·η_new + (1−ν)·η_old`` and clamped to a cutoff window. The
strain-rate ("eps") mode waits for a later slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from justrelax_tpu_torch.rheology.materials import _as_stack, _bcast
from justrelax_tpu_torch.rheology.plasticity import second_invariant

R_GAS = 8.314462618

__all__ = [
    "phase_viscosity",
    "compute_viscosity_fields",
    "continuation_linear",
    "shared_powerlaw_exponent",
    "powerlaw_recip_coeffs",
]


def continuation_linear(x_new, x_old, nu):
    return nu * x_new + (1.0 - nu) * x_old


def _tiny(t):
    return torch.finfo(t.dtype).tiny


def phase_viscosity(material, invII, T: Optional[torch.Tensor], phase_ratios,
                    mode: str, P: Optional[torch.Tensor] = None):
    """Effective creep viscosity per cell from the stress invariant
    ``invII`` (``mode="tau"``)."""
    if mode != "tau":
        raise NotImplementedError("the PyTorch port has the 'tau' mode only")
    m = _as_stack(material, invII).params
    tiny = _tiny(invII)
    inv_safe = torch.clamp_min(invII[..., None], tiny)
    iRT = None if T is None else 1.0 / (R_GAS * torch.clamp_min(T[..., None], 1e-30))

    def arrhenius(E_, V_):
        if iRT is None:
            return 1.0
        PV = 0.0 if P is None else P[..., None] * V_
        return torch.exp((E_ + PV) * iRT)

    def safe(A_):
        has = A_ > 0
        return has, torch.where(has, A_, 1.0)

    # dislocation creep
    has_disl, A = safe(_bcast(m.disl_A, invII))
    n = _bcast(m.disl_n, invII)
    eta_disl = 0.5 / A * inv_safe ** (1.0 - n) * arrhenius(
        _bcast(m.disl_E, invII), _bcast(m.disl_V, invII))
    # diffusion creep: linear in stress
    has_diff, Ad = safe(_bcast(m.diff_A, invII))
    eta_diff = 0.5 / Ad * _bcast(m.grain_size, invII) ** _bcast(m.diff_m, invII) \
        * arrhenius(_bcast(m.diff_E, invII), _bcast(m.diff_V, invII))
    # grain-boundary sliding
    has_gbs, Ag = safe(_bcast(m.gbs_A, invII))
    ng = _bcast(m.gbs_n, invII)
    eta_gbs = 0.5 / Ag * _bcast(m.grain_size, invII) ** _bcast(m.gbs_m, invII) \
        * inv_safe ** (1.0 - ng) * arrhenius(
            _bcast(m.gbs_E, invII), _bcast(m.gbs_V, invII))
    # Peierls creep, direct in tau mode: η = τ / (2 ε̇(τ))
    has_pei, Ap = safe(_bcast(m.peierls_A, invII))
    S = 0.0 if iRT is None else _bcast(m.peierls_E, invII) * iRT
    x = torch.clamp(inv_safe / _bcast(m.peierls_tauP, invII), 0.0, 1.0 - 1e-12)
    rate = Ap * inv_safe ** _bcast(m.peierls_n, invII) * torch.exp(
        -S * (1.0 - x ** _bcast(m.peierls_o, invII)) ** _bcast(m.peierls_q, invII))
    eta_pei = inv_safe / (2.0 * torch.clamp_min(rate, tiny))

    inv_eta = (
        torch.where(has_disl, 1.0 / eta_disl, 0.0)
        + torch.where(has_diff, 1.0 / eta_diff, 0.0)
        + torch.where(has_gbs, 1.0 / eta_gbs, 0.0)
        + torch.where(has_pei, 1.0 / eta_pei, 0.0)
    )
    any_creep = has_disl | has_diff | has_gbs | has_pei
    eta_p = torch.where(any_creep, 1.0 / torch.clamp_min(inv_eta, tiny),
                        _bcast(m.eta0, invII))
    if phase_ratios is None:
        return eta_p[..., 0]
    harm = 1.0 / torch.clamp_min(
        torch.sum(phase_ratios / torch.clamp_min(eta_p, tiny), dim=-1), tiny)
    idx = torch.argmax(phase_ratios, dim=-1, keepdim=True)
    eta_full = eta_p.expand(phase_ratios.shape)
    eta_dom = torch.gather(eta_full, -1, idx)[..., 0]
    dominant = torch.amax(phase_ratios, dim=-1) > 0.999
    return torch.where(dominant, eta_dom, harm)


def _is_linear_creep(material, like=None) -> bool:
    """No creep mechanism in any phase: the viscosity is η0 per phase. A
    bare material is stacked as ``like``."""
    m = _as_stack(material, like).params
    return not any(
        bool((getattr(m, a) > 0).any())
        for a in ("disl_A", "diff_A", "peierls_A", "gbs_A")
    )


def shared_powerlaw_exponent(material, like=None):
    """The shared stress power ``m = n − 1`` of ``1/η(τII) = A + B·τII^m``
    when the creep table collapses to it (dislocation creep with one shared
    ``n`` plus diffusion creep and linear phases); ``0.0`` when only
    diffusion creep is present; ``None`` when it does not collapse (Peierls
    or GBS mechanisms, mixed exponents) or is purely linear. A bare material
    is stacked as ``like``."""
    p = _as_stack(material, like).params
    if bool((p.peierls_A > 0).any()) or bool((p.gbs_A > 0).any()):
        return None
    ns = p.disl_n[p.disl_A > 0]
    if ns.numel() == 0:
        return 0.0 if bool((p.diff_A > 0).any()) else None
    if not bool((ns == ns[0]).all()):
        return None
    return float(ns[0]) - 1.0


def powerlaw_recip_coeffs(material, shape_like, T, phase_ratios):
    """Per-cell coefficients (A, B) of the collapsed tau-mode viscosity
    ``1/η(τII) = A + B·τII^m`` (valid when :func:`shared_powerlaw_exponent`
    is not None). Harmonic phase blending is linear in reciprocals, so the
    blend collapses exactly, dominant-phase exit included."""
    p = _as_stack(material, shape_like).params
    ref = shape_like
    tiny = _tiny(ref)
    A = _bcast(p.disl_A, ref)
    Ad = _bcast(p.diff_A, ref)
    if T is None:
        iRT = 0.0
    else:
        iRT = 1.0 / (R_GAS * torch.clamp_min(T[..., None], 1e-30))
    has_disl = A > 0
    has_diff = Ad > 0
    b_p = torch.where(has_disl, 2.0 * A * torch.exp(-_bcast(p.disl_E, ref) * iRT), 0.0)
    a_diff = torch.where(
        has_diff,
        2.0 * Ad * _bcast(p.grain_size, ref) ** (-_bcast(p.diff_m, ref))
        * torch.exp(-_bcast(p.diff_E, ref) * iRT),
        0.0,
    )
    a_p = torch.where(has_disl | has_diff, a_diff,
                      1.0 / torch.clamp_min(_bcast(p.eta0, ref), tiny))
    a_p = a_p.expand(tuple(ref.shape) + (a_p.shape[-1],))
    b_p = b_p.expand(tuple(ref.shape) + (b_p.shape[-1],))
    if phase_ratios is None:
        return a_p[..., 0], b_p[..., 0]
    A_cell = torch.sum(phase_ratios * a_p, dim=-1)
    B_cell = torch.sum(phase_ratios * b_p, dim=-1)
    idx = torch.argmax(phase_ratios, dim=-1, keepdim=True)
    dominant = torch.amax(phase_ratios, dim=-1) > 0.999
    return (
        torch.where(dominant, torch.gather(a_p, -1, idx)[..., 0], A_cell),
        torch.where(dominant, torch.gather(b_p, -1, idx)[..., 0], B_cell),
    )


def compute_viscosity_fields(
    eta, eta_v, material, xx, yy, xy_c, xx_v, yy_v, xy_v,
    phase_ratios_center, phase_ratios_vertex,
    T: Optional[torch.Tensor] = None,
    T_v: Optional[torch.Tensor] = None,
    mode: str = "tau",
    relaxation: float = 1.0,
    cutoff: Tuple[float, float] = (-float("inf"), float("inf")),
    P: Optional[torch.Tensor] = None,
    P_v: Optional[torch.Tensor] = None,
):
    """Update (η centers, ηv vertices) from the tensor fields: the invariant
    at centers uses (xx, yy, xy_c), at vertices (xx_v, yy_v, xy_v); an
    all-zero tensor gets an ε jitter so the invariant is never 0."""
    eps = torch.finfo(xx.dtype).eps

    def update(old, a, b, c, T_, pr, P_):
        eps0 = torch.where((a == 0) & (b == 0) & (c == 0), eps, 0.0).to(a.dtype)
        II = second_invariant(a + eps0, b - eps0, c)
        new = phase_viscosity(material, II, T_, pr, mode, P=P_)
        new = continuation_linear(new, old, relaxation)
        return torch.clamp(new, cutoff[0], cutoff[1])

    return (
        update(eta, xx, yy, xy_c, T, phase_ratios_center, P),
        update(eta_v, xx_v, yy_v, xy_v, T_v, phase_ratios_vertex, P_v),
    )
