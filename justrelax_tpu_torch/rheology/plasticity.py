"""Drucker-Prager (regularized) plasticity, phase-weighted and branchless.

Counterpart of ``justrelax_tpu/rheology/plasticity.py``: per-phase
parameters with linear and non-linear softening are blended by phase ratios
(``plastic_params_phase``); the yield function is

  F = τII − Σ_pl r_p (C_p cosϕ_p + P sinϕ_p)

with an optional elliptic tension cap closing the cone at P = pT < 0, and the
pressure gradients of the active surface are (−sinϕ̄, −sinψ̄) on the cone or
the associated cap gradient.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from justrelax_tpu_torch.rheology.materials import _as_stack, _bcast

__all__ = [
    "PlasticParams",
    "plastic_params_phase",
    "yield_function",
    "flow_gradients_P",
    "second_invariant",
    "second_invariant_staggered",
]

_INF = float("inf")


class PlasticParams(NamedTuple):
    is_pl: torch.Tensor  # any plastic phase present (bool)
    pl_frac: torch.Tensor  # Σ ratio over plastic phases
    C_cosphi: torch.Tensor  # Σ_pl r·C·cosϕ
    sinphi: torch.Tensor
    cosphi: torch.Tensor
    sinpsi: torch.Tensor
    eta_reg: torch.Tensor
    pT: torch.Tensor  # tension-cap closure pressure (0 = no cap)
    dq_shear: torch.Tensor  # ∂Q/∂τ shear-slot multiplier: 1 … 0.5


def _soften(val, min_v, slope_active, lo, hi, EII):
    """Linear decay of ``val`` to ``min_v`` over EII ∈ [lo, hi]."""
    frac = torch.clamp((EII - lo) / torch.clamp_min(hi - lo, 1e-30), 0.0, 1.0)
    soft = val + (min_v - val) * frac
    return torch.where(slope_active, soft, val)


def plastic_params_phase(material, EII, phase_ratios: Optional[torch.Tensor]) -> PlasticParams:
    m = _as_stack(material, EII).params
    deg = math.pi / 180.0
    E = EII[..., None]

    C_p = _soften(
        _bcast(m.C, EII),
        _bcast(m.soft_C_min, EII),
        _bcast(m.soft_C_active, EII) > 0,
        _bcast(m.soft_strain_lo, EII),
        _bcast(m.soft_strain_hi, EII),
        E,
    )
    # non-linear cohesion softening: derived from ξ₀ alone, decaying
    # ξ₀ → ξ₀ − Δ with plastic strain
    nl_eps = torch.clamp_min(_bcast(m.soft_C_nl_eps_ref, EII), 1e-30)
    C_nl = _bcast(m.soft_C_nl_xi0, EII) - _bcast(m.soft_C_nl_delta, EII) * (
        1.0 - torch.exp(-E / nl_eps)
    )
    C_p = torch.where(_bcast(m.soft_C_nl, EII) > 0, C_nl, C_p)
    phi_p = _soften(
        _bcast(m.friction_angle, EII),
        _bcast(m.soft_phi_min, EII),
        _bcast(m.soft_phi_active, EII) > 0,
        _bcast(m.soft_strain_lo, EII),
        _bcast(m.soft_strain_hi, EII),
        E,
    )
    sinphi_p = torch.sin(phi_p * deg)
    cosphi_p = torch.cos(phi_p * deg)
    sinpsi_p = torch.sin(_bcast(m.dilation_angle, EII) * deg)
    w_pl = _bcast(torch.where(m.is_plastic > 0, 1.0, 0.0).to(m.C.dtype), EII)

    r = torch.ones_like(w_pl) if phase_ratios is None else phase_ratios
    rw = r * w_pl
    pl_frac = torch.sum(rw, dim=-1)
    return PlasticParams(
        is_pl=pl_frac > 0,
        pl_frac=pl_frac,
        C_cosphi=torch.sum(rw * C_p * cosphi_p, dim=-1),
        sinphi=torch.sum(rw * sinphi_p, dim=-1),
        cosphi=torch.sum(rw * cosphi_p, dim=-1),
        sinpsi=torch.sum(rw * sinpsi_p, dim=-1),
        eta_reg=torch.sum(rw * _bcast(m.eta_reg, EII), dim=-1),
        pT=torch.sum(rw * _bcast(m.tension_pT, EII), dim=-1),
        dq_shear=1.0 - 0.5 * torch.sum(rw * _bcast(m.dqdtau_alt, EII), dim=-1)
        / torch.clamp_min(pl_frac, 1e-30),
    )


def _tension_cap_yield(pp: PlasticParams, P):
    """Elliptic tension cap τ_cap(P) = C·cosϕ·√(1 − (P/pT)²) on P < 0."""
    ratio = torch.clamp(P / torch.where(pp.pT == 0.0, -_INF, pp.pT), 0.0, 1.0)
    cap = pp.C_cosphi * torch.sqrt(torch.clamp_min(1.0 - ratio**2, 0.0))
    return torch.where(P < 0.0, cap, _INF)


def yield_function(pp: PlasticParams, P, tau_II):
    """F = τII − min(cone, cap)."""
    tau_cone = pp.C_cosphi + P * pp.sinphi
    return tau_II - torch.minimum(tau_cone, _tension_cap_yield(pp, P))


def flow_gradients_P(pp: PlasticParams, P, tau_II):
    """(∂F/∂P, ∂Q/∂P) of the active surface: the cone (−sinϕ, −sinψ) or,
    where the tension cap is lower, the associated cap gradient."""
    pT = torch.where(pp.pT == 0.0, -_INF, pp.pT)
    ratio = torch.clamp(P / pT, 0.0, 1.0)
    root = torch.sqrt(torch.clamp_min(1.0 - ratio**2, 1e-12))
    dFdP_cap = pp.C_cosphi * P / torch.where(torch.isinf(pT), _INF, pT**2) / root
    on_cap = _tension_cap_yield(pp, P) < (pp.C_cosphi + P * pp.sinphi)
    dFdP = torch.where(on_cap, dFdP_cap, -pp.sinphi)
    dQdP = torch.where(on_cap, dFdP_cap, -pp.sinpsi)
    return dFdP, dQdP


def second_invariant(xx, yy, xy):
    """2D second invariant √(½(xx²+yy²) + xy²)."""
    return torch.sqrt(0.5 * (xx**2 + yy**2) + xy**2)


def second_invariant_staggered(xx, yy, xy_gathered4):
    """Staggered invariant: the shear term is the mean of the squared 4
    surrounding vertex values."""
    xy2 = sum(v**2 for v in xy_gathered4) / 4.0
    return torch.sqrt(0.5 * (xx**2 + yy**2) + xy2)
