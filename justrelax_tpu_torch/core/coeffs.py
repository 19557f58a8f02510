"""Pseudo-transient (PT) relaxation coefficients of the Stokes and thermal
solvers.

Counterpart of ``justrelax_tpu/core/coeffs.py``. ``PTStokesCoeffs``:

    Vpdτ = CFL · min(di),  lτ = min(li)
    θ_dτ = lτ (r + 4/3) / (Re · Vpdτ)
    ηdτ  = Vpdτ · lτ / Re

with defaults Re = 3π, r = 0.7, CFL = 0.9/√2.1 (2D) or 0.9/√3.1 (3D). All
coefficients are Python floats.

``PTThermalCoeffs`` holds the cellwise θr_dτ and dτ_ρ of the thermal solver
(tensors at cell centers) beside its scalars:

    Vpdτ = CFL · min(di),  L = max(li)
    Re   = π + √(π² + ρCp·L²/(K·dt))
    θr_dτ = L / Vpdτ / Re,  dτ_ρ = Vpdτ · L / K / Re
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

__all__ = ["PTStokesCoeffs", "PTThermalCoeffs"]


@dataclasses.dataclass(frozen=True)
class PTStokesCoeffs:
    CFL: float
    eps_rel: float
    eps_abs: float
    Re: float
    r: float
    Vpdtau: float
    theta_dtau: float
    etadtau: float

    @classmethod
    def make(
        cls,
        li: Tuple[float, ...],
        di: Tuple[float, ...],
        eps_rel: float = 1.0e-6,
        eps_abs: float = 1.0e-12,
        Re: float = 3.0 * math.pi,
        CFL: Optional[float] = None,
        r: float = 0.7,
    ) -> "PTStokesCoeffs":
        if CFL is None:
            CFL = 0.9 / math.sqrt(2.1) if len(li) == 2 else 0.9 / math.sqrt(3.1)
        ltau = min(li)
        Vpdtau = min(di) * CFL
        return cls(
            CFL=float(CFL),
            eps_rel=float(eps_rel),
            eps_abs=float(eps_abs),
            Re=float(Re),
            r=float(r),
            Vpdtau=float(Vpdtau),
            theta_dtau=float(ltau * (r + 4.0 / 3.0) / (Re * Vpdtau)),
            etadtau=float(Vpdtau * ltau / Re),
        )


def _as_float_tensor(x):
    """A tensor as it is; a Python number as a float64 0-d tensor (the JAX
    package's x64 scalar)."""
    return x if isinstance(x, torch.Tensor) else torch.tensor(float(x), dtype=torch.float64)


def _rdiv(c, t):
    """``c / t`` for a number ``c`` and a tensor ``t``, rounded as one
    division (``float / tensor`` is reciprocal·float in torch)."""
    return torch.full_like(t, c) / t


@dataclasses.dataclass(frozen=True)
class PTThermalCoeffs:
    """Cellwise PT coefficients of the thermal diffusion solver:
    ``theta_r_dtau`` and ``dtau_rho`` have the shape of the cell centers (of
    ``K``/``ρCp``); the scalars are Python floats."""

    CFL: float
    eps: float
    max_lxyz: float
    Vpdtau: float
    theta_r_dtau: Optional[torch.Tensor] = None
    dtau_rho: Optional[torch.Tensor] = None

    @classmethod
    def make(cls, K, rho_Cp, dt: float, di: Tuple[float, ...], li: Tuple[float, ...],
             eps: float = 1.0e-8, CFL: float = 0.9 / math.sqrt(3.0)) -> "PTThermalCoeffs":
        """From conductivity and volumetric heat capacity tensors (or
        scalars)."""
        Vpdtau = min(di) * CFL
        max_lxyz = max(li)
        K = _as_float_tensor(K)
        rho_Cp = _as_float_tensor(rho_Cp)
        Re = math.pi + torch.sqrt(math.pi**2 + rho_Cp * max_lxyz**2 / K / dt)
        return cls(
            CFL=float(CFL), eps=float(eps), max_lxyz=float(max_lxyz), Vpdtau=float(Vpdtau),
            theta_r_dtau=_rdiv(max_lxyz / Vpdtau, Re),
            dtau_rho=_rdiv(Vpdtau * max_lxyz, K) / Re,
        )

    @classmethod
    def from_material(cls, material, T_center, P, dt: float, di: Tuple[float, ...],
                      li: Tuple[float, ...], phase_ratios=None, eps: float = 1.0e-8,
                      CFL: float = 0.9 / math.sqrt(3.0)) -> "PTThermalCoeffs":
        """From a material evaluated at the cell centers (``T_center`` is the
        interior temperature, without ghosts)."""
        from justrelax_tpu_torch.rheology.materials import compute_conductivity, compute_rhoCp

        Vpdtau = min(di) * CFL
        max_lxyz = max(li)
        rho_Cp = compute_rhoCp(material, T=T_center, P=P, phase_ratios=phase_ratios)
        K = compute_conductivity(material, T=T_center, P=P, phase_ratios=phase_ratios)
        inv_Re = 1.0 / (math.pi + torch.sqrt(math.pi**2 + rho_Cp * max_lxyz**2 / (K * dt)))
        return cls(
            CFL=float(CFL), eps=float(eps), max_lxyz=float(max_lxyz), Vpdtau=float(Vpdtau),
            theta_r_dtau=max_lxyz / Vpdtau * inv_Re,
            dtau_rho=_rdiv(Vpdtau * max_lxyz, K) * inv_Re,
        )
