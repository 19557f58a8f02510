"""Pseudo-transient (PT) relaxation coefficients of the Stokes solver.

Counterpart of ``justrelax_tpu/core/coeffs.py::PTStokesCoeffs``:

    Vpdτ = CFL · min(di),  lτ = min(li)
    θ_dτ = lτ (r + 4/3) / (Re · Vpdτ)
    ηdτ  = Vpdτ · lτ / Re

with defaults Re = 3π, r = 0.7, CFL = 0.9/√2.1 (2D) or 0.9/√3.1 (3D). All
coefficients are Python floats.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

__all__ = ["PTStokesCoeffs"]


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
