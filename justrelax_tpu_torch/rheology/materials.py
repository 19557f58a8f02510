"""Material parameters, phase-stacked.

Counterpart of ``justrelax_tpu/rheology/materials.py``: a
:class:`MaterialStack` holds every parameter as a ``(nphase,)`` tensor,
properties are evaluated for all phases at once, and multi-phase cells blend
them with phase-ratio weighted sums.

Parameterizations (unused parameters take neutral defaults): density
ρ = ρ0 (1 − α (T − T0) + β (P − P0)); elastic moduli G and K (∞ means
rigid/incompressible); creep η0, dislocation, diffusion, Peierls and
grain-boundary sliding (see viscosity.py); Drucker-Prager plasticity with
softening and a tension cap (see plasticity.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

__all__ = [
    "Material",
    "MaterialStack",
    "phase_average",
    "compute_density",
    "get_shear_modulus",
    "get_bulk_modulus",
]

_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class Material:
    """Single-phase parameters (floats), or, inside a :class:`MaterialStack`,
    ``(nphase,)`` tensors. Field meanings as in the JAX package."""

    rho0: float = 0.0
    alpha: float = 0.0
    beta: float = 0.0
    T0: float = 0.0
    P0: float = 0.0
    Cp: float = 0.0
    k: float = 0.0
    H_r: float = 0.0
    G: float = _INF
    Kb: float = _INF
    eta0: float = 1.0
    disl_A: float = 0.0
    disl_n: float = 1.0
    disl_E: float = 0.0
    disl_V: float = 0.0
    diff_A: float = 0.0
    diff_E: float = 0.0
    diff_V: float = 0.0
    diff_m: float = 0.0
    grain_size: float = 1.0e-3
    peierls_A: float = 0.0
    peierls_n: float = 2.0
    peierls_E: float = 0.0
    peierls_q: float = 1.0
    peierls_o: float = 0.5
    peierls_tauP: float = _INF
    gbs_A: float = 0.0
    gbs_n: float = 1.0
    gbs_m: float = 0.0
    gbs_E: float = 0.0
    gbs_V: float = 0.0
    is_plastic: float = 0.0
    C: float = 0.0
    friction_angle: float = 0.0
    dilation_angle: float = 0.0
    eta_reg: float = 0.0
    tension_pT: float = 0.0
    dqdtau_alt: float = 0.0
    soft_C_active: float = 0.0
    soft_C_min: float = 0.0
    soft_phi_active: float = 0.0
    soft_phi_min: float = 0.0
    soft_strain_lo: float = 0.0
    soft_strain_hi: float = 1.0
    soft_C_nl: float = 0.0
    soft_C_nl_xi0: float = 0.0
    soft_C_nl_delta: float = 0.0
    soft_C_nl_eps_ref: float = 1.0e-2
    gravity: float = 0.0


FIELDS = tuple(f.name for f in dataclasses.fields(Material))


@dataclasses.dataclass(frozen=True)
class MaterialStack:
    """``nphase`` materials stacked: every field of ``params`` has shape
    ``(nphase,)``."""

    params: Material

    @classmethod
    def make(cls, materials: Sequence[Material], dtype=None,
             device=None) -> "MaterialStack":
        dtype = torch.float64 if dtype is None else dtype
        fields = {
            name: torch.tensor(
                [float(getattr(m, name)) for m in materials],
                dtype=dtype, device=device,
            )
            for name in FIELDS
        }
        return cls(params=Material(**fields))

    def to(self, device=None, dtype=None) -> "MaterialStack":
        return MaterialStack(params=Material(**{
            name: getattr(self.params, name).to(device=device, dtype=dtype)
            for name in FIELDS
        }))

    @property
    def nphase(self) -> int:
        return int(self.params.rho0.shape[0])

    @property
    def dtype(self):
        return self.params.rho0.dtype


def _as_stack(material) -> MaterialStack:
    if isinstance(material, MaterialStack):
        return material
    if isinstance(material, Material):
        return MaterialStack.make([material])
    if isinstance(material, (list, tuple)):
        return MaterialStack.make(list(material))
    raise TypeError(f"cannot interpret {material!r} as MaterialStack")


def phase_average(values, phase_ratios: Optional[torch.Tensor]):
    """Phase-ratio weighted sum over the last axis; phase 0 when
    ``phase_ratios`` is None."""
    if phase_ratios is None:
        return values[..., 0]
    return torch.sum(values * phase_ratios, dim=-1)


def _bcast(param, T):
    """Broadcast a (nphase,) parameter against a (*grid,) field."""
    if T is None:
        return param
    return param.reshape((1,) * T.ndim + (-1,))


def compute_density(material, T=None, P=None, phase_ratios=None):
    """ρ(T, P) per cell (GeoParams PT_Density)."""
    m = _as_stack(material).params
    ref = T if T is not None else P
    rho0 = _bcast(m.rho0, ref)
    rho = rho0
    if T is not None:
        rho = rho * (1.0 - _bcast(m.alpha, ref) * (T[..., None] - _bcast(m.T0, ref)))
    if P is not None:
        beta = _bcast(m.beta, ref)
        rho = rho + rho0 * beta * (P[..., None] - _bcast(m.P0, ref))
    return phase_average(rho, phase_ratios)


def _phase_average_inf_safe(values, phase_ratios):
    """Ratio-weighted sum skipping zero-ratio phases (∞·0 would be NaN)."""
    if phase_ratios is None:
        return values[..., 0]
    contrib = torch.where(phase_ratios > 0, values * phase_ratios, 0.0)
    return torch.sum(contrib, dim=-1)


def get_shear_modulus(material, phase_ratios=None):
    m = _as_stack(material).params
    G = torch.where((m.G == 0) | torch.isnan(m.G), _INF, m.G)
    return _phase_average_inf_safe(G, phase_ratios)


def get_bulk_modulus(material, phase_ratios=None):
    m = _as_stack(material).params
    Kb = torch.where((m.Kb == 0) | torch.isnan(m.Kb), _INF, m.Kb)
    return _phase_average_inf_safe(Kb, phase_ratios)
