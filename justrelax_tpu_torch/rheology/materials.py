"""Material parameters, phase-stacked.

Counterpart of ``justrelax_tpu/rheology/materials.py``: a
:class:`MaterialStack` holds every parameter as a ``(nphase,)`` tensor,
properties are evaluated for all phases at once, and multi-phase cells blend
them with phase-ratio weighted sums.

Parameterizations (unused parameters take neutral defaults): density
ρ = ρ0 (1 − α (T − T0) + β (P − P0)); volumetric heat capacity ρ·Cp,
conductivity k and radiogenic heat H_r; elastic moduli G and K (∞ means
rigid/incompressible); creep η0, dislocation, diffusion, Peierls and
grain-boundary sliding (see viscosity.py); Drucker-Prager plasticity with
softening and a tension cap (see plasticity.py).

Every function takes a :class:`MaterialStack` or a bare :class:`Material`
(or a list of them). A bare material is stacked on the device and in the
floating dtype of the field it is evaluated against (T, P, the phase ratios,
or ``like`` where a function has no field), as the JAX package evaluates it
wherever its fields are; an explicit stack stands as given.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from justrelax_tpu_torch.core.device import resolve_device

__all__ = [
    "Material",
    "MaterialStack",
    "phase_average",
    "compute_density",
    "compute_rhoCp",
    "compute_conductivity",
    "compute_radioactive_heating",
    "compute_diffusivity",
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
        device = resolve_device(device)
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


def _as_stack(material, like) -> MaterialStack:
    """``material`` as a stack. A bare ``Material`` or a list of them is
    stacked on the device of the tensor ``like`` and in its floating dtype
    (float64 for a non-floating ``like``); an explicit ``MaterialStack``
    stands as given. A bare material with no field to follow (``like`` is
    ``None``) raises ``ValueError``."""
    if isinstance(material, MaterialStack):
        return material
    if isinstance(material, Material):
        materials = [material]
    elif isinstance(material, (list, tuple)):
        materials = list(material)
    else:
        raise TypeError(f"cannot interpret {material!r} as MaterialStack")
    if like is None:
        raise ValueError(
            "a bare Material is evaluated on the device and in the dtype of "
            "its fields; none was given (pass a field, or a MaterialStack)")
    dtype = like.dtype if like.is_floating_point() else torch.float64
    return MaterialStack.make(materials, dtype=dtype, device=like.device)


def _field(*fields):
    """The first of ``fields`` that is not ``None`` (the field a bare
    material follows)."""
    return next((f for f in fields if f is not None), None)


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
    m = _as_stack(material, _field(T, P, phase_ratios)).params
    ref = T if T is not None else P
    rho0 = _bcast(m.rho0, ref)
    rho = rho0
    if T is not None:
        rho = rho * (1.0 - _bcast(m.alpha, ref) * (T[..., None] - _bcast(m.T0, ref)))
    if P is not None:
        beta = _bcast(m.beta, ref)
        rho = rho + rho0 * beta * (P[..., None] - _bcast(m.P0, ref))
    return phase_average(rho, phase_ratios)


def compute_rhoCp(material, T=None, P=None, phase_ratios=None):
    """ρ(T, P)·Cp per cell, phase-weighted on the product (not the
    factors)."""
    ref = T if T is not None else P
    stack = _as_stack(material, _field(T, P, phase_ratios)).params
    rho0 = _bcast(stack.rho0, ref)
    rho_p = rho0
    if T is not None:
        rho_p = rho_p * (1.0 - _bcast(stack.alpha, ref) * (T[..., None] - _bcast(stack.T0, ref)))
    if P is not None:
        rho_p = rho_p + rho0 * _bcast(stack.beta, ref) * (P[..., None] - _bcast(stack.P0, ref))
    rhoCp = rho_p * _bcast(stack.Cp, ref)
    return phase_average(rhoCp, phase_ratios)


def compute_conductivity(material, T=None, P=None, phase_ratios=None):
    """Conductivity k per cell; broadcast to ``T``'s shape when there are no
    phase ratios."""
    m = _as_stack(material, _field(T, P, phase_ratios)).params
    k = _bcast(m.k, T if T is not None else P)
    out = phase_average(k, phase_ratios)
    if phase_ratios is None and T is not None:
        out = out.expand(T.shape)
    return out


def compute_diffusivity(material, T=None, P=None, phase_ratios=None):
    """Thermal diffusivity κ = k/(ρ·Cp) per cell."""
    return compute_conductivity(material, T=T, P=P, phase_ratios=phase_ratios) / \
        compute_rhoCp(material, T=T, P=P, phase_ratios=phase_ratios)


def compute_radioactive_heating(material, phase_ratios=None, like=None):
    """Radiogenic heat H_r per cell (a 0-d tensor without phase ratios). A
    bare material follows ``phase_ratios``, or ``like`` without them."""
    m = _as_stack(material, _field(phase_ratios, like)).params
    return phase_average(m.H_r, phase_ratios)


def _phase_average_inf_safe(values, phase_ratios):
    """Ratio-weighted sum skipping zero-ratio phases (∞·0 would be NaN)."""
    if phase_ratios is None:
        return values[..., 0]
    contrib = torch.where(phase_ratios > 0, values * phase_ratios, 0.0)
    return torch.sum(contrib, dim=-1)


def get_shear_modulus(material, phase_ratios=None, like=None):
    """G per cell (∞ where G is 0 or NaN). A bare material follows
    ``phase_ratios``, or ``like`` without them."""
    m = _as_stack(material, _field(phase_ratios, like)).params
    G = torch.where((m.G == 0) | torch.isnan(m.G), _INF, m.G)
    return _phase_average_inf_safe(G, phase_ratios)


def get_bulk_modulus(material, phase_ratios=None, like=None):
    """K per cell (∞ where K is 0 or NaN). A bare material follows
    ``phase_ratios``, or ``like`` without them."""
    m = _as_stack(material, _field(phase_ratios, like)).params
    Kb = torch.where((m.Kb == 0) | torch.isnan(m.Kb), _INF, m.Kb)
    return _phase_average_inf_safe(Kb, phase_ratios)
