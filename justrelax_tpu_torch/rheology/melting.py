"""Melt-fraction parameterizations and melt-dependent properties.

Counterpart of ``justrelax_tpu/rheology/melting.py``: explicit closures over
the whole temperature field (Kelvin), each with ``phi`` and ``dphi_dT``.

- :class:`MeltingCaricchi`: the sigmoid ϕ = 1/(1+exp((a − (T−c))/b)), with
  a = 800 °C, b = 23 K, c = 273.15 K by default.
- :class:`MeltingQuadratic`: ϕ = 1 − ((T_l − T)/(T_l − T_s))², clamped.
- :class:`MeltingPolynomial`: a clamped polynomial ϕ = Σ cᵢ·x^i with
  x = T/T_scale, valid on [T_s, T_l].
- :class:`NoMelting`: ϕ ≡ 0.

Then the melt-, bubble- and gas-dependent expansivities and density.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

__all__ = [
    "MeltingCaricchi",
    "MeltingQuadratic",
    "MeltingPolynomial",
    "NoMelting",
    "compute_melt_fraction",
    "melt_dependent_alpha",
    "bubble_flow_alpha",
    "gas_pyroclast_alpha",
    "melt_dependent_density",
]


@dataclass(frozen=True)
class NoMelting:
    """ϕ ≡ 0 (a phase that does not melt)."""

    def phi(self, T, P=None):
        return torch.zeros_like(T)

    def dphi_dT(self, T, P=None):
        return torch.zeros_like(T)


@dataclass(frozen=True)
class MeltingCaricchi:
    """Caricchi et al. (2007) sigmoid melting curve: θ = (a − (T − c))/b,
    ϕ = 1/(1+exp(θ))."""

    a: float = 800.0  # °C
    b: float = 23.0  # K
    c: float = 273.15  # K→°C shift

    def phi(self, T, P=None):
        theta = (self.a - (T - self.c)) / self.b
        return 1.0 / (1.0 + torch.exp(theta))

    def dphi_dT(self, T, P=None):
        phi = self.phi(T)
        return phi * (1.0 - phi) / self.b


@dataclass(frozen=True)
class MeltingQuadratic:
    """Quadratic melting curve between solidus ``Ts`` and liquidus ``Tl``:
    ϕ = 1 − ((Tl−T)/(Tl−Ts))²."""

    Ts: float = 963.15
    Tl: float = 1273.15

    def phi(self, T, P=None):
        x = (self.Tl - T) / (self.Tl - self.Ts)
        return torch.where(T >= self.Tl, 1.0, torch.clamp(1.0 - x * x, 0.0, 1.0))

    def dphi_dT(self, T, P=None):
        dTr = self.Tl - self.Ts
        x = (self.Tl - T) / dTr
        inside = (T > self.Ts) & (T < self.Tl)
        return torch.where(inside, 2.0 * x / dTr, 0.0)


@dataclass(frozen=True)
class MeltingPolynomial:
    """Clamped polynomial melting curve ϕ(x) = Σ coeffs[i]·x^i with
    x = T/T_scale, 0 below ``Ts`` and 1 above ``Tl``."""

    coeffs: Tuple[float, ...]
    Ts: float
    Tl: float
    T_scale: float = 1.0e3

    def phi(self, T, P=None):
        x = T / self.T_scale
        acc = torch.zeros_like(T)
        for c in reversed(self.coeffs):
            acc = acc * x + c
        acc = torch.clamp(acc, 0.0, 1.0)
        return torch.where(T <= self.Ts, 0.0, torch.where(T >= self.Tl, 1.0, acc))

    def dphi_dT(self, T, P=None):
        x = T / self.T_scale
        acc = torch.zeros_like(T)
        for i in range(len(self.coeffs) - 1, 0, -1):
            acc = acc * x + i * self.coeffs[i]
        inside = (T > self.Ts) & (T < self.Tl)
        return torch.where(inside, acc / self.T_scale, 0.0)


def compute_melt_fraction(melting, T, P: Optional[torch.Tensor] = None,
                          phase_ratios: Optional[torch.Tensor] = None):
    """Melt fraction field ϕ(T[, P]). ``melting`` is one parameterization or
    a sequence of them, one per phase; a sequence is weighted by
    ``phase_ratios`` (..., n_phase)."""
    if isinstance(melting, (list, tuple)):
        if phase_ratios is None:
            raise ValueError("phase_ratios required for multi-phase melting")
        phi = torch.zeros_like(T)
        for p, m in enumerate(melting):
            phi = phi + phase_ratios[..., p] * m.phi(T, P)
        return phi
    return melting.phi(T, P)


def melt_dependent_alpha(alpha_solid, alpha_melt, phi):
    """α = ϕ·α_melt + (1−ϕ)·α_solid."""
    return phi * alpha_melt + (1.0 - phi) * alpha_solid


def bubble_flow_alpha(alpha_melt, alpha_gas, P, c0, a):
    """Bubble-flow effective expansivity: gas mass fraction c = a·√|P| capped
    at c0; α = ((c0−c)/α_gas + (1−(c0−c))/α_melt)⁻¹."""
    c = torch.where(P < (c0 / a) ** 2, a * torch.sqrt(torch.abs(P)), c0)
    w = c0 - c
    return 1.0 / (w / alpha_gas + (1.0 - w) / alpha_melt)


def gas_pyroclast_alpha(alpha_melt, alpha_gas, delta):
    """Gas-pyroclast mixture expansivity."""
    return delta * alpha_gas + (1.0 - delta) * alpha_melt


def melt_dependent_density(rho_solid, rho_melt, phi):
    """ρ = ϕ·ρ_melt + (1−ϕ)·ρ_solid."""
    return phi * rho_melt + (1.0 - phi) * rho_solid
