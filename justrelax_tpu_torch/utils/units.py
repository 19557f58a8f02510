"""Nondimensionalization (GeoParams ``GEO_units``/``CharDim`` equivalent).

Counterpart of ``justrelax_tpu/utils/units.py`` (plain Python, copied so
that the port imports nothing of the JAX package).

The reference's dimensional miniapps (thermal-stress magma chamber,
Caldera/Volcano2D) nondimensionalize all inputs with GeoParams
characteristic scales (``CharDim = GEO_units(length=…, viscosity=…,
temperature=…)``; SURVEY §2.4) so the solver works near O(1). This module
reproduces that: four base scales — length L, temperature Θ, viscosity η,
stress σ — derive every other quantity via dimensional analysis
(t = η/σ, mass from ρ = σ t²/L², …).

``nondimensionalize(value, "velocity", u)`` / ``dimensionalize`` work on
scalars and arrays; quantity names follow the table below.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

__all__ = ["CharacteristicUnits", "geo_units", "nondimensionalize", "dimensionalize"]

# dimension exponents (M, L, T, Θ) per named quantity
_DIMS: Dict[str, tuple] = {
    "length": (0, 1, 0, 0),
    "time": (0, 0, 1, 0),
    "velocity": (0, 1, -1, 0),
    "acceleration": (0, 1, -2, 0),
    "gravity": (0, 1, -2, 0),
    "temperature": (0, 0, 0, 1),
    "mass": (1, 0, 0, 0),
    "density": (1, -3, 0, 0),
    "stress": (1, -1, -2, 0),
    "pressure": (1, -1, -2, 0),
    "viscosity": (1, -1, -1, 0),
    "strain_rate": (0, 0, -1, 0),
    "compressibility": (-1, 1, 2, 0),  # 1/Pa
    "heat_capacity": (0, 2, -2, -1),  # J/kg/K
    "conductivity": (1, 1, -3, -1),  # W/m/K
    "heat_production": (1, -1, -3, 0),  # W/m³
    "heat_flux": (1, 0, -3, 0),  # W/m²
    "diffusivity": (0, 2, -1, 0),
    "expansivity": (0, 0, 0, -1),  # 1/K
    "energy": (1, 2, -2, 0),
    "power": (1, 2, -3, 0),
    "force": (1, 1, -2, 0),
    "force_density": (1, -2, -2, 0),  # N/m³ = ρ·g
    "dimensionless": (0, 0, 0, 0),
}


@dataclasses.dataclass(frozen=True)
class CharacteristicUnits:
    """Base characteristic scales (SI): length [m], temperature [K],
    viscosity [Pa·s], stress [Pa]; everything else derived."""

    length: float
    temperature: float
    viscosity: float
    stress: float

    @property
    def time(self) -> float:
        return self.viscosity / self.stress

    @property
    def mass(self) -> float:
        # from ρ_c = σ·t²/L² and M = ρ·L³
        return self.stress * self.time**2 * self.length

    def scale(self, quantity: str) -> float:
        """Characteristic magnitude of the named quantity."""
        try:
            a, b, c, d = _DIMS[quantity]
        except KeyError:
            raise KeyError(
                f"unknown quantity {quantity!r}; known: {sorted(_DIMS)}"
            ) from None
        return (
            self.mass**a * self.length**b * self.time**c * self.temperature**d
        )


def geo_units(
    length: float = 10.0e3,
    temperature: float = 1000.0,
    viscosity: float = 1.0e20,
    stress: float = 10.0e6,
) -> CharacteristicUnits:
    """GeoParams ``GEO_units`` defaults: 10 km, 1000 K, 1e20 Pa·s, 10 MPa."""
    return CharacteristicUnits(
        length=float(length),
        temperature=float(temperature),
        viscosity=float(viscosity),
        stress=float(stress),
    )


def nondimensionalize(value, quantity: str, units: CharacteristicUnits):
    """value / characteristic(quantity) — works on scalars and arrays."""
    return value / units.scale(quantity)


def dimensionalize(value, quantity: str, units: CharacteristicUnits):
    return value * units.scale(quantity)
