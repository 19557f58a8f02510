"""Stokes and thermal solver states as dataclasses of tensors.

Counterpart of ``justrelax_tpu/core/state.py`` for 2D (``ni = (nx, ny)``),
with the same staggered shapes. Stokes:

  - cell centers ``(nx, ny)``: P, P0, ∇V, Q, τ.xx/yy/xy_c, ε.*, EII_pl, λ
  - vertices ``(nx+1, ny+1)``: τ.xy, τ.xx_v/yy_v, ω.xy, λv, viscosity.ηv
  - velocities with ghost rows on the transverse axis:
      Vx ``(nx+1, ny+2)``, Vy ``(nx+2, ny+1)``
  - momentum residuals Rx ``(nx-1, ny)``, Ry ``(nx, ny-1)``

Thermal (``ThermalState``): T, Told and dT with one ghost node per face
``(nx+2, ny+2)``; fluxes on faces qTx/qTx2 ``(nx+1, ny)``, qTy/qTy2
``(nx, ny+1)``; adiabatic, dT_dt, H, shear_heating and ResT at centers.

The 3D-only fields keep their names and stay ``None``, so a state converts
field for field to and from the JAX package (``justrelax_tpu_torch.convert``).
Solvers return new states; ``state.replace(field=value)`` builds one.
``dtype`` defaults to float64, the type the goldens are held in; ``device``
to the card (``core/device.py::resolve_device``: pass ``"cpu"`` for the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from justrelax_tpu_torch.core.device import resolve_device

Tensor = torch.Tensor

__all__ = [
    "Velocity",
    "Displacement",
    "Vorticity",
    "Viscosity",
    "SymmetricTensor",
    "Residual",
    "StokesState",
    "ThermalState",
]


def _dtype(dtype):
    return torch.float64 if dtype is None else dtype


def _zeros(shape, dtype, device):
    return torch.zeros(shape, dtype=_dtype(dtype), device=resolve_device(device))


def _check_2d(ni):
    if len(ni) != 2:
        raise NotImplementedError("the PyTorch port covers 2D grids only")
    return tuple(int(n) for n in ni)


class _Replace:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Velocity(_Replace):
    Vx: Tensor
    Vy: Tensor
    Vz: Optional[Tensor] = None

    @classmethod
    def make(cls, ni, dtype=None, device=None) -> "Velocity":
        nx, ny = _check_2d(ni)
        return cls(
            Vx=_zeros((nx + 1, ny + 2), dtype, device),
            Vy=_zeros((nx + 2, ny + 1), dtype, device),
        )

    @property
    def components(self):
        return (self.Vx, self.Vy)


@dataclasses.dataclass(frozen=True)
class Displacement(_Replace):
    Ux: Tensor
    Uy: Tensor
    Uz: Optional[Tensor] = None

    @classmethod
    def make(cls, ni, dtype=None, device=None) -> "Displacement":
        v = Velocity.make(ni, dtype, device)
        return cls(Ux=v.Vx, Uy=v.Vy)

    @property
    def components(self):
        return (self.Ux, self.Uy)


@dataclasses.dataclass(frozen=True)
class Vorticity(_Replace):
    xy: Tensor
    yz: Optional[Tensor] = None
    xz: Optional[Tensor] = None

    @classmethod
    def make(cls, ni, dtype=None, device=None) -> "Vorticity":
        nx, ny = _check_2d(ni)
        return cls(xy=_zeros((nx + 1, ny + 1), dtype, device))


@dataclasses.dataclass(frozen=True)
class Viscosity(_Replace):
    """η (centers), ηv (vertices), η_vep (centers), ητ (PT preconditioner)."""

    eta: Tensor
    eta_v: Tensor
    eta_vep: Tensor
    eta_tau: Tensor

    @classmethod
    def make(cls, ni, dtype=None, device=None) -> "Viscosity":
        ni = _check_2d(ni)
        ni_v = tuple(n + 1 for n in ni)
        kw = dict(dtype=_dtype(dtype), device=resolve_device(device))
        return cls(
            eta=torch.ones(ni, **kw),
            eta_v=torch.ones(ni_v, **kw),
            eta_vep=torch.ones(ni, **kw),
            eta_tau=torch.zeros(ni, **kw),
        )


@dataclasses.dataclass(frozen=True)
class SymmetricTensor(_Replace):
    """Normal components at centers (xx, yy) and vertices (xx_v, yy_v);
    shear at vertices (xy) and centers (xy_c); II at centers."""

    xx: Tensor
    yy: Tensor
    xx_v: Tensor
    yy_v: Tensor
    xy: Tensor
    xy_c: Tensor
    II: Tensor
    zz: Optional[Tensor] = None
    zz_v: Optional[Tensor] = None
    yz: Optional[Tensor] = None
    xz: Optional[Tensor] = None
    yz_c: Optional[Tensor] = None
    xz_c: Optional[Tensor] = None

    @classmethod
    def make(cls, ni, dtype=None, device=None) -> "SymmetricTensor":
        nx, ny = _check_2d(ni)
        nc, nv = (nx, ny), (nx + 1, ny + 1)
        return cls(
            xx=_zeros(nc, dtype, device),
            yy=_zeros(nc, dtype, device),
            xx_v=_zeros(nv, dtype, device),
            yy_v=_zeros(nv, dtype, device),
            xy=_zeros(nv, dtype, device),
            xy_c=_zeros(nc, dtype, device),
            II=_zeros(nc, dtype, device),
        )

    @property
    def normal(self):
        return (self.xx, self.yy)

    @property
    def shear(self):
        return (self.xy,)


@dataclasses.dataclass(frozen=True)
class Residual(_Replace):
    RP: Tensor
    Rx: Tensor
    Ry: Tensor
    Rz: Optional[Tensor] = None

    @classmethod
    def make(cls, ni, dtype=None, device=None) -> "Residual":
        nx, ny = _check_2d(ni)
        return cls(
            RP=_zeros((nx, ny), dtype, device),
            Rx=_zeros((nx - 1, ny), dtype, device),
            Ry=_zeros((nx, ny - 1), dtype, device),
        )


@dataclasses.dataclass(frozen=True)
class StokesState(_Replace):
    """Full Stokes solver state (the JAX package's ``StokesState``)."""

    P: Tensor
    P0: Tensor
    V: Velocity
    grad_V: Tensor
    Q: Tensor
    tau: SymmetricTensor
    eps: SymmetricTensor
    eps_pl: SymmetricTensor
    EII_pl: Tensor
    EVol_pl: Tensor
    eps_vol_pl: Tensor
    viscosity: Viscosity
    tau_o: SymmetricTensor
    R: Residual
    U: Displacement
    omega: Vorticity
    d_eps: SymmetricTensor
    grad_U: Tensor
    lam: Tensor
    lam_v: Tensor
    dP_psi: Tensor

    @classmethod
    def make(cls, ni: Tuple[int, ...], dtype=None, device=None) -> "StokesState":
        ni = _check_2d(ni)
        ni_v = tuple(n + 1 for n in ni)
        device = resolve_device(device)

        def z(shape=ni):
            return _zeros(shape, dtype, device)

        return cls(
            P=z(),
            P0=z(),
            V=Velocity.make(ni, dtype, device),
            grad_V=z(),
            Q=z(),
            tau=SymmetricTensor.make(ni, dtype, device),
            eps=SymmetricTensor.make(ni, dtype, device),
            eps_pl=SymmetricTensor.make(ni, dtype, device),
            EII_pl=z(),
            EVol_pl=z(),
            eps_vol_pl=z(),
            viscosity=Viscosity.make(ni, dtype, device),
            tau_o=SymmetricTensor.make(ni, dtype, device),
            R=Residual.make(ni, dtype, device),
            U=Displacement.make(ni, dtype, device),
            omega=Vorticity.make(ni, dtype, device),
            d_eps=SymmetricTensor.make(ni, dtype, device),
            grad_U=z(),
            lam=z(),
            lam_v=z(ni_v),
            dP_psi=z(),
        )

    @property
    def ni(self) -> Tuple[int, ...]:
        return tuple(self.P.shape)

    @property
    def ndim(self) -> int:
        return self.P.ndim


@dataclasses.dataclass(frozen=True)
class ThermalState(_Replace):
    """Thermal solver state (the JAX package's ``ThermalState``)."""

    T: Tensor
    Told: Tensor
    dT: Tensor
    adiabatic: Tensor
    dT_dt: Tensor
    qTx: Tensor
    qTy: Tensor
    qTx2: Tensor
    qTy2: Tensor
    H: Tensor
    shear_heating: Tensor
    ResT: Tensor
    qTz: Optional[Tensor] = None
    qTz2: Optional[Tensor] = None

    @classmethod
    def make(cls, ni: Tuple[int, ...], dtype=None, device=None) -> "ThermalState":
        nx, ny = _check_2d(ni)
        device = resolve_device(device)

        def z(shape):
            return _zeros(shape, dtype, device)

        ni, ni_g = (nx, ny), (nx + 2, ny + 2)
        qx, qy = (nx + 1, ny), (nx, ny + 1)
        return cls(
            T=z(ni_g), Told=z(ni_g), dT=z(ni_g), adiabatic=z(ni), dT_dt=z(ni),
            qTx=z(qx), qTy=z(qy), qTx2=z(qx), qTy2=z(qy),
            H=z(ni), shear_heating=z(ni), ResT=z(ni),
        )

    @property
    def ni(self) -> Tuple[int, ...]:
        return tuple(self.H.shape)

    @property
    def T_inner(self) -> Tensor:
        """Interior (non-ghost) temperature view."""
        return self.T[1:-1, 1:-1]
