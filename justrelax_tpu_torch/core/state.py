"""Stokes and thermal solver states as dataclasses of tensors.

Counterpart of ``justrelax_tpu/core/state.py`` for 2D (``ni = (nx, ny)``)
and 3D (``ni = (nx, ny, nz)``), with the same staggered shapes. Stokes, 2D:

  - cell centers ``(nx, ny)``: P, P0, ∇V, Q, τ.xx/yy/xy_c, ε.*, EII_pl, λ
  - vertices ``(nx+1, ny+1)``: τ.xy, τ.xx_v/yy_v, ω.xy, λv, viscosity.ηv
  - velocities with ghost rows on the transverse axis:
      Vx ``(nx+1, ny+2)``, Vy ``(nx+2, ny+1)``
  - momentum residuals Rx ``(nx-1, ny)``, Ry ``(nx, ny-1)``

3D adds the z analogues: Vx ``(nx+1, ny+2, nz+2)``, Vy ``(nx+2, ny+1, nz+2)``,
Vz ``(nx+2, ny+2, nz+1)``; τ/ε shear components on cell edges, yz
``(nx, ny+1, nz+1)``, xz ``(nx+1, ny, nz+1)``, xy ``(nx+1, ny+1, nz)``, and
at centers (``*_c``); normal components also at vertices (``*_v``); Rz
``(nx, ny, nz-1)``; vorticity on the edges.

Thermal (``ThermalState``): T, Told and dT with one ghost node per face
``(nx+2, ny+2[, nz+2])``; fluxes on faces qTx/qTx2 ``(nx+1, ny[, nz])``,
qTy/qTy2 ``(nx, ny+1[, nz])`` and, in 3D, qTz/qTz2 ``(nx, ny, nz+1)``;
adiabatic, dT_dt, H, shear_heating and ResT at centers.

In 2D the 3D-only fields keep their names and stay ``None``, so a state
converts field for field to and from the JAX package
(``justrelax_tpu_torch.convert``).
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


def _check_ni(ni):
    if len(ni) not in (2, 3):
        raise ValueError(f"a state is 2D or 3D, got ni={tuple(ni)}")
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
        ni = _check_ni(ni)
        if len(ni) == 2:
            nx, ny = ni
            return cls(
                Vx=_zeros((nx + 1, ny + 2), dtype, device),
                Vy=_zeros((nx + 2, ny + 1), dtype, device),
            )
        nx, ny, nz = ni
        return cls(
            Vx=_zeros((nx + 1, ny + 2, nz + 2), dtype, device),
            Vy=_zeros((nx + 2, ny + 1, nz + 2), dtype, device),
            Vz=_zeros((nx + 2, ny + 2, nz + 1), dtype, device),
        )

    @property
    def components(self):
        if self.Vz is None:
            return (self.Vx, self.Vy)
        return (self.Vx, self.Vy, self.Vz)


@dataclasses.dataclass(frozen=True)
class Displacement(_Replace):
    Ux: Tensor
    Uy: Tensor
    Uz: Optional[Tensor] = None

    @classmethod
    def make(cls, ni, dtype=None, device=None) -> "Displacement":
        v = Velocity.make(ni, dtype, device)
        return cls(Ux=v.Vx, Uy=v.Vy, Uz=v.Vz)

    @property
    def components(self):
        if self.Uz is None:
            return (self.Ux, self.Uy)
        return (self.Ux, self.Uy, self.Uz)


@dataclasses.dataclass(frozen=True)
class Vorticity(_Replace):
    xy: Tensor
    yz: Optional[Tensor] = None
    xz: Optional[Tensor] = None

    @classmethod
    def make(cls, ni, dtype=None, device=None) -> "Vorticity":
        ni = _check_ni(ni)
        if len(ni) == 2:
            nx, ny = ni
            return cls(xy=_zeros((nx + 1, ny + 1), dtype, device))
        nx, ny, nz = ni
        return cls(
            xy=_zeros((nx + 1, ny + 1, nz), dtype, device),
            yz=_zeros((nx, ny + 1, nz + 1), dtype, device),
            xz=_zeros((nx + 1, ny, nz + 1), dtype, device),
        )


@dataclasses.dataclass(frozen=True)
class Viscosity(_Replace):
    """η (centers), ηv (vertices), η_vep (centers), ητ (PT preconditioner)."""

    eta: Tensor
    eta_v: Tensor
    eta_vep: Tensor
    eta_tau: Tensor

    @classmethod
    def make(cls, ni, dtype=None, device=None) -> "Viscosity":
        ni = _check_ni(ni)
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
    """Normal components at centers (xx, yy[, zz]) and vertices (xx_v,
    yy_v[, zz_v]); shear at vertices in 2D and on cell edges in 3D (xy[, yz,
    xz]) and at centers (xy_c[, yz_c, xz_c]); II at centers."""

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
        nc = _check_ni(ni)
        nv = tuple(n + 1 for n in nc)

        def z(shape):
            return _zeros(shape, dtype, device)

        if len(nc) == 2:
            return cls(xx=z(nc), yy=z(nc), xx_v=z(nv), yy_v=z(nv), xy=z(nv),
                       xy_c=z(nc), II=z(nc))
        nx, ny, nz = nc
        return cls(
            xx=z(nc), yy=z(nc), zz=z(nc),
            xx_v=z(nv), yy_v=z(nv), zz_v=z(nv),
            xy=z((nx + 1, ny + 1, nz)),
            yz=z((nx, ny + 1, nz + 1)),
            xz=z((nx + 1, ny, nz + 1)),
            xy_c=z(nc), yz_c=z(nc), xz_c=z(nc),
            II=z(nc),
        )

    @property
    def normal(self):
        if self.zz is None:
            return (self.xx, self.yy)
        return (self.xx, self.yy, self.zz)

    @property
    def shear(self):
        if self.zz is None:
            return (self.xy,)
        return (self.yz, self.xz, self.xy)


@dataclasses.dataclass(frozen=True)
class Residual(_Replace):
    RP: Tensor
    Rx: Tensor
    Ry: Tensor
    Rz: Optional[Tensor] = None

    @classmethod
    def make(cls, ni, dtype=None, device=None) -> "Residual":
        ni = _check_ni(ni)
        if len(ni) == 2:
            nx, ny = ni
            return cls(
                RP=_zeros((nx, ny), dtype, device),
                Rx=_zeros((nx - 1, ny), dtype, device),
                Ry=_zeros((nx, ny - 1), dtype, device),
            )
        nx, ny, nz = ni
        return cls(
            RP=_zeros(ni, dtype, device),
            Rx=_zeros((nx - 1, ny, nz), dtype, device),
            Ry=_zeros((nx, ny - 1, nz), dtype, device),
            Rz=_zeros((nx, ny, nz - 1), dtype, device),
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
        ni = _check_ni(ni)
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
        ni = _check_ni(ni)
        device = resolve_device(device)

        def z(shape):
            return None if shape is None else _zeros(shape, dtype, device)

        ni_g = tuple(n + 2 for n in ni)
        if len(ni) == 2:
            nx, ny = ni
            qx, qy, qz = (nx + 1, ny), (nx, ny + 1), None
        else:
            nx, ny, nz = ni
            qx, qy, qz = (nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)
        return cls(
            T=z(ni_g), Told=z(ni_g), dT=z(ni_g), adiabatic=z(ni), dT_dt=z(ni),
            qTx=z(qx), qTy=z(qy), qTx2=z(qx), qTy2=z(qy),
            H=z(ni), shear_heating=z(ni), ResT=z(ni), qTz=z(qz), qTz2=z(qz),
        )

    @property
    def ni(self) -> Tuple[int, ...]:
        return tuple(self.H.shape)

    @property
    def T_inner(self) -> Tensor:
        """Interior (non-ghost) temperature view."""
        return self.T[(slice(1, -1),) * self.T.ndim]
