"""Ghost-node velocity and temperature boundary conditions on the staggered
grid: velocity BCs in 2D and 3D, temperature BCs in 2D.

Counterpart of ``justrelax_tpu/ops/bc.py``. BC configs are frozen
dataclasses; ``flow_bcs`` and ``thermal_bcs`` return new tensors. Face
naming: ``left``/``right`` bound the x-axis; in 2D ``bot``/``top`` bound the
y-axis; in 3D ``front``/``back`` bound the y-axis and ``top``/``bot`` the
z-axis (``top`` at z index 0). Application order (later writes win): flow
no-slip, then free-slip (2D over bot, top, left, right; 3D over front, back,
top, bot, left, right); thermal constant_value, then no_flux, then periodic,
each over the faces bot, top, left, right. Each face writes its whole ghost
line or plane, edges and corners included, so the order decides them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

__all__ = [
    "Faces",
    "TemperatureBoundaryConditions",
    "VelocityBoundaryConditions",
    "DisplacementBoundaryConditions",
    "thermal_bcs",
    "flow_bcs",
    "pureshear_bc",
    "free_surface_vy",
]

Value = Union[bool, float, None]


@dataclasses.dataclass(frozen=True)
class Faces:
    """Per-face BC setting. ``False``/``None`` disables a face."""

    left: Value = False
    right: Value = False
    bot: Value = False
    top: Value = False
    front: Value = False
    back: Value = False

    def any(self) -> bool:
        return any(
            v is not False and v is not None
            for v in (self.left, self.right, self.bot, self.top, self.front, self.back)
        )

    @staticmethod
    def active(v) -> bool:
        """A face carries a value only if it is not a bool or None."""
        return v is not None and not isinstance(v, bool)

    @staticmethod
    def on(v) -> bool:
        return v is True


def _as_faces(f) -> Faces:
    if f is None:
        return Faces()
    if isinstance(f, Faces):
        return f
    if isinstance(f, dict):
        return Faces(**f)
    raise TypeError(f"cannot interpret {f!r} as Faces")


@dataclasses.dataclass(frozen=True)
class TemperatureBoundaryConditions:
    no_flux: Faces = Faces()
    constant_value: Faces = Faces()
    constant_flux: Faces = Faces()
    periodic: Faces = Faces()

    def __init__(self, no_flux=None, constant_value=None, constant_flux=None, periodic=None):
        object.__setattr__(self, "no_flux", _as_faces(no_flux))
        object.__setattr__(self, "constant_value", _as_faces(constant_value))
        object.__setattr__(self, "constant_flux", _as_faces(constant_flux))
        object.__setattr__(self, "periodic", _as_faces(periodic))


@dataclasses.dataclass(frozen=True)
class VelocityBoundaryConditions:
    no_slip: Faces = Faces()
    free_slip: Faces = Faces()
    free_surface: bool = False

    def __init__(self, no_slip=None, free_slip=None, free_surface=False):
        object.__setattr__(self, "no_slip", _as_faces(no_slip))
        object.__setattr__(self, "free_slip", _as_faces(free_slip))
        object.__setattr__(self, "free_surface", bool(free_surface))


@dataclasses.dataclass(frozen=True, init=False)
class DisplacementBoundaryConditions(VelocityBoundaryConditions):
    """The same faces applied to a displacement U (see
    ``ops/displacement.py``)."""


def _slab_set(A, axis: int, dst: int, src: Optional[int], scale=None):
    """``A`` (modified in place) with its ``dst`` slice along ``axis``
    replaced by ``scale·A[src]``, or by 0 when ``src`` is None."""
    dst_idx = [slice(None)] * A.ndim
    dst_idx[axis] = dst
    if src is None:
        A[tuple(dst_idx)] = 0.0
        return A
    src_idx = [slice(None)] * A.ndim
    src_idx[axis] = src
    slab = A[tuple(src_idx)]
    A[tuple(dst_idx)] = slab if scale is None else slab * scale
    return A


# (axis, side) of each face, in the order thermal_bcs applies them: later
# faces overwrite the edge and corner ghosts of earlier ones
THERMAL_FACE_ORDER = (("bot", 1, 0), ("top", 1, 1), ("left", 0, 0), ("right", 0, 1))
THERMAL_FACE_ORDER_3D = (("bot", 2, 0), ("top", 2, 1), ("left", 0, 0), ("right", 0, 1),
                         ("front", 1, 0), ("back", 1, 1))


def _line(A, axis: int, k: int):
    idx = [slice(None)] * A.ndim
    idx[axis] = k
    return tuple(idx)


def thermal_bcs(T, bcs: TemperatureBoundaryConditions):
    """Scalar BCs on a ghosted ``(nx+2, ny+2[, nz+2])`` temperature; returns
    a new tensor. constant_value: ghost = 2·value − interior (Dirichlet at
    the face); no_flux: ghost = interior (mirror); periodic: ghost =
    opposite interior. Each kind is applied over the faces in
    ``THERMAL_FACE_ORDER`` (``THERMAL_FACE_ORDER_3D`` in 3D)."""
    if T.ndim not in (2, 3):
        raise ValueError(f"thermal_bcs: T has {T.ndim} dimensions, not 2 or 3")
    order = THERMAL_FACE_ORDER if T.ndim == 2 else THERMAL_FACE_ORDER_3D
    T = T.clone()
    n = T.shape
    if bcs.constant_value.any():
        for name, axis, side in order:
            v = getattr(bcs.constant_value, name)
            if Faces.active(v):
                inner = T[_line(T, axis, 1 if side == 0 else n[axis] - 2)]
                T[_line(T, axis, 0 if side == 0 else n[axis] - 1)] = 2.0 * v - inner
    if bcs.no_flux.any():
        for name, axis, side in order:
            if Faces.on(getattr(bcs.no_flux, name)):
                inner = T[_line(T, axis, 1 if side == 0 else n[axis] - 2)]
                T[_line(T, axis, 0 if side == 0 else n[axis] - 1)] = inner
    if bcs.periodic.any():
        for name, axis, side in order:
            if Faces.on(getattr(bcs.periodic, name)):
                inner = T[_line(T, axis, n[axis] - 2 if side == 0 else 1)]
                T[_line(T, axis, 0 if side == 0 else n[axis] - 1)] = inner
    return T


def _free_slip_velocity_2d(Vx, Vy, fs: Faces):
    """Mirror the tangential components into the ghost layers."""
    if Faces.on(fs.bot):
        _slab_set(Vx, 1, 0, 1)
    if Faces.on(fs.top):
        _slab_set(Vx, 1, -1, -2)
    if Faces.on(fs.left):
        _slab_set(Vy, 0, 0, 1)
    if Faces.on(fs.right):
        _slab_set(Vy, 0, -1, -2)


def _no_slip_velocity_2d(Vx, Vy, ns: Faces):
    """Zero the normal component on the face and negative-mirror the
    tangential ghosts, with the bottom-row Vx/3 smoothing."""
    if Faces.on(ns.left):
        _slab_set(Vx, 0, 0, None)
        _slab_set(Vy, 0, 0, 1, scale=-1.0)
    if Faces.on(ns.right):
        _slab_set(Vx, 0, -1, None)
        _slab_set(Vy, 0, -1, -2, scale=-1.0)
    if Faces.on(ns.bot):
        _slab_set(Vx, 1, 1, 2, scale=1.0 / 3.0)
        _slab_set(Vx, 1, 0, 1, scale=-1.0)
        _slab_set(Vy, 1, 0, None)
    if Faces.on(ns.top):
        _slab_set(Vx, 1, -1, -2, scale=-1.0)
        _slab_set(Vy, 1, -1, None)


def _free_slip_velocity_3d(Vx, Vy, Vz, fs: Faces):
    """Mirror the tangential components into the ghost planes."""
    if Faces.on(fs.front):
        _slab_set(Vx, 1, 0, 1)
        _slab_set(Vz, 1, 0, 1)
    if Faces.on(fs.back):
        _slab_set(Vx, 1, -1, -2)
        _slab_set(Vz, 1, -1, -2)
    if Faces.on(fs.top):
        _slab_set(Vx, 2, 0, 1)
        _slab_set(Vy, 2, 0, 1)
    if Faces.on(fs.bot):
        _slab_set(Vx, 2, -1, -2)
        _slab_set(Vy, 2, -1, -2)
    if Faces.on(fs.left):
        _slab_set(Vy, 0, 0, 1)
        _slab_set(Vz, 0, 0, 1)
    if Faces.on(fs.right):
        _slab_set(Vy, 0, -1, -2)
        _slab_set(Vz, 0, -1, -2)


def _no_slip_velocity_3d(Vx, Vy, Vz, ns: Faces):
    """Zero the normal component on the face and negative-mirror the
    tangential ghosts."""
    if Faces.on(ns.left):
        _slab_set(Vx, 0, 0, None)
        _slab_set(Vy, 0, 0, 1, scale=-1.0)
        _slab_set(Vz, 0, 0, 1, scale=-1.0)
    if Faces.on(ns.right):
        _slab_set(Vx, 0, -1, None)
        _slab_set(Vy, 0, -1, -2, scale=-1.0)
        _slab_set(Vz, 0, -1, -2, scale=-1.0)
    if Faces.on(ns.front):
        _slab_set(Vx, 1, 0, 1, scale=-1.0)
        _slab_set(Vy, 1, 0, None)
        _slab_set(Vz, 1, 0, 1, scale=-1.0)
    if Faces.on(ns.back):
        _slab_set(Vx, 1, -1, -2, scale=-1.0)
        _slab_set(Vy, 1, -1, None)
        _slab_set(Vz, 1, -1, -2, scale=-1.0)
    if Faces.on(ns.bot):
        _slab_set(Vx, 2, 0, 1, scale=-1.0)
        _slab_set(Vy, 2, 0, 1, scale=-1.0)
        _slab_set(Vz, 2, 0, None)
    if Faces.on(ns.top):
        _slab_set(Vx, 2, -1, -2, scale=-1.0)
        _slab_set(Vy, 2, -1, -2, scale=-1.0)
        _slab_set(Vz, 2, -1, None)


def flow_bcs(V: Tuple, bcs: VelocityBoundaryConditions) -> Tuple:
    """Apply velocity BCs to ``(Vx, Vy)`` or ``(Vx, Vy, Vz)``; returns new
    tensors."""
    if len(V) not in (2, 3):
        raise ValueError(f"flow_bcs takes 2 or 3 velocity components, got {len(V)}")
    V = tuple(v.clone() for v in V)
    no_slip, free_slip = ((_no_slip_velocity_2d, _free_slip_velocity_2d) if len(V) == 2
                          else (_no_slip_velocity_3d, _free_slip_velocity_3d))
    if bcs.no_slip.any():
        no_slip(*V, bcs.no_slip)
    if bcs.free_slip.any():
        free_slip(*V, bcs.free_slip)
    return V


def pureshear_bc(Vx, Vy, xvi, eps_bg):
    """Pure-shear background velocity field: ``Vx[:, 1:-1] = εbg·xv``,
    ``Vy[1:-1, :] = −εbg·yv``; ghost rows untouched. Returns new tensors."""
    xv = torch.as_tensor(xvi[0], dtype=Vx.dtype, device=Vx.device)
    yv = torch.as_tensor(xvi[1], dtype=Vy.dtype, device=Vy.device)
    Vx, Vy = Vx.clone(), Vy.clone()
    Vx[:, 1:-1] = (eps_bg * xv)[:, None]
    Vy[1:-1, :] = (-eps_bg * yv)[None, :]
    return Vx, Vy


def free_surface_vy(Vx, Vy, P, P_old, tyy_old, eta, Gdt, inv_dx, inv_dy, nu=1.0e-2):
    """The analytic free-surface condition on the top Vy row: the
    zero-traction normal stress at the surface gives

      Vy[top] = Vy[top−1] + 3/2·(P/(2η) + (τyy_o + P_o)/(2 G dt)
                                 + (∂Vx/∂x)|_{top−1}/3)·dy,

    under-relaxed by ``nu``. ``P``/``P_old``/``tyy_old``/``eta`` are the
    top-row center values (shape (nx,)); ``Gdt`` is G·dt there (∞: purely
    viscous). Returns a new ``Vy`` with the interior of its top ghost row
    updated."""
    dVx_dx = (Vx[1:, -2] - Vx[:-1, -2]) * inv_dx
    target = Vy[1:-1, -2] + 1.5 * (
        P / (2.0 * eta) + (tyy_old + P_old) / (2.0 * Gdt) + dVx_dx / 3.0
    ) / inv_dy
    Vy = Vy.clone()
    Vy[1:-1, -1] = nu * target + (1.0 - nu) * Vy[1:-1, -1]
    return Vy
