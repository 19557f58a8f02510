"""Ghost-node velocity boundary conditions on the staggered grid (2D).

Counterpart of the flow part of ``justrelax_tpu/ops/bc.py``. BC configs are
frozen dataclasses; ``flow_bcs`` returns new tensors. Face naming: ``left``/
``right`` bound the x-axis, ``bot``/``top`` the y-axis. Application order is
no-slip, then free-slip (later writes win).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

__all__ = ["Faces", "VelocityBoundaryConditions", "flow_bcs"]

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
class VelocityBoundaryConditions:
    no_slip: Faces = Faces()
    free_slip: Faces = Faces()
    free_surface: bool = False

    def __init__(self, no_slip=None, free_slip=None, free_surface=False):
        object.__setattr__(self, "no_slip", _as_faces(no_slip))
        object.__setattr__(self, "free_slip", _as_faces(free_slip))
        object.__setattr__(self, "free_surface", bool(free_surface))


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


def flow_bcs(V: Tuple, bcs: VelocityBoundaryConditions) -> Tuple:
    """Apply velocity BCs to ``(Vx, Vy)``; returns new tensors."""
    if len(V) != 2:
        raise NotImplementedError("the PyTorch port covers 2D grids only")
    Vx, Vy = V[0].clone(), V[1].clone()
    if bcs.no_slip.any():
        _no_slip_velocity_2d(Vx, Vy, bcs.no_slip)
    if bcs.free_slip.any():
        _free_slip_velocity_2d(Vx, Vy, bcs.free_slip)
    return Vx, Vy
