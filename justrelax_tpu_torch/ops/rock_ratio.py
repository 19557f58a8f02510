"""Rock-ratio masks for the variational (embedded free-surface) Stokes
solvers.

Counterpart of ``justrelax_tpu/ops/rock_ratio.py``. The rock ratio
φ = 1 − (air phase fraction) lives at every staggered location (zeroed
at or below ``CUTOFF``); the validity predicates mark the nullspace nodes:
a center (2D and 3D) is valid when every face around it carries rock, a
vertex (2D) or shear edge (3D) when the clamped neighbouring faces of each
transverse velocity family do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "CUTOFF",
    "RockRatio",
    "RockRatio3D",
    "ValidMasks",
    "ValidMasks3D",
    "update_rock_ratio",
    "update_rock_ratio_3d",
    "valid_masks",
    "valid_masks_3d",
]

CUTOFF = 1.0e-5


class RockRatio(NamedTuple):
    center: torch.Tensor  # (nx, ny)
    vertex: torch.Tensor  # (nx+1, ny+1)
    Vx: torch.Tensor  # (nx+1, ny)
    Vy: torch.Tensor  # (nx, ny+1)


class RockRatio3D(NamedTuple):
    center: torch.Tensor  # (nx, ny, nz)
    vertex: torch.Tensor  # (nx+1, ny+1, nz+1)
    Vx: torch.Tensor  # (nx+1, ny, nz)
    Vy: torch.Tensor  # (nx, ny+1, nz)
    Vz: torch.Tensor  # (nx, ny, nz+1)
    xy: torch.Tensor  # (nx+1, ny+1, nz)
    xz: torch.Tensor  # (nx+1, ny, nz+1)
    yz: torch.Tensor  # (nx, ny+1, nz+1)


class ValidMasks(NamedTuple):
    c: torch.Tensor  # centers (nx, ny)
    v: torch.Tensor  # vertices (nx+1, ny+1)
    vx: torch.Tensor  # x faces (nx+1, ny)
    vy: torch.Tensor  # y faces (nx, ny+1)


class ValidMasks3D(NamedTuple):
    c: torch.Tensor
    xy: torch.Tensor
    xz: torch.Tensor
    yz: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor


def _rock(r_air):
    x = 1.0 - r_air
    return torch.clamp(torch.where(x > CUTOFF, x, 0.0), 0.0, 1.0)


def update_rock_ratio(phase_ratios, air_phase: int) -> RockRatio:
    """From a :class:`~justrelax_tpu_torch.rheology.phases.PhaseRatios`
    bundle (center, vertex and face ratios) and the air phase index."""
    return RockRatio(
        center=_rock(phase_ratios.center[..., air_phase]),
        vertex=_rock(phase_ratios.vertex[..., air_phase]),
        Vx=_rock(phase_ratios.face_x[..., air_phase]),
        Vy=_rock(phase_ratios.face_y[..., air_phase]),
    )


def update_rock_ratio_3d(phase_ratios, air_phase: int) -> RockRatio3D:
    """From a :class:`~justrelax_tpu_torch.rheology.phases.PhaseRatios3D`
    bundle."""
    pr = phase_ratios
    return RockRatio3D(
        center=_rock(pr.center[..., air_phase]),
        vertex=_rock(pr.vertex[..., air_phase]),
        Vx=_rock(pr.face_x[..., air_phase]),
        Vy=_rock(pr.face_y[..., air_phase]),
        Vz=_rock(pr.face_z[..., air_phase]),
        xy=_rock(pr.edge_xy[..., air_phase]),
        xz=_rock(pr.edge_xz[..., air_phase]),
        yz=_rock(pr.edge_yz[..., air_phase]),
    )


def _clamp_pad(A, axis):
    """``A`` with its first and last slab along ``axis`` repeated once on
    either side (an edge pad; ``mode="replicate"`` refuses bool tensors)."""
    n = A.shape[axis]
    return torch.cat([A.narrow(axis, 0, 1), A, A.narrow(axis, n - 1, 1)], dim=axis)


def _pair_and(A, axis):
    """The clamped two-neighbour conjunction along ``axis``: one longer
    than ``A`` along it."""
    p = _clamp_pad(A, axis)
    n = p.shape[axis]
    return p.narrow(axis, 0, n - 1) & p.narrow(axis, 1, n - 1)


def valid_masks(phi: RockRatio) -> ValidMasks:
    """The 2D nullspace predicates."""
    vx_ok = phi.Vx > 0
    vy_ok = phi.Vy > 0
    c = vx_ok[:-1, :] & vx_ok[1:, :] & vy_ok[:, :-1] & vy_ok[:, 1:] & (phi.center > 0)
    # a vertex: the x faces of the rows below and above it, the y faces of
    # the columns left and right of it (clamped at the walls)
    v = _pair_and(vx_ok, 1) & _pair_and(vy_ok, 0) & (phi.vertex > 0)
    return ValidMasks(c=c, v=v, vx=vx_ok, vy=vy_ok)


def valid_masks_3d(phi: RockRatio3D) -> ValidMasks3D:
    """The 3D nullspace predicates: a center is valid when its six faces
    carry rock; a shear edge when the clamped neighbouring faces of each of
    its two transverse families do."""
    vx_ok, vy_ok, vz_ok = phi.Vx > 0, phi.Vy > 0, phi.Vz > 0
    c = (
        vx_ok[:-1, :, :] & vx_ok[1:, :, :]
        & vy_ok[:, :-1, :] & vy_ok[:, 1:, :]
        & vz_ok[:, :, :-1] & vz_ok[:, :, 1:]
        & (phi.center > 0)
    )
    # τxy edges: Vx spans y, Vy spans x; τxz: Vx spans z, Vz spans x; τyz:
    # Vy spans z, Vz spans y
    xy = _pair_and(vx_ok, 1) & _pair_and(vy_ok, 0) & (phi.xy > 0)
    xz = _pair_and(vx_ok, 2) & _pair_and(vz_ok, 0) & (phi.xz > 0)
    yz = _pair_and(vy_ok, 2) & _pair_and(vz_ok, 1) & (phi.yz > 0)
    return ValidMasks3D(c=c, xy=xy, xz=xz, yz=yz, vx=vx_ok, vy=vy_ok, vz=vz_ok)
