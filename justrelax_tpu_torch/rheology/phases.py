"""Phase-ratio fields from array phase data.

Counterpart of ``justrelax_tpu/rheology/phases.py``: from an integer phase
field at cell centers (or a one-hot/fractional ratio field), the phase
fractions at every staggered location — centers, vertices, faces and, in 3D,
the three shear-edge families — as clamped-neighbour averages, each
normalised to sum to one.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from justrelax_tpu_torch.ops.stencil import expand_edges

__all__ = [
    "PhaseRatios",
    "PhaseRatios3D",
    "phase_ratios_from_field",
    "one_hot_phases",
]


class PhaseRatios(NamedTuple):
    center: torch.Tensor  # (nx, ny, nphase)
    vertex: torch.Tensor  # (nx+1, ny+1, nphase)
    face_x: torch.Tensor  # (nx+1, ny, nphase)
    face_y: torch.Tensor  # (nx, ny+1, nphase)


class PhaseRatios3D(NamedTuple):
    center: torch.Tensor  # (nx, ny, nz, nphase)
    vertex: torch.Tensor  # (nx+1, ny+1, nz+1, nphase)
    face_x: torch.Tensor  # (nx+1, ny, nz, nphase)
    face_y: torch.Tensor  # (nx, ny+1, nz, nphase)
    face_z: torch.Tensor  # (nx, ny, nz+1, nphase)
    edge_xy: torch.Tensor  # (nx+1, ny+1, nz, nphase): τxy locations
    edge_xz: torch.Tensor  # (nx+1, ny, nz+1, nphase): τxz locations
    edge_yz: torch.Tensor  # (nx, ny+1, nz+1, nphase): τyz locations


def one_hot_phases(phase_index, nphase: int, dtype=torch.float64) -> torch.Tensor:
    """(…, nphase) indicator of ``phase_index == p`` for each phase p."""
    phase_index = torch.as_tensor(phase_index)
    return torch.stack([(phase_index == p).to(dtype) for p in range(nphase)], dim=-1)


def _normalize(r):
    s = torch.sum(r, dim=-1, keepdim=True)
    return r / torch.where(s == 0, 1.0, s)


def _av_axes(padded, axes):
    """Average the edge-clamped padded field over ``axes`` (2-point each),
    every other axis restricted to its interior."""
    sl = [slice(1, -1)] * padded.ndim
    for ax in axes:
        sl[ax] = slice(None)
    out = padded[tuple(sl)]
    for ax in sorted(axes):
        lo = [slice(None)] * out.ndim
        hi = [slice(None)] * out.ndim
        lo[ax], hi[ax] = slice(None, -1), slice(1, None)
        out = 0.5 * (out[tuple(lo)] + out[tuple(hi)])
    return out


def phase_ratios_from_field(phase_center, nphase: Optional[int] = None,
                            dtype=torch.float64):
    """All staggered ratio fields from center data, 2D or 3D.

    ``phase_center`` is an integer phase-index field (ni…) with ``nphase``
    given, or a one-hot/fractional (ni…, nphase) field (told apart, as in
    the JAX package, by whether ``nphase`` is given and matches the last
    axis of a floating field). An index field becomes ``dtype`` ratios on
    its own device; a ratio field keeps its dtype. Returns
    :class:`PhaseRatios` in 2D, :class:`PhaseRatios3D` in 3D.
    """
    phase_center = torch.as_tensor(phase_center)
    is_index = nphase is not None and (
        not phase_center.is_floating_point() or phase_center.shape[-1] != nphase
    )
    ratios_c = one_hot_phases(phase_center, nphase, dtype) if is_index else phase_center
    ndim = ratios_c.ndim - 1
    n = ratios_c.shape[-1]

    def stag(axes):
        out = [_av_axes(expand_edges(ratios_c[..., p]), axes) for p in range(n)]
        return _normalize(torch.stack(out, dim=-1))

    if ndim == 2:
        return PhaseRatios(
            center=_normalize(ratios_c),
            vertex=stag((0, 1)),
            face_x=stag((0,)),
            face_y=stag((1,)),
        )
    return PhaseRatios3D(
        center=_normalize(ratios_c),
        vertex=stag((0, 1, 2)),
        face_x=stag((0,)),
        face_y=stag((1,)),
        face_z=stag((2,)),
        edge_xy=stag((0, 1)),
        edge_xz=stag((0, 2)),
        edge_yz=stag((1, 2)),
    )
