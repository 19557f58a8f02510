"""Staggered-grid stencil primitives on tensors.

Counterpart of ``justrelax_tpu/ops/stencil.py``: whole-array slice
expressions on the leading two (or three) axes, axis order ``(x, y[, z])``.

- ``d_xa(A)``  : aligned forward difference along x (shape loses 1 in x).
- ``d_xi(A)``  : x-difference taken one node into every other axis (velocity
  arrays with ghost transverse rows).
- ``av_xa``/``av_ya`` : 2-point averages along one axis.
- ``av_a``     : 4-point (2D) / 8-point (3D) average onto the dual grid.
- ``harm_a``   : harmonic dual-grid average.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "d_xa",
    "d_ya",
    "d_za",
    "d_xi",
    "d_yi",
    "d_zi",
    "av_xa",
    "av_ya",
    "av_za",
    "av_a",
    "harm_a",
    "av_vertex_to_center",
    "av_center_to_vertex",
    "maxloc",
    "expand_edges",
    "interior_add",
    "interior_set",
]


def d_xa(A, _dx=1.0):
    return (A[1:, ...] - A[:-1, ...]) * _dx


def d_ya(A, _dy=1.0):
    return (A[:, 1:, ...] - A[:, :-1, ...]) * _dy


def d_za(A, _dz=1.0):
    return (A[:, :, 1:] - A[:, :, :-1]) * _dz


def d_xi(A, _dx=1.0):
    if A.ndim == 2:
        return (A[1:, 1:] - A[:-1, 1:]) * _dx
    return (A[1:, 1:, 1:] - A[:-1, 1:, 1:]) * _dx


def d_yi(A, _dy=1.0):
    if A.ndim == 2:
        return (A[1:, 1:] - A[1:, :-1]) * _dy
    return (A[1:, 1:, 1:] - A[1:, :-1, 1:]) * _dy


def d_zi(A, _dz=1.0):
    return (A[1:, 1:, 1:] - A[1:, 1:, :-1]) * _dz


def av_xa(A):
    return 0.5 * (A[1:, ...] + A[:-1, ...])


def av_ya(A):
    return 0.5 * (A[:, 1:, ...] + A[:, :-1, ...])


def av_za(A):
    return 0.5 * (A[:, :, 1:] + A[:, :, :-1])


def av_a(A):
    """Average onto the dual grid; every axis shrinks by one."""
    if A.ndim == 2:
        return 0.25 * (A[:-1, :-1] + A[1:, :-1] + A[:-1, 1:] + A[1:, 1:])
    return 0.125 * (
        A[:-1, :-1, :-1]
        + A[1:, :-1, :-1]
        + A[:-1, 1:, :-1]
        + A[:-1, :-1, 1:]
        + A[1:, 1:, :-1]
        + A[1:, :-1, 1:]
        + A[:-1, 1:, 1:]
        + A[1:, 1:, 1:]
    )


def harm_a(A):
    """Harmonic dual-grid average (4-point 2D / 8-point 3D)."""
    if A.ndim == 2:
        s = 1.0 / A[:-1, :-1] + 1.0 / A[1:, :-1] + 1.0 / A[:-1, 1:] + 1.0 / A[1:, 1:]
        return 4.0 / s
    s = (
        1.0 / A[:-1, :-1, :-1]
        + 1.0 / A[1:, :-1, :-1]
        + 1.0 / A[:-1, 1:, :-1]
        + 1.0 / A[:-1, :-1, 1:]
        + 1.0 / A[1:, 1:, :-1]
        + 1.0 / A[1:, :-1, 1:]
        + 1.0 / A[:-1, 1:, 1:]
        + 1.0 / A[1:, 1:, 1:]
    )
    return 8.0 / s


def av_vertex_to_center(A):
    """(nx+1, ny+1[, nz+1]) vertices → (nx, ny[, nz]) centers."""
    return av_a(A)


def expand_edges(A):
    """Pad by one node on every face, replicating edge values."""
    return F.pad(A[None], (1, 1) * A.ndim, mode="replicate")[0]


def av_center_to_vertex(A):
    """(nx, ny[, nz]) centers → (nx+1, ny+1[, nz+1]) vertices with
    edge-clamped boundary neighbours."""
    return av_a(expand_edges(A))


def maxloc(A, window=1):
    """Maximum over the (2w+1)^ndim window centered at each node, window
    indices clamped into the array (the PT preconditioner ητ)."""
    B = A
    for axis in range(A.ndim):
        parts = [B]
        n = B.shape[axis]
        for s in range(1, window + 1):
            up = torch.arange(s, n + s, device=A.device).clamp_(max=n - 1)
            dn = torch.arange(-s, n - s, device=A.device).clamp_(min=0)
            parts.extend([B.index_select(axis, up), B.index_select(axis, dn)])
        B = torch.stack(parts).amax(dim=0)
    return B


def _pad_arg(pads):
    """jnp.pad-style per-axis pads → torch.nn.functional.pad's reversed flat
    tuple."""
    out = []
    for lo, hi in reversed(pads):
        out.extend([lo, hi])
    return tuple(out)


def interior_add(A, inc, pads=None):
    """``A`` with ``inc`` added on the interior (one layer in from every face
    by default; ``pads`` as in ``numpy.pad``)."""
    if pads is None:
        pads = tuple((1, 1) for _ in range(A.ndim))
    return A + F.pad(inc, _pad_arg(pads))


def interior_set(A, val, pads=None):
    """``A`` with its interior replaced by ``val``."""
    if pads is None:
        pads = tuple((1, 1) for _ in range(A.ndim))
    out = A.clone()
    idx = tuple(slice(lo, A.shape[ax] - hi) for ax, (lo, hi) in enumerate(pads))
    out[idx] = val
    return out
