"""Marker chain: Lagrangian surface/topography tracking.

Counterpart of ``justrelax_tpu/particles/marker_chain.py`` (JustPIC's
``MarkerChain`` with the reference's ``advect_markerchain!`` and
``update_phases_given_markerchain!``): an ordered set of markers describing
a single-valued interface y = h(x), advected with the staggered velocity
field (RK2) and resampled back onto a uniform x lattice each step (the
monotone-x invariant kept by construction). ``interp`` is ``jnp.interp``'s
linear interpolation, clamped to the end values outside the range.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from justrelax_tpu_torch.core.device import resolve_device
from justrelax_tpu_torch.particles.particles import _bilinear

Tensor = torch.Tensor

__all__ = [
    "MarkerChain",
    "init_marker_chain",
    "advect_marker_chain",
    "phases_from_marker_chain",
    "update_phases_given_markerchain",
    "interp",
]


class MarkerChain(NamedTuple):
    x: Tensor  # marker x positions (n_markers,)
    y: Tensor  # marker heights


def interp(x: Tensor, xp: Tensor, fp: Tensor) -> Tensor:
    """``jnp.interp(x, xp, fp)``: piecewise-linear through (xp, fp), ``xp``
    ascending, ``fp[0]`` left of ``xp[0]`` and ``fp[-1]`` right of
    ``xp[-1]``; each operation in ``jnp.interp``'s order."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    epsilon = float(np.spacing(np.finfo(np.dtype(str(xp.dtype).replace("torch.", ""))).eps))
    dx0 = torch.abs(dx) <= epsilon
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def init_marker_chain(geometry, height, n_per_cell: int = 4, dtype=None,
                      device=None) -> MarkerChain:
    """Markers spanning the domain at ``n_per_cell`` per cell; ``height`` is a
    scalar or a callable h(x) of a numpy array. Float64 by default, on the
    card by default."""
    nx = geometry.ni[0]
    ox = geometry.origin[0]
    lx = geometry.li[0]
    n = nx * n_per_cell + 1
    x = np.linspace(ox, ox + lx, n)
    h = np.full(n, float(height)) if np.isscalar(height) else np.asarray(height(x))
    f = dict(dtype=torch.float64 if dtype is None else dtype, device=resolve_device(device))
    return MarkerChain(x=torch.as_tensor(x, **f), y=torch.as_tensor(h, **f))


def _chain_velocity(chain: MarkerChain, V: Tuple[Tensor, Tensor], geometry):
    Vx, Vy = V
    dx, dy = geometry.di
    ox, oy = geometry.origin
    vx = _bilinear(Vx, ox, oy - dy / 2, dx, dy, chain.x, chain.y)
    vy = _bilinear(Vy, ox - dx / 2, oy, dx, dy, chain.x, chain.y)
    return vx, vy


def advect_marker_chain(
    chain: MarkerChain, V: Tuple[Tensor, Tensor], geometry, dt
) -> MarkerChain:
    """RK2 advection followed by resampling onto the original x lattice
    (linear interpolation of the displaced chain, clamped to the domain)."""
    vx1, vy1 = _chain_velocity(chain, V, geometry)
    xh = chain.x + 0.5 * dt * vx1
    yh = chain.y + 0.5 * dt * vy1
    vx2, vy2 = _chain_velocity(MarkerChain(x=xh, y=yh), V, geometry)
    x_new = chain.x + dt * vx2
    y_new = chain.y + dt * vy2

    # resample: h on the original lattice from the displaced markers (a
    # stable sort, as jnp.argsort's)
    order = torch.argsort(x_new, stable=True)
    xs, ys = x_new[order], y_new[order]
    h = interp(chain.x, xs, ys)
    oy, ly = geometry.origin[1], geometry.li[1]
    h = torch.clamp(h, oy, oy + ly)
    return MarkerChain(x=chain.x, y=h)


def update_phases_given_markerchain(
    chain: MarkerChain, particles, p_phase: Tensor, air_phase: int
):
    """Per-particle topography correction against the chain (reference
    src/phases/topography_correction.jl:36-90): a particle ABOVE the chain
    carrying a rock phase, or an AIR particle BELOW the chain, is
    inconsistent with the tracked surface and is deactivated, so that the
    coupled loop's ``inject_particles(..., phases=corrected_field)`` refills
    the slot with the phase the chain implies.

    ``p_phase`` is the per-particle phase carrier (float, rounded ints).
    Returns ``(particles, n_corrected)``.
    """
    h = interp(particles.px, chain.x, chain.y)
    above = particles.py > h
    is_air = torch.round(p_phase) == air_phase
    bad = particles.active & ((above & ~is_air) | (~above & is_air))
    return particles.replace(active=particles.active & ~bad), torch.sum(bad)


def phases_from_marker_chain(
    chain: MarkerChain, geometry, phase_below: int, phase_above: int
) -> Tensor:
    """Cell-centered integer phase field: ``phase_above`` (e.g. air) above the
    chain, ``phase_below`` below (reference
    update_phases_given_markerchain!), on the chain's device."""
    X, Y = geometry.cell_centers_mesh()
    f = dict(dtype=chain.x.dtype, device=chain.x.device)
    hX = interp(torch.as_tensor(X[:, 0], **f), chain.x, chain.y)
    above = torch.as_tensor(Y, **f) > hX[:, None]
    return torch.where(above, phase_above, phase_below)
