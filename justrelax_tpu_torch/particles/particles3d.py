"""Particle-in-cell transport, 3D.

Counterpart of ``justrelax_tpu/particles/particles3d.py`` (the JustPIC._3D
surface of the reference's 3D miniapps: init_particles, advection!(RK2),
move_particles!, particle2grid!/grid2particle!, centroid transfers, phase
ratios, injection). The design of the 2D module (fixed per-cell slots with
an active mask, whole-array trilinear transfers, the move in x-slabs);
shapes are (nx, ny, nz, max_xcell). Accumulations take the dtype of the
field they accumulate; phases compare as ``round(phase)`` (half to even),
as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from justrelax_tpu_torch.core.device import resolve_device
from justrelax_tpu_torch.particles.particles import (
    _dominant,
    _index,
    _lattice,
    _over,
    _to_fill,
    move_cells,
)

Tensor = torch.Tensor

__all__ = [
    "Particles3D",
    "init_particles_3d",
    "advect_rk2_3d",
    "move_particles_3d",
    "particle2grid_3d",
    "grid2particle_3d",
    "particle2centroid_3d",
    "centroid2particle_3d",
    "phase_ratios_from_particles_3d",
    "inject_particles_3d",
]


@dataclasses.dataclass(frozen=True)
class Particles3D:
    px: Tensor  # (nx, ny, nz, max_xcell)
    py: Tensor
    pz: Tensor
    active: Tensor
    min_xcell: int = 0
    nxcell: int = 0

    def replace(self, **kw) -> "Particles3D":
        return dataclasses.replace(self, **kw)

    @property
    def max_xcell(self) -> int:
        return self.px.shape[-1]

    def count(self) -> Tensor:
        return torch.sum(self.active, dim=-1)


def init_particles_3d(geometry, nxcell: int, max_xcell: int, min_xcell: int,
                      seed: int = 0, dtype=None, device=None) -> Particles3D:
    """Stratified-random particles, ``nxcell`` per cell, drawn in float64 by
    numpy's generator in the JAX package's order and cast to ``dtype``
    (float64 by default) on ``device`` (the card by default)."""
    nx, ny, nz = geometry.ni
    dx, dy, dz = geometry.di
    ox, oy, oz = geometry.origin
    rng = np.random.default_rng(seed)
    m = int(math.ceil(nxcell ** (1.0 / 3.0)))
    sub = _lattice(m, 3, nxcell)
    jitter = (rng.random((nx, ny, nz, nxcell, 3)) - 0.5) / m * 0.9
    pos = sub[None, None, None] + jitter
    I = np.arange(nx)[:, None, None, None]  # noqa: E741
    J = np.arange(ny)[None, :, None, None]
    K = np.arange(nz)[None, None, :, None]
    X = ox + (I + pos[..., 0]) * dx
    Y = oy + (J + pos[..., 1]) * dy
    Z = oz + (K + pos[..., 2]) * dz
    shape = (nx, ny, nz, max_xcell)
    px, py, pz = np.zeros(shape), np.zeros(shape), np.zeros(shape)
    px[..., :nxcell], py[..., :nxcell], pz[..., :nxcell] = X, Y, Z
    active = np.zeros(shape, dtype=bool)
    active[..., :nxcell] = True
    device = resolve_device(device)
    dtype = torch.float64 if dtype is None else dtype
    f = dict(dtype=dtype, device=device)
    return Particles3D(
        px=torch.as_tensor(px, **f), py=torch.as_tensor(py, **f),
        pz=torch.as_tensor(pz, **f), active=torch.as_tensor(active, device=device),
        min_xcell=min_xcell, nxcell=nxcell,
    )


def _trilinear(F, x0, y0, z0, dx, dy, dz, X, Y, Z):
    nx, ny, nz = F.shape
    fx = _over(X - x0, dx)
    fy = _over(Y - y0, dy)
    fz = _over(Z - z0, dz)
    ix = torch.clamp(torch.floor(fx).to(torch.int64), 0, nx - 2)
    iy = torch.clamp(torch.floor(fy).to(torch.int64), 0, ny - 2)
    iz = torch.clamp(torch.floor(fz).to(torch.int64), 0, nz - 2)
    tx = torch.clamp(fx - ix, 0.0, 1.0)
    ty = torch.clamp(fy - iy, 0.0, 1.0)
    tz = torch.clamp(fz - iz, 0.0, 1.0)
    out = 0.0
    for di, wx in ((0, 1 - tx), (1, tx)):
        for dj, wy in ((0, 1 - ty), (1, ty)):
            for dk, wz in ((0, 1 - tz), (1, tz)):
                out = out + F[ix + di, iy + dj, iz + dk] * wx * wy * wz
    return out


def particle_velocity_3d(Vx, Vy, Vz, geometry, X, Y, Z):
    dx, dy, dz = geometry.di
    ox, oy, oz = geometry.origin
    vx = _trilinear(Vx, ox, oy - dy / 2, oz - dz / 2, dx, dy, dz, X, Y, Z)
    vy = _trilinear(Vy, ox - dx / 2, oy, oz - dz / 2, dx, dy, dz, X, Y, Z)
    vz = _trilinear(Vz, ox - dx / 2, oy - dy / 2, oz, dx, dy, dz, X, Y, Z)
    return vx, vy, vz


def advect_rk2_3d(particles: Particles3D, V, geometry, dt) -> Particles3D:
    """Midpoint RK2 advection; ``dt`` a Python float."""
    Vx, Vy, Vz = V
    X, Y, Z = particles.px, particles.py, particles.pz
    v1 = particle_velocity_3d(Vx, Vy, Vz, geometry, X, Y, Z)
    Xh = X + 0.5 * dt * v1[0]
    Yh = Y + 0.5 * dt * v1[1]
    Zh = Z + 0.5 * dt * v1[2]
    v2 = particle_velocity_3d(Vx, Vy, Vz, geometry, Xh, Yh, Zh)
    Xn, Yn, Zn = X + dt * v2[0], Y + dt * v2[1], Z + dt * v2[2]
    o = geometry.origin
    li = geometry.li
    eps = 1e-12 * max(li)
    Xn = torch.clamp(Xn, o[0] + eps, o[0] + li[0] - eps)
    Yn = torch.clamp(Yn, o[1] + eps, o[1] + li[1] - eps)
    Zn = torch.clamp(Zn, o[2] + eps, o[2] + li[2] - eps)
    a = particles.active
    return particles.replace(
        px=torch.where(a, Xn, X), py=torch.where(a, Yn, Y), pz=torch.where(a, Zn, Z)
    )


def move_particles_3d(
    particles: Particles3D, geometry, fields: Dict[str, Tensor], x_slab: Optional[int] = None
) -> Tuple[Particles3D, Dict[str, Tensor]]:
    """Re-slot particles into their current cells (CFL ≤ 1 cell/step) from
    the 27-cell neighbourhood, ``x_slab`` x-columns at a time (see
    ``particles.move_cells``)."""
    (px, py, pz), active, new_fields = move_cells(
        (particles.px, particles.py, particles.pz), particles.active, fields, geometry,
        x_slab)
    return particles.replace(px=px, py=py, pz=pz, active=active), new_fields


def _corner_weights_3d(particles, geometry):
    """Each particle's fractional position in the cell its position lies in."""
    dx, dy, dz = geometry.di
    ox, oy, oz = geometry.origin
    fx = _over(particles.px - ox, dx)
    fy = _over(particles.py - oy, dy)
    fz = _over(particles.pz - oz, dz)
    i = torch.floor(fx).to(torch.int64)
    j = torch.floor(fy).to(torch.int64)
    k = torch.floor(fz).to(torch.int64)
    return (fx - i, fy - j, fz - k)


def particle2grid_3d(field: Tensor, particles: Particles3D, geometry) -> Tensor:
    """Particle field → vertices (nx+1, ny+1, nz+1), inverse-trilinear
    Shepard weighting (JustPIC particle2grid!), accumulated in ``field``'s
    dtype. Each slot's weights go to the vertices of the cell it sits in."""
    nx, ny, nz = particles.px.shape[:3]
    tx, ty, tz = _corner_weights_3d(particles, geometry)
    a = particles.active
    dev = field.device
    n_v = (nx + 1) * (ny + 1) * (nz + 1)
    num = torch.zeros(n_v, dtype=field.dtype, device=dev)
    den = torch.zeros_like(num)
    I = _index(nx, torch.int64, dev, 0, 3)  # noqa: E741
    J = _index(ny, torch.int64, dev, 1, 3)
    K = _index(nz, torch.int64, dev, 2, 3)
    shape = particles.px.shape
    for di, wx in ((0, 1 - tx), (1, tx)):
        for dj, wy in ((0, 1 - ty), (1, ty)):
            for dk, wz in ((0, 1 - tz), (1, tz)):
                w = torch.where(a, wx * wy * wz, 0.0).to(field.dtype)
                idx = (((I + di) * (ny + 1) + (J + dj)) * (nz + 1) + (K + dk)).expand(shape)
                num.index_add_(0, idx.reshape(-1), (w * field).reshape(-1))
                den.index_add_(0, idx.reshape(-1), w.reshape(-1))
    out = num / torch.where(den == 0, 1.0, den)
    return out.reshape(nx + 1, ny + 1, nz + 1)


def grid2particle_3d(vertex_field: Tensor, particles: Particles3D, geometry) -> Tensor:
    ox, oy, oz = geometry.origin
    dx, dy, dz = geometry.di
    return _trilinear(
        vertex_field, ox, oy, oz, dx, dy, dz,
        particles.px, particles.py, particles.pz,
    )


def particle2centroid_3d(field: Tensor, particles: Particles3D, geometry) -> Tensor:
    """Particle field → cell centers, distance-weighted."""
    dx, dy, dz = geometry.di
    ox, oy, oz = geometry.origin
    nx, ny, nz = particles.px.shape[:3]
    pdt, dev = particles.px.dtype, particles.px.device
    xc = ox + (_index(nx, pdt, dev, 0, 3) + 0.5) * dx
    yc = oy + (_index(ny, pdt, dev, 1, 3) + 0.5) * dy
    zc = oz + (_index(nz, pdt, dev, 2, 3) + 0.5) * dz
    dist = torch.clamp_min(
        _over(torch.abs(particles.px - xc), dx)
        + _over(torch.abs(particles.py - yc), dy)
        + _over(torch.abs(particles.pz - zc), dz),
        1e-10,
    )
    w = torch.where(particles.active, 1.0 / dist, 0.0)
    den = torch.sum(w, dim=-1)
    return torch.sum(w * field, dim=-1) / torch.where(den == 0, 1.0, den)


def centroid2particle_3d(center_field: Tensor, particles: Particles3D, geometry) -> Tensor:
    ox, oy, oz = geometry.origin
    dx, dy, dz = geometry.di
    return _trilinear(
        center_field, ox + dx / 2, oy + dy / 2, oz + dz / 2, dx, dy, dz,
        particles.px, particles.py, particles.pz,
    )


def phase_ratios_from_particles_3d(
    particles: Particles3D, phase: Tensor, nphase: int, geometry
) -> Tuple[Tensor, Tensor]:
    """(center ratios (nx,ny,nz,nphase), vertex ratios (+1 each, nphase)),
    in the particles' dtype."""
    a = particles.active
    pdt = particles.px.dtype
    rounded = torch.round(phase)
    cr = []
    for p in range(nphase):
        w = (a & (rounded == p)).to(pdt)
        cr.append(torch.sum(w, dim=-1))
    center = torch.stack(cr, dim=-1)
    s = torch.sum(center, dim=-1, keepdim=True)
    center = center / torch.where(s == 0, 1.0, s)
    vert = []
    for p in range(nphase):
        vert.append(particle2grid_3d((rounded == p).to(pdt), particles, geometry))
    vertex = torch.stack(vert, dim=-1)
    sv = torch.sum(vertex, dim=-1, keepdim=True)
    vertex = vertex / torch.where(sv == 0, 1.0, sv)
    return center, vertex


def inject_particles_3d(
    particles: Particles3D,
    geometry,
    fields_from_centers: Dict[str, Tensor],
    phases: Optional[int] = None,
    phase_field: Optional[str] = "phase",
    fields: Optional[Dict[str, Tensor]] = None,
) -> Tuple[Particles3D, Dict[str, Tensor]]:
    """Refill cells below ``min_xcell`` (JustPIC inject_particles_phase!,
    3D): new particles at sub-cell lattice positions, scalars interpolated
    from center fields, phase = dominant among the cell's survivors
    (``phases`` phases, or the phase field's maximum + 1 read on the host)."""
    fields = fields or {}
    nx, ny, nz = particles.px.shape[:3]
    mx = particles.max_xcell
    dx, dy, dz = geometry.di
    ox, oy, oz = geometry.origin
    pdt, dev = particles.px.dtype, particles.px.device

    m = int(math.ceil(mx ** (1.0 / 3.0)))
    s = torch.as_tensor(_lattice(m, 3, mx), dtype=pdt, device=dev)
    newx = ox + (_index(nx, pdt, dev, 0, 3) + s[:, 0]) * dx
    newy = oy + (_index(ny, pdt, dev, 1, 3) + s[:, 1]) * dy
    newz = oz + (_index(nz, pdt, dev, 2, 3) + s[:, 2]) * dz

    to_fill = _to_fill(particles)
    px = torch.where(to_fill, newx, particles.px)
    py = torch.where(to_fill, newy, particles.py)
    pz = torch.where(to_fill, newz, particles.pz)
    active = particles.active | to_fill
    filled = particles.replace(px=px, py=py, pz=pz, active=active)

    new_fields = {}
    for k, v in fields.items():
        if k in fields_from_centers:
            interp = centroid2particle_3d(fields_from_centers[k], filled, geometry)
            new_fields[k] = torch.where(to_fill, interp, v)
        elif k == phase_field:
            nphase = phases if phases is not None else int(torch.max(v).item()) + 1
            dominant, _ = _dominant(v, particles.active, nphase, rounded=True)
            new_fields[k] = torch.where(to_fill, dominant[..., None], v)
        else:
            new_fields[k] = v
    return filled, new_fields
