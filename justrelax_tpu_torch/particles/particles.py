"""Particle-in-cell material transport, 2D.

Counterpart of ``justrelax_tpu/particles/particles.py`` (the JustPIC
equivalent). Particles live in fixed per-cell slots: every array has shape
``(nx, ny, max_xcell)`` with an ``active`` mask, the reference's CellArray
layout made explicit, and every operation is a whole-array one:

- bilinear interpolation of the staggered (ghosted) velocity grids at the
  particles; RK2 (midpoint) advection;
- ``move_particles``: each cell takes its particles back from its 3×3
  neighbourhood, in the JAX package's candidate order, keeping the first
  ``max_xcell`` by a stable sort (the particles move at most one cell per
  step under CFL ≤ 1). It runs in x-slabs, so that the candidates of one
  slab at a time are in memory; the slots come out the same for any slab
  width;
- particle↔grid transfers: vertex (``particle2grid``/``grid2particle``) and
  centroid variants, weighted as JustPIC's bilinear kernels;
- ``inject_particles``: refill cells that fell below ``min_xcell``;
- phase ratios at centers and vertices from particle phases;
- subgrid temperature diffusion.

The particle arrays take the dtype given to :func:`init_particles` (float64
by default); accumulations take the dtype of the field they accumulate.
Selections, gathers and elementwise arithmetic give the same bits on the
card as on the CPU; the scatter-adds (``particle2grid``, the vertex phase
ratios) and the per-cell sums add in another order on the card. Divisions by
a grid spacing divide by a 0-d tensor on the particles' device: a Python
scalar divisor is a reciprocal product on the card.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from justrelax_tpu_torch.core.device import resolve_device

Tensor = torch.Tensor

__all__ = [
    "Particles",
    "init_particles",
    "particle_velocity",
    "advect_rk2",
    "move_particles",
    "inject_particles",
    "particle2grid",
    "grid2particle",
    "particle2centroid",
    "centroid2particle",
    "phase_ratios_from_particles",
    "subgrid_characteristic_time",
    "subgrid_diffusion",
]

# candidates (cells × neighbourhood × slots) one slab of a move holds: 2^27
# keeps a slab's candidate arrays, sort keys and indices near 7 GB in f32
MOVE_CANDIDATES = 1 << 27


@dataclasses.dataclass(frozen=True)
class Particles:
    px: Tensor  # (nx, ny, max_xcell) absolute x
    py: Tensor
    active: Tensor  # bool mask
    min_xcell: int = 0
    nxcell: int = 0

    def replace(self, **kw) -> "Particles":
        return dataclasses.replace(self, **kw)

    @property
    def max_xcell(self) -> int:
        return self.px.shape[-1]

    def count(self) -> Tensor:
        return torch.sum(self.active, dim=-1)


def _over(a: Tensor, d: float) -> Tensor:
    """``a / d`` for a Python float ``d``, divided as a tensor: torch turns
    a Python scalar divisor into a reciprocal product on the card."""
    return a / torch.full((), d, dtype=a.dtype, device=a.device)


def _lattice(m: int, ndim: int, count: int) -> np.ndarray:
    """The first ``count`` points of the ``m``-per-axis sub-cell lattice,
    (count, ndim), in the JAX package's order."""
    ax = (np.arange(m) + 0.5) / m
    return np.stack(np.meshgrid(*((ax,) * ndim), indexing="ij"), axis=-1).reshape(
        -1, ndim)[:count]


def _index(n: int, dtype, device, axis: int, ndim: int) -> Tensor:
    """``arange(n)`` in ``dtype`` shaped to broadcast along grid ``axis`` of
    an (…grid, slot) array."""
    shape = [1] * (ndim + 1)
    shape[axis] = n
    return torch.arange(n, dtype=dtype, device=device).reshape(shape)


def init_particles(geometry, nxcell: int, max_xcell: int, min_xcell: int, seed: int = 0,
                   dtype=None, device=None) -> Particles:
    """Stratified-random particles: ``nxcell`` per cell, ``max_xcell``
    slots. The positions are drawn in float64 by numpy's generator in the
    JAX package's order and cast to ``dtype`` (float64 by default) on
    ``device`` (the card by default)."""
    nx, ny = geometry.ni
    dx, dy = geometry.di
    ox, oy = geometry.origin
    rng = np.random.default_rng(seed)
    m = int(math.ceil(math.sqrt(nxcell)))
    sub = _lattice(m, 2, nxcell)
    jitter = (rng.random((nx, ny, nxcell, 2)) - 0.5) / m * 0.9
    pos = sub[None, None, :, :] + jitter
    X = ox + (np.arange(nx)[:, None, None] + pos[..., 0]) * dx
    Y = oy + (np.arange(ny)[None, :, None] + pos[..., 1]) * dy
    px = np.zeros((nx, ny, max_xcell))
    py = np.zeros((nx, ny, max_xcell))
    px[..., :nxcell] = X
    py[..., :nxcell] = Y
    active = np.zeros((nx, ny, max_xcell), dtype=bool)
    active[..., :nxcell] = True
    device = resolve_device(device)
    dtype = torch.float64 if dtype is None else dtype
    return Particles(
        px=torch.as_tensor(px, dtype=dtype, device=device),
        py=torch.as_tensor(py, dtype=dtype, device=device),
        active=torch.as_tensor(active, device=device),
        min_xcell=min_xcell,
        nxcell=nxcell,
    )


# --- interpolation ----------------------------------------------------------
def _bilinear(F, x0, y0, dx, dy, X, Y):
    """Bilinear sample of grid F (node coords x0+i·dx, y0+j·dy) at (X, Y)."""
    nx, ny = F.shape
    fx = _over(X - x0, dx)
    fy = _over(Y - y0, dy)
    ix = torch.clamp(torch.floor(fx).to(torch.int64), 0, nx - 2)
    iy = torch.clamp(torch.floor(fy).to(torch.int64), 0, ny - 2)
    tx = torch.clamp(fx - ix, 0.0, 1.0)
    ty = torch.clamp(fy - iy, 0.0, 1.0)
    f00 = F[ix, iy]
    f10 = F[ix + 1, iy]
    f01 = F[ix, iy + 1]
    f11 = F[ix + 1, iy + 1]
    return (
        f00 * (1 - tx) * (1 - ty)
        + f10 * tx * (1 - ty)
        + f01 * (1 - tx) * ty
        + f11 * tx * ty
    )


def particle_velocity(Vx, Vy, geometry, X, Y):
    """Velocity at particle positions from the ghosted staggered grids."""
    dx, dy = geometry.di
    ox, oy = geometry.origin
    vx = _bilinear(Vx, ox, oy - dy / 2, dx, dy, X, Y)
    vy = _bilinear(Vy, ox - dx / 2, oy, dx, dy, X, Y)
    return vx, vy


def advect_rk2(particles: Particles, V: Tuple[Tensor, Tensor], geometry, dt) -> Particles:
    """Midpoint RK2 advection (JustPIC ``advection!(..., RungeKutta2(), ...)``);
    ``dt`` a Python float."""
    Vx, Vy = V
    X, Y = particles.px, particles.py
    vx1, vy1 = particle_velocity(Vx, Vy, geometry, X, Y)
    Xh = X + 0.5 * dt * vx1
    Yh = Y + 0.5 * dt * vy1
    vx2, vy2 = particle_velocity(Vx, Vy, geometry, Xh, Yh)
    Xn = X + dt * vx2
    Yn = Y + dt * vy2
    # clamp into the domain
    ox, oy = geometry.origin
    lx, ly = geometry.li
    eps = 1e-12 * max(lx, ly)
    Xn = torch.clamp(Xn, ox + eps, ox + lx - eps)
    Yn = torch.clamp(Yn, oy + eps, oy + ly - eps)
    Xn = torch.where(particles.active, Xn, X)
    Yn = torch.where(particles.active, Yn, Y)
    return particles.replace(px=Xn, py=Yn)


# --- cell reassignment ------------------------------------------------------
def _pad(A: Tensor, fill, ndim: int) -> Tensor:
    """``A`` with one ``fill`` node before and after each of its ``ndim``
    grid axes."""
    out = A.new_full(tuple(n + 2 for n in A.shape[:ndim]) + A.shape[ndim:], fill)
    out[(slice(1, -1),) * ndim] = A
    return out


def _slab_width(ni, ncand: int, x_slab: Optional[int]) -> int:
    """x-columns per slab of a move: ``x_slab``, or as many as keep a slab's
    candidates within ``MOVE_CANDIDATES``."""
    if x_slab is not None:
        if int(x_slab) < 1:
            raise ValueError(f"x_slab must be a positive number of x-columns, not {x_slab}")
        return int(x_slab)
    per_column = math.prod(ni[1:]) * ncand
    return max(1, MOVE_CANDIDATES // per_column)


def move_cells(pos, active, fields, geometry, x_slab=None):
    """Re-slot particles into their current cells, 2D or 3D (``pos`` one
    position array per axis, each (…grid, max_xcell)).

    Each cell takes the candidates of its 3^ndim neighbourhood in the JAX
    package's order (offsets −1, 0, +1 per axis, the last axis fastest; a
    neighbour beyond the grid contributes position 0 and no particle),
    keeps those whose position lies in it first, in candidate order, and
    its first ``max_xcell`` slots (``jnp.argsort(~belongs, stable=True)``).
    It runs in slabs of ``x_slab`` x-columns (see ``_slab_width``); each
    cell's selection reads only its neighbours, so the result is the same
    for every width. Returns (positions, active, fields)."""
    ndim = len(pos)
    ni = tuple(active.shape[:ndim])
    mx = active.shape[-1]
    offsets = list(itertools.product((-1, 0, 1), repeat=ndim))
    width = _slab_width(ni, len(offsets) * mx, x_slab)
    dev = active.device
    padded = [_pad(p, 0.0, ndim) for p in pos]
    padded_a = _pad(active, False, ndim)
    padded_f = {k: _pad(v, 0.0, ndim) for k, v in fields.items()}
    out_pos = [torch.empty_like(p) for p in pos]
    out_a = torch.empty_like(active)
    out_f = {k: torch.empty_like(v) for k, v in fields.items()}
    for lo in range(0, ni[0], width):
        hi = min(ni[0], lo + width)

        def neighbours(P):
            return torch.cat([
                P[(slice(lo + 1 + o[0], hi + 1 + o[0]),)
                  + tuple(slice(1 + o[d], ni[d] + 1 + o[d]) for d in range(1, ndim))]
                for o in offsets], dim=-1)

        cand = [neighbours(P) for P in padded]
        belongs = neighbours(padded_a)
        for d in range(ndim):
            c = torch.clamp(
                torch.floor(_over(cand[d] - geometry.origin[d], geometry.di[d])).to(torch.int64),
                0, ni[d] - 1)
            own = _index(hi - lo, torch.int64, dev, 0, ndim) + lo if d == 0 else \
                _index(ni[d], torch.int64, dev, d, ndim)
            belongs = belongs & (c == own)
        # active-belonging first, in candidate order; the first max_xcell
        order = torch.argsort((~belongs).to(torch.uint8), dim=-1, stable=True)[..., :mx]
        for src, dst in zip(cand, out_pos):
            dst[lo:hi] = torch.take_along_dim(src, order, dim=-1)
        out_a[lo:hi] = torch.take_along_dim(belongs, order, dim=-1)
        for k, P in padded_f.items():
            out_f[k][lo:hi] = torch.take_along_dim(neighbours(P), order, dim=-1)
    return out_pos, out_a, out_f


def move_particles(
    particles: Particles, geometry, fields: Dict[str, Tensor], x_slab: Optional[int] = None
) -> Tuple[Particles, Dict[str, Tensor]]:
    """Re-slot particles into their current cells (JustPIC move_particles!).

    Assumes CFL-limited motion (≤ 1 cell per step): candidates come from the
    3×3 neighbourhood; each cell keeps up to ``max_xcell`` by slot
    compaction (``move_cells``, ``x_slab`` x-columns at a time)."""
    (px, py), active, new_fields = move_cells(
        (particles.px, particles.py), particles.active, fields, geometry, x_slab)
    return particles.replace(px=px, py=py, active=active), new_fields


# --- particle ↔ grid transfers ---------------------------------------------
def _corner_weights(particles, geometry, xnode, ynode):
    """Inverse-bilinear weight of each particle w.r.t. a node position grid."""
    dx, dy = geometry.di
    wx = 1.0 - _over(torch.abs(particles.px - xnode), dx)
    wy = 1.0 - _over(torch.abs(particles.py - ynode), dy)
    w = torch.clamp(wx, 0.0, 1.0) * torch.clamp(wy, 0.0, 1.0)
    return torch.where(particles.active, w, 0.0)


def _cells(particles, geometry):
    """Each slot's cell (ci, cj) from its position, clamped to the grid."""
    nx, ny = particles.px.shape[:2]
    ox, oy = geometry.origin
    dx, dy = geometry.di
    ci = torch.clamp(torch.floor(_over(particles.px - ox, dx)).to(torch.int64), 0, nx - 1)
    cj = torch.clamp(torch.floor(_over(particles.py - oy, dy)).to(torch.int64), 0, ny - 1)
    return ci, cj


def particle2grid(field: Tensor, particles: Particles, geometry) -> Tensor:
    """Particle field → vertices (nx+1, ny+1), bilinear-weighted average,
    accumulated in ``field``'s dtype."""
    nx, ny = particles.px.shape[:2]
    dx, dy = geometry.di
    ox, oy = geometry.origin
    num = torch.zeros((nx + 2) * (ny + 2), dtype=field.dtype, device=field.device)
    den = torch.zeros_like(num)
    # each particle contributes to the 4 vertices of its cell
    ci, cj = _cells(particles, geometry)
    pdt = particles.px.dtype
    for di in (0, 1):
        for dj in (0, 1):
            vx_pos = ox + (ci + di).to(pdt) * dx
            vy_pos = oy + (cj + dj).to(pdt) * dy
            w = _corner_weights(particles, geometry, vx_pos, vy_pos).to(field.dtype)
            idx = ((ci + di) * (ny + 2) + (cj + dj)).reshape(-1)
            num.index_add_(0, idx, (w * field).reshape(-1))
            den.index_add_(0, idx, w.reshape(-1))
    num, den = num.reshape(nx + 2, ny + 2), den.reshape(nx + 2, ny + 2)
    out = num[:-1, :-1] / torch.where(den[:-1, :-1] == 0, 1.0, den[:-1, :-1])
    return out[: nx + 1, : ny + 1]


def grid2particle(vertex_field: Tensor, particles: Particles, geometry) -> Tensor:
    """Vertex field (nx+1, ny+1) → particle positions (bilinear)."""
    ox, oy = geometry.origin
    dx, dy = geometry.di
    return _bilinear(vertex_field, ox, oy, dx, dy, particles.px, particles.py)


def _center_coords(particles, geometry):
    nx, ny = particles.px.shape[:2]
    dx, dy = geometry.di
    ox, oy = geometry.origin
    dt, dev = particles.px.dtype, particles.px.device
    xc = ox + (_index(nx, dt, dev, 0, 2) + 0.5) * dx
    yc = oy + (_index(ny, dt, dev, 1, 2) + 0.5) * dy
    return xc, yc


def particle2centroid(field: Tensor, particles: Particles, geometry) -> Tensor:
    """Particle field → cell centers (nx, ny), weighted by distance to the
    centroid (JustPIC particle2centroid!)."""
    w = _corner_weights(particles, geometry, *_center_coords(particles, geometry))
    num = torch.sum(w * field, dim=-1)
    den = torch.sum(w, dim=-1)
    return num / torch.where(den == 0, 1.0, den)


def centroid2particle(center_field: Tensor, particles: Particles, geometry) -> Tensor:
    """Center field → particles, bilinear on the center lattice.

    A plain (nx, ny) field is edge-clamped: particles between the outermost
    centroid and the wall see the centroid value. A GHOSTED field
    (nx+2, ny+2) interpolates on the ghost-center lattice instead, so that
    near-wall particles interpolate through the boundary values the ghosts
    hold (pass it wherever the field has meaningful BCs).
    """
    ox, oy = geometry.origin
    dx, dy = geometry.di
    nx, ny = particles.px.shape[:2]
    if tuple(center_field.shape) == (nx + 2, ny + 2):
        return _bilinear(
            center_field, ox - dx / 2, oy - dy / 2, dx, dy,
            particles.px, particles.py,
        )
    return _bilinear(
        center_field, ox + dx / 2, oy + dy / 2, dx, dy, particles.px, particles.py
    )


# --- injection --------------------------------------------------------------
def _to_fill(particles: Particles):
    """Slots that injection activates: inactive slots of cells below
    ``min_xcell``, in slot order, up to ``nxcell`` per cell."""
    count = particles.count()
    needs = count < particles.min_xcell
    slot_rank = torch.cumsum(~particles.active, dim=-1)
    return (
        needs[..., None]
        & ~particles.active
        & (slot_rank <= (particles.nxcell - count)[..., None])
    )


def _dominant(v, active, nphase, rounded):
    """The phase most active slots of each cell carry (the first of equal
    counts); ``rounded`` compares ``round(v)`` (3D) instead of ``v`` (2D)."""
    w = active.to(v.dtype)
    key = torch.round(v) if rounded else v
    counts = torch.stack([torch.sum(w * (key == p), dim=-1) for p in range(nphase)], dim=-1)
    return torch.argmax(counts, dim=-1).to(v.dtype), torch.sum(w, dim=-1)


def inject_particles(
    particles: Particles,
    geometry,
    fields_from_centers: Dict[str, Tensor],
    phases=None,
    phase_field: Optional[str] = "phase",
    fields: Optional[Dict[str, Tensor]] = None,
) -> Tuple[Particles, Dict[str, Tensor]]:
    """Refill cells that dropped below ``min_xcell`` active particles
    (JustPIC inject_particles_phase!).

    New particles appear at sub-cell lattice positions; scalar fields are
    interpolated from the given center arrays; the phase (if tracked in
    ``fields``) takes the cell's dominant phase among surviving particles.
    ``phases`` is the number of phases (an int), or a cell phase field that
    a cell without survivors takes its phase from (its maximum read on the
    host gives the number of phases, as does the phase field's own without
    it).
    """
    fields = fields or {}
    nx, ny = particles.px.shape[:2]
    mx = particles.max_xcell
    dx, dy = geometry.di
    ox, oy = geometry.origin
    pdt, dev = particles.px.dtype, particles.px.device

    m = int(math.ceil(math.sqrt(mx)))
    sub = torch.as_tensor(_lattice(m, 2, mx), dtype=pdt, device=dev)
    newx = ox + (_index(nx, pdt, dev, 0, 2) + sub[:, 0]) * dx
    newy = oy + (_index(ny, pdt, dev, 1, 2) + sub[:, 1]) * dy

    # activate inactive slots in needy cells up to nxcell
    to_fill = _to_fill(particles)
    px = torch.where(to_fill, newx, particles.px)
    py = torch.where(to_fill, newy, particles.py)
    active = particles.active | to_fill
    filled = particles.replace(px=px, py=py, active=active)

    new_fields = {}
    for k, v in fields.items():
        if k in fields_from_centers:
            interp = centroid2particle(fields_from_centers[k], filled, geometry)
            new_fields[k] = torch.where(to_fill, interp, v)
        elif k == phase_field:
            # dominant phase among surviving particles of the cell; a cell
            # with NO survivors falls back to the given ``phases`` cell field
            # instead of taking phase 0
            if isinstance(phases, int):
                nphase = phases
            else:
                ref = v if phases is None else torch.as_tensor(phases, device=dev)
                nphase = int(torch.max(ref).item()) + 1
            dominant, survivors = _dominant(v, particles.active, nphase, rounded=False)
            if phases is not None and not isinstance(phases, int):
                dominant = torch.where(survivors > 0, dominant, ref.to(v.dtype))
            new_fields[k] = torch.where(to_fill, dominant[..., None], v)
        else:
            new_fields[k] = v
    return filled, new_fields


# --- phase ratios -----------------------------------------------------------
def phase_ratios_from_particles(
    particles: Particles, phase: Tensor, nphase: int, geometry
) -> Tuple[Tensor, Tensor]:
    """(center_ratios (nx,ny,nphase), vertex_ratios (nx+1,ny+1,nphase)) from
    per-particle integer phases, bilinear-weighted (reference
    update_phase_ratios!), in the particles' dtype."""
    nx, ny = particles.px.shape[:2]
    dx, dy = geometry.di
    ox, oy = geometry.origin
    pdt = particles.px.dtype

    # centers
    wc = _corner_weights(particles, geometry, *_center_coords(particles, geometry))
    num_c = torch.stack(
        [torch.sum(wc * (phase == p), dim=-1) for p in range(nphase)], dim=-1
    )
    den_c = torch.sum(num_c, dim=-1, keepdim=True)
    center = num_c / torch.where(den_c == 0, 1.0, den_c)

    # vertices: accumulate from the 4 adjacent cells, all phases of a vertex
    # in one row
    ci, cj = _cells(particles, geometry)
    onehot = torch.stack([(phase == p) for p in range(nphase)], dim=-1).to(pdt)
    num_v = torch.zeros(((nx + 2) * (ny + 2), nphase), dtype=pdt, device=phase.device)
    for di in (0, 1):
        for dj in (0, 1):
            vx_pos = ox + (ci + di).to(pdt) * dx
            vy_pos = oy + (cj + dj).to(pdt) * dy
            w = _corner_weights(particles, geometry, vx_pos, vy_pos)
            idx = ((ci + di) * (ny + 2) + (cj + dj)).reshape(-1)
            num_v.index_add_(0, idx, (w[..., None] * onehot).reshape(-1, nphase))
    num_v = num_v.reshape(nx + 2, ny + 2, nphase)[: nx + 1, : ny + 1]
    den_v = torch.sum(num_v, dim=-1, keepdim=True)
    vertex = num_v / torch.where(den_v == 0, 1.0, den_v)
    return center, vertex


# --- subgrid diffusion ------------------------------------------------------
def subgrid_characteristic_time(material, T, P, phase_ratios, di):
    """dt₀ = ρCp / (K·(2/dx² + 2/dy²)) per cell (reference
    src/particles/subgrid_diffusion.jl)."""
    from justrelax_tpu_torch.rheology.materials import compute_conductivity, compute_rhoCp

    rhoCp = compute_rhoCp(material, T=T, P=P, phase_ratios=phase_ratios)
    K = compute_conductivity(material, T=T, P=P, phase_ratios=phase_ratios)
    return rhoCp / (K * (2.0 / di[0] ** 2 + 2.0 / di[1] ** 2))


def subgrid_diffusion(
    pT: Tensor, T_grid: Tensor, dT_grid: Tensor, dt0_grid: Tensor,
    particles: Particles, geometry, dt, d=1.0
):
    """Gerya-scheme subgrid diffusion of the particle temperature (JustPIC
    ``subgrid_diffusion_centroid!``; reference call site
    test_Blankenbach.jl:223-226).

    The particle temperature relaxes toward the PRE-diffusion grid field on
    the subgrid characteristic time, and the grid increment that the subgrid
    relaxation did not account for is added back:

      ΔT_sub^p  = (T_old@p − pT)·(1 − exp(−d·dt/dt₀@p))
      ΔT_rem    = ΔT_grid − P2G(ΔT_sub^p)
      pT        ← pT + ΔT_sub^p + ΔT_rem@p

    ``T_grid`` is the post-diffusion grid temperature and ``dT_grid`` the
    diffusion increment (thermal.dT = T − Told). Pass them GHOSTED
    ((nx+2, ny+2), as ``thermal.T``/``thermal.dT`` are stored) so near-wall
    particles interpolate through the boundary values; plain (nx, ny)
    center arrays are accepted with edge-clamped interpolation.
    """
    nx, ny = particles.px.shape[:2]
    ghosted = tuple(T_grid.shape) == (nx + 2, ny + 2)
    T_old_p = centroid2particle(T_grid - dT_grid, particles, geometry)
    dt0_at_p = centroid2particle(dt0_grid, particles, geometry)
    num = torch.full((), -d * dt, dtype=dt0_at_p.dtype, device=dt0_at_p.device)
    fac = torch.exp(num / torch.clamp_min(dt0_at_p, 1e-30))
    dT_sub_p = torch.where(particles.active, (T_old_p - pT) * (1.0 - fac), 0.0)
    dT_sub_grid = particle2centroid(dT_sub_p, particles, geometry)
    if ghosted:
        dT_rem = dT_grid.clone()
        dT_rem[1:-1, 1:-1] += -dT_sub_grid
    else:
        dT_rem = dT_grid - dT_sub_grid
    dT_rem_p = centroid2particle(dT_rem, particles, geometry)
    return torch.where(particles.active, pT + dT_sub_p + dT_rem_p, pT)
