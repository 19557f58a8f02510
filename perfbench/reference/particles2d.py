"""Plain reference of the 2D particle-in-cell material transport: the
stratified random seeding, midpoint RK2 advection through the staggered
velocity grids, re-binning into per-cell slots, injection into cells that
ran low, and phase ratios at centers and vertices.

Written from JustPIC's semantics (``init_particles``, ``advection!`` with
``RungeKutta2``, ``move_particles!``, ``inject_particles_phase!``,
``phase_ratios_center!``/``phase_ratios_vertex!``) in the slot layout the
models state: arrays (nx, ny, slots) with an ``active`` mask. Re-binning is
a sort: each particle takes a key made of its new cell, the place of its old
cell in that cell's 3×3 neighbourhood (−1, 0, +1 along x, then y, y
fastest) and its old slot; each cell keeps its first ``slots`` keys. Plain
PyTorch; it imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _over(a, d):
    """``a / d`` with ``d`` a tensor of ``a``'s dtype (a true division)."""
    return a / torch.full((), d, dtype=a.dtype, device=a.device)


def lattice(m, count):
    """The first ``count`` points of the ``m``×``m`` sub-cell lattice,
    x-major."""
    ax = (np.arange(m) + 0.5) / m
    return np.stack(np.meshgrid(ax, ax, indexing="ij"), axis=-1).reshape(-1, 2)[:count]


def seed_particles(n, dx, dy, per_cell, slots, seed, dtype, device):
    """``per_cell`` particles in each cell, jittered around the sub-cell
    lattice by numpy's generator (float64, the cell's lattice spacing times
    0.9), in the first slots; returns (px, py, active)."""
    rng = np.random.default_rng(seed)
    m = int(math.ceil(math.sqrt(per_cell)))
    sub = lattice(m, per_cell)
    pos = sub[None, None] + (rng.random((n, n, per_cell, 2)) - 0.5) / m * 0.9
    px = np.zeros((n, n, slots))
    py = np.zeros((n, n, slots))
    px[..., :per_cell] = (np.arange(n)[:, None, None] + pos[..., 0]) * dx
    py[..., :per_cell] = (np.arange(n)[None, :, None] + pos[..., 1]) * dy
    active = np.zeros((n, n, slots), dtype=bool)
    active[..., :per_cell] = True
    return (torch.as_tensor(px, dtype=dtype, device=device),
            torch.as_tensor(py, dtype=dtype, device=device),
            torch.as_tensor(active, device=device))


def _sample(Fg, x0, y0, dx, dy, X, Y):
    """Bilinear sample of the node grid ``Fg`` (nodes x0 + i·dx,
    y0 + j·dy) at (X, Y), the cell index clamped into the grid."""
    nx, ny = Fg.shape
    fx, fy = _over(X - x0, dx), _over(Y - y0, dy)
    ix = torch.clamp(torch.floor(fx).to(torch.int64), 0, nx - 2)
    iy = torch.clamp(torch.floor(fy).to(torch.int64), 0, ny - 2)
    tx = torch.clamp(fx - ix, 0.0, 1.0)
    ty = torch.clamp(fy - iy, 0.0, 1.0)
    return (Fg[ix, iy] * (1 - tx) * (1 - ty) + Fg[ix + 1, iy] * tx * (1 - ty)
            + Fg[ix, iy + 1] * (1 - tx) * ty + Fg[ix + 1, iy + 1] * tx * ty)


def _velocity(Vx, Vy, dx, dy, X, Y):
    return (_sample(Vx, 0.0, -dy / 2, dx, dy, X, Y),
            _sample(Vy, -dx / 2, 0.0, dx, dy, X, Y))


def advect(px, py, active, Vx, Vy, dx, dy, lengths, dt):
    """Midpoint RK2 over ``dt``, clamped into the box; inactive slots keep
    their positions."""
    vx1, vy1 = _velocity(Vx, Vy, dx, dy, px, py)
    vx2, vy2 = _velocity(Vx, Vy, dx, dy, px + 0.5 * dt * vx1, py + 0.5 * dt * vy1)
    eps = 1e-12 * max(lengths)
    X = torch.clamp(px + dt * vx2, eps, lengths[0] - eps)
    Y = torch.clamp(py + dt * vy2, eps, lengths[1] - eps)
    return torch.where(active, X, px), torch.where(active, Y, py)


def cell_of(px, py, dx, dy):
    nx, ny = px.shape[:2]
    ci = torch.clamp(torch.floor(_over(px, dx)).to(torch.int64), 0, nx - 1)
    cj = torch.clamp(torch.floor(_over(py, dy)).to(torch.int64), 0, ny - 1)
    return ci, cj


def rebin(px, py, active, phase, dx, dy):
    """Each particle into the cell its position lies in, from its old cell
    or one of that cell's eight neighbours (a particle that jumped further
    is dropped); each cell keeps its first ``slots`` particles in the order
    (old cell's place in the 3×3 neighbourhood, old slot). Returns (px, py,
    active, phase); inactive slots hold zeros."""
    nx, ny, mx = px.shape
    dev = px.device
    ci, cj = cell_of(px, py, dx, dy)
    si = torch.arange(nx, device=dev)[:, None, None].expand(nx, ny, mx)
    sj = torch.arange(ny, device=dev)[None, :, None].expand(nx, ny, mx)
    slot = torch.arange(mx, device=dev)[None, None, :].expand(nx, ny, mx)
    ok = active & ((ci - si).abs() <= 1) & ((cj - sj).abs() <= 1)
    dest = (ci * ny + cj)[ok]
    place = ((si - ci + 1) * 3 + (sj - cj + 1))[ok]
    key = dest * (9 * mx) + place * mx + slot[ok]
    key, order = torch.sort(key)
    dest = key // (9 * mx)
    first = torch.searchsorted(dest, dest, right=False)
    rank = torch.arange(dest.numel(), device=dev) - first
    keep = rank < mx
    flat = dest[keep] * mx + rank[keep]
    out = []
    for a in (px, py, phase):
        o = torch.zeros(nx * ny * mx, dtype=a.dtype, device=dev)
        o[flat] = a[ok][order][keep]
        out.append(o.reshape(nx, ny, mx))
    act = torch.zeros(nx * ny * mx, dtype=torch.bool, device=dev)
    act[flat] = True
    return out[0], out[1], act.reshape(nx, ny, mx), out[2]


def inject(px, py, active, phase, dx, dy, per_cell, min_count, nphase):
    """Cells with fewer than ``min_count`` particles get new ones in their
    free slots, in slot order, up to ``per_cell``: slot k at the k-th point
    of the sub-cell lattice, carrying the phase that most of the cell's
    particles carry (the lowest of equal counts; phase 0 in an empty
    cell)."""
    nx, ny, mx = px.shape
    dtype, dev = px.dtype, px.device
    count = active.sum(dim=-1)
    free_rank = torch.cumsum(~active, dim=-1)
    fill = ((count < min_count)[..., None] & ~active
            & (free_rank <= (per_cell - count)[..., None]))
    m = int(math.ceil(math.sqrt(mx)))
    sub = torch.as_tensor(lattice(m, mx), dtype=dtype, device=dev)
    newx = (torch.arange(nx, dtype=dtype, device=dev)[:, None, None] + sub[:, 0]) * dx
    newy = (torch.arange(ny, dtype=dtype, device=dev)[None, :, None] + sub[:, 1]) * dy
    votes = torch.stack([(active & (phase == p)).sum(dim=-1) for p in range(nphase)], dim=-1)
    dominant = torch.argmax(votes, dim=-1).to(phase.dtype)
    return (torch.where(fill, newx, px), torch.where(fill, newy, py), active | fill,
            torch.where(fill, dominant[..., None], phase))


def phase_ratios(px, py, active, phase, dx, dy, nphase):
    """Bilinear-weighted phase ratios at centers (nx, ny, nphase) and at
    vertices (nx+1, ny+1, nphase); the vertex sums run cell by cell over
    each cell's four corners."""
    nx, ny, _ = px.shape
    dtype, dev = px.dtype, px.device

    def weight(xn, yn):
        wx = 1.0 - _over(torch.abs(px - xn), dx)
        wy = 1.0 - _over(torch.abs(py - yn), dy)
        return torch.where(active, torch.clamp(wx, 0.0, 1.0) * torch.clamp(wy, 0.0, 1.0), 0.0)

    onehot = [(phase == p) for p in range(nphase)]
    xc = (torch.arange(nx, dtype=dtype, device=dev)[:, None, None] + 0.5) * dx
    yc = (torch.arange(ny, dtype=dtype, device=dev)[None, :, None] + 0.5) * dy
    wc = weight(xc, yc)
    num = torch.stack([torch.sum(wc * h, dim=-1) for h in onehot], dim=-1)
    center = num / torch.where(num.sum(-1, keepdim=True) == 0, 1.0, num.sum(-1, keepdim=True))

    ci, cj = cell_of(px, py, dx, dy)
    numv = torch.zeros((nx + 1, ny + 1, nphase), dtype=dtype, device=dev)
    for a in (0, 1):
        for b in (0, 1):
            w = weight((ci + a).to(dtype) * dx, (cj + b).to(dtype) * dy)
            part = torch.stack([torch.sum(w * h, dim=-1) for h in onehot], dim=-1)
            numv[a:a + nx, b:b + ny] += part
    den = numv.sum(-1, keepdim=True)
    return center, numv / torch.where(den == 0, 1.0, den)
