"""Distributed DYREL Stokes solver, 2D.

Counterpart of ``justrelax_tpu/parallel/dyrel.py``. The JAX package hands
the sharding of ``solve_dyrel`` to XLA's SPMD partitioner, which turns each
shifted slice into a neighbour permute and each reduction into an
all-reduce; PyTorch has no such partitioner. The port runs the serial
solver itself (``solvers/dyrel.py::solve_dyrel``) on each rank, as the
reference runs DYREL under MPI (src/DYREL/solver.jl:199-206, 225-226), with
its halo hook:

- each rank holds an overlapping window of the global grid: its own cells
  and one more cell on each side that faces a neighbour, and every
  staggered array on that window (the global array's slice), so the serial
  stencils, clamps and boundary conditions run on it unchanged;
- one DR iteration leaves wrong values only in that overlap: the outermost
  face and velocity ghost layers, and what the clamped vertex average
  feeds at the outermost vertex (its stress, λ and η, the Gershgorin bound
  beside it), which no owned node reads before the velocities are
  exchanged; after every iteration the velocity halo is taken from the
  ranks that own those nodes, one batch of slabs per axis pass, so the
  corners come from the diagonal neighbour;
- the norms, the Rayleigh quotient of the damping estimate and the mean η
  of the penalty are sums over the nodes each rank owns, summed over the
  ranks in one ``all_reduce`` each time; every rank gets the same bits and
  takes the same decisions. The Gershgorin bound is per node, as in the
  JAX package, so it needs no reduction;
- physical boundary conditions act on the faces of the physical boundary
  only.

Every owned value is computed from the same inputs by the same operations
as in the serial solve; only the order of the sums differs. The route runs
eagerly on the card: a staged exchange holds a host copy, which no CUDA
graph can hold. The result is gathered: every rank returns the global
``StokesState`` and the info, as the JAX package's returns them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from justrelax_tpu_torch.core.grid import NonuniformGeometry
from justrelax_tpu_torch.ops.bc import Faces, VelocityBoundaryConditions
from justrelax_tpu_torch.parallel import halo, multihost
from justrelax_tpu_torch.parallel.decomp import Decomp2D, unblock_staggered
from justrelax_tpu_torch.solvers.dyrel import solve_dyrel

__all__ = ["solve_dyrel_sharded", "DyrelWindow"]

_AXES = ("x", "y")


class DyrelWindow:
    """This rank's overlapping window of a 2D grid of ``ni`` cells over
    ``mesh``: along each axis the cells ``[lo, hi)``, its tile of ``n``
    owned cells widened by one cell on each side that faces a neighbour.
    An array on the global grid has ``n_g + e`` nodes along an axis (``e``
    from −1 for interior faces to 2 for velocity ghost layers); its window
    is the slice ``[lo, hi + e)``. It is the distributed layer's hook of
    ``solve_dyrel``: :meth:`exchange` and :meth:`sums`, and ``ni``."""

    def __init__(self, mesh, ni: Tuple[int, int]):
        self.mesh = mesh
        self.ni = tuple(int(n) for n in ni)
        self.decomp = Decomp2D.make(self.ni, mesh.shape)
        self.n = self.decomp.ni_local
        self.r = tuple(mesh.axis_index(a) for a in _AXES)
        self.first = tuple(r == 0 for r in self.r)
        self.last = tuple(r == mesh.axis_size(a) - 1 for r, a in zip(self.r, _AXES))
        self.lo = tuple(0 if f else r * n - 1 for f, r, n in zip(self.first, self.r, self.n))
        self.hi = tuple(ng if la else (r + 1) * n + 1
                        for la, r, n, ng in zip(self.last, self.r, self.n, self.ni))
        self.n_loc = tuple(h - l for h, l in zip(self.hi, self.lo))

    def _e(self, A, axis, n_ref):
        return A.shape[axis] - n_ref[axis]

    def cut(self, A):
        """The window of a global array (its leading two axes), contiguous,
        on the mesh's device."""
        if A is None:
            return None
        A = torch.as_tensor(A)
        idx = tuple(slice(self.lo[a], self.hi[a] + self._e(A, a, self.ni)) for a in range(2))
        return A[idx].contiguous().to(self.mesh.device)

    def _owned(self, A, axis):
        """The local range of the nodes this rank owns along ``axis``: each
        global node is owned by one rank (a shared face or vertex by the
        higher one, a physical ghost layer by the rank beside it)."""
        e = self._e(A, axis, self.n_loc)
        s = 1 if e == 2 else 0
        r, n = self.r[axis], self.n[axis]
        start = 0 if self.first[axis] else r * n + s
        end = self.ni[axis] + e if self.last[axis] else (r + 1) * n + s
        return start - self.lo[axis], end - self.lo[axis]

    def sums(self, tensors):
        """Each tensor's sum over the nodes this rank owns, summed over the
        ranks: one ``all_reduce`` for all."""
        parts = []
        for A in tensors:
            (a0, a1), (b0, b1) = self._owned(A, 0), self._owned(A, 1)
            parts.append(A[a0:a1, b0:b1].sum())
        return halo.psum(torch.stack(parts), self.mesh)

    def exchange(self, tensors):
        """Refresh the overlap of each local array in place from the ranks
        that own it: along x, then along y (one batch each)."""
        for axis in range(2):
            items, spans = [], []
            for A in tensors:
                e = self._e(A, axis, self.n_loc)
                k = 2 if e == 2 else 1  # overlap layers on a side
                r, n, lo = self.r[axis], self.n[axis], self.lo[axis]
                # the lower neighbour's high overlap, the higher one's low one
                to_prev = A.narrow(axis, r * n + e - (k - 1) - lo, k)
                to_next = A.narrow(axis, (r + 1) * n - 1 - lo, k)
                items.append((_AXES[axis], to_prev, to_next))
                spans.append((A, k))
            got = halo.swap_many(items, self.mesh)
            for (A, k), (from_lo, from_hi) in zip(spans, got):
                if from_lo is not None:
                    A.narrow(axis, 0, k).copy_(from_lo)
                if from_hi is not None:
                    A.narrow(axis, A.shape[axis] - k, k).copy_(from_hi)

    def gather(self, A):
        """The global array from every rank's window of it (``A`` a local
        array, on every rank): each rank's blocked tile (interior-face axes
        padded on the last rank) through ``multihost.gather_blocked``."""
        idx, extras, trim = [], [], []
        for a in range(2):
            e = self._e(A, a, self.n_loc)
            start = self.r[a] * self.n[a] - self.lo[a]
            length = self.n[a] + max(e, 0)
            if e < 0 and self.last[a]:
                length -= 1
            idx.append(slice(start, start + length))
            extras.append(max(e, 0))
            trim.append(e < 0)
        tile = A[tuple(idx)]
        pad = [(0, self.n[a] - tile.shape[a] + extras[a]) for a in range(2)]
        if any(p[1] for p in pad):
            full = tile.new_zeros(tuple(self.n[a] + extras[a] for a in range(2))
                                  + tuple(tile.shape[2:]))
            full[:tile.shape[0], :tile.shape[1]] = tile
            tile = full
        B = multihost.gather_blocked(tile.contiguous(), self.mesh)
        G = unblock_staggered(B, self.decomp, tuple(extras))
        return G[tuple(slice(0, G.shape[a] - 1) if trim[a] else slice(None) for a in range(2))]


def _local_faces(bc: VelocityBoundaryConditions, window: DyrelWindow):
    """``bc`` with only the faces on this rank's physical boundary."""
    (fx, fy), (lx, ly) = window.first, window.last

    def keep(f: Faces):
        return Faces(left=Faces.on(f.left) and fx, right=Faces.on(f.right) and lx,
                     bot=Faces.on(f.bot) and fy, top=Faces.on(f.top) and ly)

    return VelocityBoundaryConditions(no_slip=keep(bc.no_slip), free_slip=keep(bc.free_slip),
                                      free_surface=bc.free_surface)


def _map_state(fn, state):
    """``state`` (a dataclass of tensors and dataclasses) with ``fn`` applied
    to every tensor."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = fn(v)
        elif dataclasses.is_dataclass(v):
            out[f.name] = _map_state(fn, v)
    return dataclasses.replace(state, **out)


def solve_dyrel_sharded(
    mesh,
    stokes,
    geometry,
    flow_bc,
    material,
    pr_center,
    pr_vertex,
    dt,
    rho_g: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    **kwargs,
):
    """``solve_dyrel`` distributed over ``mesh`` ("x", "y"): the same
    arguments as the serial solver plus the mesh, the global state and
    fields in (on any device; each rank cuts its window onto the mesh's),
    the gathered global state and the info out, on every rank (numpy-backed
    tensors on the mesh's device). A uniform grid only."""
    if len(mesh.axis_names) != 2:
        raise ValueError("solve_dyrel_sharded expects a 2D ('x', 'y') mesh")
    if isinstance(geometry, NonuniformGeometry):
        raise NotImplementedError("solve_dyrel_sharded runs on a uniform grid only")
    window = DyrelWindow(mesh, tuple(stokes.P.shape))
    local = _map_state(window.cut, stokes)
    cut = window.cut
    for k in ("T", "alpha_dT"):
        if kwargs.get(k) is not None:
            kwargs[k] = cut(kwargs[k])
    with mesh:
        out, info = solve_dyrel(
            local, geometry, _local_faces(flow_bc, window), material, cut(pr_center),
            cut(pr_vertex), dt, rho_g=None if rho_g is None else tuple(cut(a) for a in rho_g),
            halo=window, **kwargs)
        dev = mesh.device
        glob = _map_state(lambda A: torch.as_tensor(np.ascontiguousarray(window.gather(A)))
                          .to(dev), out)
    return glob, info
