"""Distributed APT visco-elastic Stokes solver, 2D.

Counterpart of ``justrelax_tpu/parallel/stokes2d.py`` (the reference's MPI
domain decomposition, src/stokes/Stokes2D.jl:181-341 + ImplicitGlobalGrid).
Each rank runs the PT loop on its own tile:

- its state is the blocked-local staggered layout of decomp.py (disjoint
  cell ownership; velocities carry shared faces and ghost rows);
- neighbour center values arrive as ghost extensions (``halo.extend``) of
  the fields that change each iteration (P, τxx, τyy);
- shared faces and vertices are computed redundantly by both neighbours
  from identical ghost-extended inputs ("compute in halo"), so only the
  velocity ghost rows need a post-update exchange;
- physical BCs and the norm windows use the rank's mesh coordinates; the
  three sums of squares are summed over the ranks by one ``all_reduce`` per
  chunk, and the host reads ``err`` once per chunk.

The serial kernels of ``ops/stokes.py`` run unchanged on the tiles: the
shapes of the ghost-extended inputs select their all-faces form. The result
matches the serial solver to rounding.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from justrelax_tpu_torch.ops import stokes as kernels
from justrelax_tpu_torch.ops.bc import Faces, VelocityBoundaryConditions
from justrelax_tpu_torch.ops.stencil import av_a, interior_add, maxloc
from justrelax_tpu_torch.parallel import halo
from justrelax_tpu_torch.parallel.decomp import Decomp2D
from justrelax_tpu_torch.solvers.stokes2d import _ratio

__all__ = ["solve_ve_sharded", "ShardedSolveResult", "momentum_all_faces"]


class ShardedSolveResult(NamedTuple):
    Vx: Any
    Vy: Any
    P: Any
    txx: Any
    tyy: Any
    txy: Any
    err: Any
    iters: Any


def _set(A, idx, vals):
    A = A.clone()
    A[idx] = vals
    return A


def _flow_bcs_local(Vx, Vy, bc: VelocityBoundaryConditions, fx, lx_, fy, ly_):
    """The velocity BCs (free_slip / no_slip) on this rank's physical
    boundary faces only."""
    fs, ns = bc.free_slip, bc.no_slip
    if Faces.on(ns.left) and fx:
        Vx = _set(Vx, (0, slice(None)), 0.0)
        Vy = _set(Vy, (0, slice(None)), -Vy[1, :])
    if Faces.on(ns.right) and lx_:
        Vx = _set(Vx, (-1, slice(None)), 0.0)
        Vy = _set(Vy, (-1, slice(None)), -Vy[-2, :])
    if Faces.on(ns.bot) and fy:
        Vx = _set(Vx, (slice(None), 1), Vx[:, 2] / 3.0)
        Vx = _set(Vx, (slice(None), 0), -Vx[:, 1])
        Vy = _set(Vy, (slice(None), 0), 0.0)
    if Faces.on(ns.top) and ly_:
        Vx = _set(Vx, (slice(None), -1), -Vx[:, -2])
        Vy = _set(Vy, (slice(None), -1), 0.0)
    if Faces.on(fs.bot) and fy:
        Vx = _set(Vx, (slice(None), 0), Vx[:, 1])
    if Faces.on(fs.top) and ly_:
        Vx = _set(Vx, (slice(None), -1), Vx[:, -2])
    if Faces.on(fs.left) and fx:
        Vy = _set(Vy, (0, slice(None)), Vy[1, :])
    if Faces.on(fs.right) and lx_:
        Vy = _set(Vy, (-1, slice(None)), Vy[-2, :])
    return Vx, Vy


def momentum_all_faces(Pr, txx, tyy, txy_v, rho_gx_ex, rho_gy_ey, inv_dx, inv_dy,
                       extend_rho_g=False):
    """Momentum residuals on ALL local faces (compute-in-halo form).

    Ghost-extends the center fields the face stencils straddle, in one
    batch, and runs the serial ``ops/stokes.py`` momentum functions, whose
    shape-driven τxy alignment selects the all-faces form.
    ``rho_gx_ex``/``rho_gy_ey`` arrive extended (loop-invariant in the VE
    solve), or, with ``extend_rho_g``, on the centers and are extended in
    the same batch (the VEP solver's buoyancy may change every
    iteration)."""
    items = [(Pr, 0, 1), (txx, 0, 1), (Pr, 1, 1), (tyy, 1, 1)]
    if extend_rho_g:
        items += [(rho_gx_ex, 0, 1), (rho_gy_ey, 1, 1)]
    P_ex, txx_ex, P_ey, tyy_ey, *rho = halo.extend_many(items)
    if extend_rho_g:
        rho_gx_ex, rho_gy_ey = rho
    Rx = kernels._x_momentum(P_ex, txx_ex, txy_v, rho_gx_ex, inv_dx, inv_dy)
    Ry = kernels._y_momentum(P_ey, tyy_ey, txy_v, rho_gy_ey, inv_dx, inv_dy)
    return Rx, Ry


def _freeze_rows(A, new, axis, lo_mask: bool, hi_mask: bool):
    """``new`` with its outermost slices along ``axis`` kept from ``A`` where
    this rank sits on the physical boundary (the serial kernels never write
    global-boundary nodes)."""
    if not (lo_mask or hi_mask):
        return new
    new = new.clone()
    s = new.shape[axis]
    if lo_mask:
        new.narrow(axis, 0, 1).copy_(A.narrow(axis, 0, 1))
    if hi_mask:
        new.narrow(axis, s - 1, 1).copy_(A.narrow(axis, s - 1, 1))
    return new


def norm_windows(mesh, decomp: Decomp2D, device):
    """The masks of the serial norm windows Rx[1:-1, 1:-1] and Ry[1:-1, 1:-1]
    on this rank's all-faces residuals, each face counted by one owner
    (its rank's faces 1…n; face 0 belongs to the lower neighbour)."""
    nxl, nyl = decomp.ni_local
    nx_g, ny_g = decomp.ni_global
    rx, ry = mesh.axis_index("x"), mesh.axis_index("y")

    def rng(n):
        return torch.arange(n, device=device)

    gfx, gcy = rx * nxl + rng(nxl + 1), ry * nyl + rng(nyl)
    own_x = rng(nxl + 1) >= 1
    mx = (own_x & (gfx >= 2) & (gfx <= nx_g - 2))[:, None] & ((gcy >= 1) & (gcy <= ny_g - 2))[
        None, :]
    gcx, gfy = rx * nxl + rng(nxl), ry * nyl + rng(nyl + 1)
    own_y = rng(nyl + 1) >= 1
    my = ((gcx >= 1) & (gcx <= nx_g - 2))[:, None] & (own_y & (gfy >= 2) & (gfy <= ny_g - 2))[
        None, :]
    return mx, my


def reduced_norms(mesh, decomp: Decomp2D, Rx, Ry, RP, mx, my):
    """(‖Rx‖, ‖Ry‖, ‖RP‖) of the global fields, each over its serial window:
    the three sums of squares in one ``all_reduce``."""
    nx_g, ny_g = decomp.ni_global
    ss = torch.stack([torch.where(mx, Rx, 0.0).square().sum(),
                      torch.where(my, Ry, 0.0).square().sum(), RP.square().sum()])
    ss = halo.psum(ss, mesh)
    return (ss[0].sqrt() / math.sqrt((nx_g - 2) * (ny_g - 1)),
            ss[1].sqrt() / math.sqrt((nx_g - 1) * (ny_g - 2)),
            ss[2].sqrt() / math.sqrt(nx_g * ny_g))


def eta_tau_fields(eta_e2):
    """The maxloc preconditioner from a 2-deep ghost extension of η
    (``extend(extend(eta, 0, 2), 1, 2)``): (ητ on the centers, on the centers
    and the x ghosts, and the y ghosts). At a physical boundary the
    replicated edge gives the serial clamp."""
    full = maxloc(eta_e2, window=1)[1:-1, 1:-1]
    return full[1:-1, 1:-1], full[:, 1:-1], full[1:-1, :]


def velocity_update(Vx, Vy, Rx, Ry, etat_x, etat_y, etadtau, edges):
    """The damped update of every local face from the all-faces residuals,
    the physical-boundary faces kept."""
    (fx, lx_), (fy, ly_) = edges
    etax = 0.5 * (etat_x[1:, :] + etat_x[:-1, :])
    etay = 0.5 * (etat_y[:, 1:] + etat_y[:, :-1])
    Vx_new = interior_add(Vx, Rx * etadtau / etax, pads=((0, 0), (1, 1)))
    Vy_new = interior_add(Vy, Ry * etadtau / etay, pads=((1, 1), (0, 0)))
    return _freeze_rows(Vx, Vx_new, 0, fx, lx_), _freeze_rows(Vy, Vy_new, 1, fy, ly_)


def solve_ve_sharded(
    mesh,
    decomp: Decomp2D,
    blocks: dict,
    pt_stokes,
    flow_bc: VelocityBoundaryConditions,
    dt,
    iter_max: int = 10_000,
    nout: int = 500,
    overlap: bool = True,
):
    """Run the VE APT Stokes solve over the mesh. ``blocks`` holds this
    rank's tiles (or the whole blocked containers, cut here) of Vx, Vy, P,
    P0, Q, txx, tyy, txy, txx_o, tyy_o, txy_o, eta, G, K, rho_gx, rho_gy,
    and the scalars ``inv_dx``/``inv_dy``.

    ``overlap=True`` is the analogue of the reference's
    ``@hide_communication`` (src/stokes/Stokes2D.jl:768-785): the velocity
    ghost rows are posted after the velocity update, and waited on only
    before the shear strain rate of the next iteration, the one consumer of
    the ghosts; the divergence and the pressure update run while they
    travel. Both forms give the same bits.

    Returns a :class:`ShardedSolveResult` of this rank's tiles, ``err`` (a
    0-d tensor, equal on every rank) and ``iters``.
    """
    blocks = dict(blocks)
    nxl, nyl = decomp.ni_local
    inv_dx, inv_dy = blocks.pop("inv_dx"), blocks.pop("inv_dy")
    r, theta, etadtau = pt_stokes.r, pt_stokes.theta_dtau, pt_stokes.etadtau
    eps_rel, eps_abs = pt_stokes.eps_rel, pt_stokes.eps_abs
    nout_i = int(nout)
    max_chunks = max(1, int(math.ceil(iter_max / nout_i)))
    c, v = (nxl, nyl), (nxl + 1, nyl + 1)
    shapes = dict(Vx=(nxl + 1, nyl + 2), Vy=(nxl + 2, nyl + 1), txy=v, txy_o=v)
    t = {k: mesh.local(blocks[k], shapes.get(k, c)) for k in (
        "Vx", "Vy", "P", "P0", "Q", "txx", "tyy", "txy", "txx_o", "tyy_o", "txy_o",
        "eta", "G", "K", "rho_gx", "rho_gy")}
    P0, Q, eta, G, K = t["P0"], t["Q"], t["eta"], t["G"], t["K"]
    txx_o, tyy_o, txy_o = t["txx_o"], t["tyy_o"], t["txy_o"]

    with mesh:
        fx, lx_ = halo.axis_edges("x")
        fy, ly_ = halo.axis_edges("y")
        edges = ((fx, lx_), (fy, ly_))
        # ---- per-solve ghost extensions
        eta_e2, eta_e1, G_e1 = halo.extend2_many([(eta, 2), (eta, 1), (G, 1)])
        eta_tau, etat_x, etat_y = eta_tau_fields(eta_e2)
        eta_v, G_v = av_a(eta_e1), av_a(G_e1)  # every local vertex
        rho_gx_ex, rho_gy_ey = halo.extend_many([(t["rho_gx"], 0, 1), (t["rho_gy"], 1, 1)])
        mx, my = norm_windows(mesh, decomp, P0.device)

        def complete(state, pending):
            """``state`` with the posted velocity ghosts waited on and set."""
            return tuple(pending.wait()) + tuple(state[2:])

        def one_iteration(state, pending):
            Vx, Vy, Pr, txx, tyy, txy = state
            grad_V = kernels.compute_grad_V(Vx, Vy, inv_dx, inv_dy)
            _, Pr = kernels.compute_P(Pr, P0, grad_V, Q, eta_tau, K, G, dt, r, theta)
            if pending is not None:
                # the ghosts are read first by the shear strain rate
                Vx, Vy = complete((Vx, Vy), pending)[:2]
            exx, eyy, exy = kernels.compute_strain_rate(grad_V, Vx, Vy, inv_dx, inv_dy)
            # the ghost-built eta_v/G_v update every vertex; physical-boundary
            # vertices are kept, as the serial kernel leaves them
            txx, tyy, txy_new = kernels.compute_tau_ve(
                txx, tyy, txy, txx_o, tyy_o, txy_o, exx, eyy, exy, eta, G, theta, dt,
                eta_v=eta_v, G_v=G_v)
            txy_new = _freeze_rows(txy, txy_new, 0, fx, lx_)
            txy = _freeze_rows(txy, txy_new, 1, fy, ly_)
            Rx, Ry = momentum_all_faces(Pr, txx, tyy, txy, rho_gx_ex, rho_gy_ey, inv_dx, inv_dy)
            Vx, Vy = velocity_update(Vx, Vy, Rx, Ry, etat_x, etat_y, etadtau, edges)
            Vx, Vy = _flow_bcs_local(Vx, Vy, flow_bc, fx, lx_, fy, ly_)
            pending = halo.post_exchange_ghosts([(Vx, 1, nyl), (Vy, 0, nxl)])
            if overlap:
                return (Vx, Vy, Pr, txx, tyy, txy), pending
            Vx, Vy = pending.wait()
            return (Vx, Vy, Pr, txx, tyy, txy), None

        def residual_norms(Vx, Vy, Pr, txx, tyy, txy):
            grad_V = kernels.compute_grad_V(Vx, Vy, inv_dx, inv_dy)
            RP, _ = kernels.compute_P(Pr, P0, grad_V, Q, eta_tau, K, G, dt, r, theta)
            Rx, Ry = momentum_all_faces(Pr, txx, tyy, txy, rho_gx_ex, rho_gy_ey, inv_dx, inv_dy)
            return reduced_norms(mesh, decomp, Rx, Ry, RP, mx, my)

        state = tuple(t[k] for k in ("Vx", "Vy", "P", "txx", "tyy", "txy"))
        pending = None
        err, err1, err_t, chunk = math.inf, 1.0, None, 0
        while chunk < 1 or (_ratio(err, err1) > eps_rel and err > eps_abs
                            and chunk < max_chunks):
            for _ in range(nout_i):
                state, pending = one_iteration(state, pending)
            if pending is not None:
                # the chunk's last ghosts land before the residuals' own
                # exchanges are posted (the residuals read no velocity ghost)
                state = complete(state, pending)
                pending = None
            err_t = torch.stack(residual_norms(*state)).amax()
            err = float(err_t)  # the one host read per chunk
            if chunk == 0:
                err1 = err
            chunk += 1
    return ShardedSolveResult(*state, err=err_t, iters=chunk * nout_i)
