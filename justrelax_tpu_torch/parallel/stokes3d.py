"""Distributed APT visco-elastic Stokes solver, 3D.

Counterpart of ``justrelax_tpu/parallel/stokes3d.py`` (the reference's
Stokes3D.jl with ImplicitGlobalGrid halos), the 3D twin of
:mod:`~justrelax_tpu_torch.parallel.stokes2d`. Each rank runs the PT loop
on its own tile of an ("x", "y", "z") mesh:

- its state is the blocked-local staggered layout of decomp.py (disjoint
  cell ownership; velocities carry shared faces and ghost layers, the
  shear-edge stresses shared edges);
- centers update locally; the three shear-edge families are computed
  redundantly on shared edges from ghost-extended η and G ("compute in
  halo"), with the serial kernels' averages;
- each velocity component updates on all its local faces from the
  ghost-extended center fields (one batch of slabs per iteration), so only
  its two transverse ghost layers need a post-update exchange, one axis
  pass per batch;
- physical BCs take the rank's mesh coordinates; the four sums of squares
  of the norms are summed over the ranks by one ``all_reduce`` per chunk,
  and the host reads ``err`` once per chunk.

The result matches the serial ``solve_ve_3d`` to rounding.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from justrelax_tpu_torch.ops import stokes3d as k3
from justrelax_tpu_torch.ops.bc import Faces, VelocityBoundaryConditions, flow_bcs
from justrelax_tpu_torch.ops.stencil import interior_add, maxloc
from justrelax_tpu_torch.ops.stokes import compute_P
from justrelax_tpu_torch.parallel import halo
from justrelax_tpu_torch.parallel.decomp import Decomp3D
from justrelax_tpu_torch.parallel.stokes2d import _freeze_rows as _freeze
from justrelax_tpu_torch.solvers.stokes2d import _ratio

__all__ = ["solve_ve_sharded_3d", "ShardedSolveResult3D", "tile_shapes_3d"]

_AXES = ("x", "y", "z")


class ShardedSolveResult3D(NamedTuple):
    Vx: Any
    Vy: Any
    Vz: Any
    P: Any
    txx: Any
    tyy: Any
    tzz: Any
    tyz: Any
    txz: Any
    txy: Any
    err: Any
    iters: Any


# per-tile surplus over the owned cells of each staggered 3D block
EXTRAS_3D = {"Vx": (1, 2, 2), "Vy": (2, 1, 2), "Vz": (2, 2, 1),
             "tyz": (0, 1, 1), "txz": (1, 0, 1), "txy": (1, 1, 0),
             "pr_yz": (0, 1, 1), "pr_xz": (1, 0, 1), "pr_xy": (1, 1, 0)}


def tile_shapes_3d(decomp: Decomp3D):
    """The leading tile shape of each staggered block of the 3D sharded
    solvers (the old stresses ``*_o`` as their stresses, the edge families'
    phase ratios ``pr_*`` as theirs; a block not named here is on the
    centers)."""
    nl = decomp.ni_local
    out = {k: tuple(n + e for n, e in zip(nl, ex)) for k, ex in EXTRAS_3D.items()}
    out.update({k + "_o": out[k] for k in ("tyz", "txz", "txy")})
    return out


def local_blocks_3d(mesh, decomp: Decomp3D, blocks: dict, names):
    """The blocks named in ``names`` as this rank's tiles."""
    shapes = tile_shapes_3d(decomp)
    return {k: mesh.local(blocks[k], shapes.get(k, decomp.ni_local)) for k in names
            if k in blocks}


def _local_faces(bc: VelocityBoundaryConditions, edges) -> VelocityBoundaryConditions:
    """``bc`` with only the faces on this rank's physical boundary. The z
    faces follow ``ops/bc.py``: free slip's ``top`` and no slip's ``bot`` are
    z index 0."""
    (fx, lx), (fy, ly), (fz, lz) = edges
    fs, ns = bc.free_slip, bc.no_slip

    def on(v, here):
        return Faces.on(v) and here

    return VelocityBoundaryConditions(
        free_slip=Faces(left=on(fs.left, fx), right=on(fs.right, lx), front=on(fs.front, fy),
                        back=on(fs.back, ly), top=on(fs.top, fz), bot=on(fs.bot, lz)),
        no_slip=Faces(left=on(ns.left, fx), right=on(ns.right, lx), front=on(ns.front, fy),
                      back=on(ns.back, ly), bot=on(ns.bot, fz), top=on(ns.top, lz)))


def flow_bcs_local_3d(V, bc: VelocityBoundaryConditions, edges):
    """The serial ``flow_bcs`` (no slip, then free slip, face by face in its
    order) on this rank's physical-boundary faces only."""
    return flow_bcs(tuple(V), _local_faces(bc, edges))


def _norm_mask(mesh, decomp: Decomp3D, d_face: int, shape, device):
    """The serial norm window ``R[1:-1, 1:-1, 1:-1]`` of the interior-face
    residual along ``d_face``, on this rank's all-faces residual, each face
    counted by one owner (its rank's faces 1…n; face 0 is the lower
    neighbour's)."""
    nl, ng = decomp.ni_local, decomp.ni_global
    masks = []
    for d in range(3):
        j = torch.arange(shape[d], device=device)
        g = mesh.axis_index(_AXES[d]) * nl[d] + j
        if d == d_face:
            m = (j >= 1) & (g >= 2) & (g <= ng[d] - 2)
        else:
            m = (g >= 1) & (g <= ng[d] - 2)
        masks.append(m)
    return masks[0][:, None, None] & masks[1][None, :, None] & masks[2][None, None, :]


def norm_masks_3d(mesh, decomp: Decomp3D, device):
    nl = decomp.ni_local
    return tuple(_norm_mask(mesh, decomp, d, tuple(n + (1 if a == d else 0)
                                                   for a, n in enumerate(nl)), device)
                 for d in range(3))


def reduced_norms_3d(mesh, decomp: Decomp3D, R, RP, masks):
    """(‖Rx‖, ‖Ry‖, ‖Rz‖, ‖RP‖) of the global fields over their serial
    windows and node counts (the 3D convention, no square root on the
    count): the four sums of squares in one ``all_reduce``."""
    ng = decomp.ni_global
    ss = torch.stack([torch.where(m, A, 0.0).square().sum() for A, m in zip(R, masks)]
                     + [RP.square().sum()])
    ss = halo.psum(ss, mesh).sqrt()
    nx, ny, nz = ng
    return (ss[0] / ((nx - 2) * (ny - 1) * (nz - 1)), ss[1] / ((nx - 1) * (ny - 2) * (nz - 1)),
            ss[2] / ((nx - 1) * (ny - 1) * (nz - 2)), ss[3] / (nx * ny * nz))


def eta_tau_fields_3d(eta_e2):
    """The maxloc preconditioner from a 2-deep ghost extension of η along
    the three axes: (ητ on the centers, with the x ghosts, the y ghosts, the
    z ghosts)."""
    full = maxloc(eta_e2, window=1)[1:-1, 1:-1, 1:-1]
    return (full[1:-1, 1:-1, 1:-1], full[:, 1:-1, 1:-1], full[1:-1, :, 1:-1],
            full[1:-1, 1:-1, :])


def eta_ghosts_3d(eta):
    """η with two ghost layers on every face (three batches)."""
    return halo.extend_axes_many([(eta, (0, 1, 2), 2)])[0]


def momentum_all_faces_3d(P, tau6, f, inv_di, extend_f=True):
    """Momentum residuals on all local faces (the serial
    ``momentum_residuals_3d`` arithmetic) from the center fields extended
    along each component's own axis in one batch. ``f`` are the body forces
    on the centers, or already extended when ``extend_f`` is false."""
    txx, tyy, tzz, tyz, txz, txy = tau6
    _dx, _dy, _dz = inv_di
    items = [(P, 0, 1), (txx, 0, 1), (P, 1, 1), (tyy, 1, 1), (P, 2, 1), (tzz, 2, 1)]
    if extend_f:
        items += [(f[0], 0, 1), (f[1], 1, 1), (f[2], 2, 1)]
    P_ex, txx_ex, P_ey, tyy_ey, P_ez, tzz_ez, *fe = halo.extend_many(items)
    fx, fy, fz = fe if extend_f else f
    Rx = (
        (txx_ex[1:, :, :] - txx_ex[:-1, :, :]) * _dx
        + (txy[:, 1:, :] - txy[:, :-1, :]) * _dy
        + (txz[:, :, 1:] - txz[:, :, :-1]) * _dz
        - (P_ex[1:, :, :] - P_ex[:-1, :, :]) * _dx
        - 0.5 * (fx[1:, :, :] + fx[:-1, :, :])
    )
    Ry = (
        (txy[1:, :, :] - txy[:-1, :, :]) * _dx
        + (tyy_ey[:, 1:, :] - tyy_ey[:, :-1, :]) * _dy
        + (tyz[:, :, 1:] - tyz[:, :, :-1]) * _dz
        - (P_ey[:, 1:, :] - P_ey[:, :-1, :]) * _dy
        - 0.5 * (fy[:, 1:, :] + fy[:, :-1, :])
    )
    Rz = (
        (txz[1:, :, :] - txz[:-1, :, :]) * _dx
        + (tyz[:, 1:, :] - tyz[:, :-1, :]) * _dy
        + (tzz_ez[:, :, 1:] - tzz_ez[:, :, :-1]) * _dz
        - (P_ez[:, :, 1:] - P_ez[:, :, :-1]) * _dz
        - 0.5 * (fz[:, :, 1:] + fz[:, :, :-1])
    )
    return Rx, Ry, Rz


def velocity_update_3d(V, R, etat, etadtau, edges):
    """The damped update of every local face from the all-faces residuals,
    the physical-boundary faces kept."""
    Vx, Vy, Vz = V
    Rx, Ry, Rz = R
    etat_x, etat_y, etat_z = etat
    etax = 0.5 * (etat_x[1:, :, :] + etat_x[:-1, :, :])
    etay = 0.5 * (etat_y[:, 1:, :] + etat_y[:, :-1, :])
    etaz = 0.5 * (etat_z[:, :, 1:] + etat_z[:, :, :-1])
    Vx_n = interior_add(Vx, Rx * etadtau / etax, pads=((0, 0), (1, 1), (1, 1)))
    Vy_n = interior_add(Vy, Ry * etadtau / etay, pads=((1, 1), (0, 0), (1, 1)))
    Vz_n = interior_add(Vz, Rz * etadtau / etaz, pads=((1, 1), (1, 1), (0, 0)))
    return (_freeze(Vx, Vx_n, 0, *edges[0]), _freeze(Vy, Vy_n, 1, *edges[1]),
            _freeze(Vz, Vz_n, 2, *edges[2]))


def exchange_velocity_ghosts_3d(V, nl):
    """Each component's two transverse ghost layers from the neighbours, one
    axis pass per batch (x/y first, then the remaining axis, so the corner
    ghosts come from the diagonal neighbour)."""
    Vx, Vy, Vz = V
    Vx, Vy, Vz = halo.post_exchange_ghosts(
        [(Vx, 1, nl[1]), (Vy, 0, nl[0]), (Vz, 0, nl[0])]).wait()
    return tuple(halo.post_exchange_ghosts(
        [(Vx, 2, nl[2]), (Vy, 2, nl[2]), (Vz, 1, nl[1])]).wait())


def solve_ve_sharded_3d(
    mesh,
    decomp: Decomp3D,
    blocks: dict,
    pt_stokes,
    flow_bc: VelocityBoundaryConditions,
    dt,
    iter_max: int = 10_000,
    nout: int = 500,
):
    """Run the VE APT Stokes solve over a 3D mesh. ``blocks`` holds this
    rank's tiles (or the whole blocked containers, cut here) of Vx, Vy, Vz,
    P, P0, Q, txx, tyy, tzz, tyz, txz, txy, their old stresses ``*_o``, eta,
    G, K, fx, fy, fz, and the scalars ``inv_dx``/``inv_dy``/``inv_dz``.

    Returns a :class:`ShardedSolveResult3D` of this rank's tiles, ``err`` (a
    0-d tensor, equal on every rank) and ``iters``. The residuals are those
    of the chunk's last iteration, as the serial solver takes them.
    """
    blocks = dict(blocks)
    nl = decomp.ni_local
    inv_di = (blocks.pop("inv_dx"), blocks.pop("inv_dy"), blocks.pop("inv_dz"))
    r, theta, etadtau = pt_stokes.r, pt_stokes.theta_dtau, pt_stokes.etadtau
    eps_rel, eps_abs = pt_stokes.eps_rel, pt_stokes.eps_abs
    nout_i = int(nout)
    max_chunks = max(1, int(math.ceil(iter_max / nout_i)))
    names = ("Vx", "Vy", "Vz", "P", "P0", "Q", "txx", "tyy", "tzz", "tyz", "txz", "txy",
             "txx_o", "tyy_o", "tzz_o", "tyz_o", "txz_o", "txy_o", "eta", "G", "K",
             "fx", "fy", "fz")
    t = local_blocks_3d(mesh, decomp, blocks, names)
    P0, Q, eta, G, K = (t[k] for k in ("P0", "Q", "eta", "G", "K"))
    tau_o = tuple(t[k] for k in ("txx_o", "tyy_o", "tzz_o", "tyz_o", "txz_o", "txy_o"))

    with mesh:
        edges = tuple(halo.axis_edges(a) for a in _AXES)
        # ---- per-solve ghost extensions, three batches for all
        eta_e2, *ext = halo.extend_axes_many(
            [(eta, (0, 1, 2), 2), (eta, (0, 1), 1), (G, (0, 1), 1), (eta, (0, 2), 1),
             (G, (0, 2), 1), (eta, (1, 2), 1), (G, (1, 2), 1), (t["fx"], (0,), 1),
             (t["fy"], (1,), 1), (t["fz"], (2,), 1)])
        eta_tau, *etat = eta_tau_fields_3d(eta_e2)
        # the edge families' η and G on every local edge (the serial averages)
        eta_xy, G_xy = k3._av_edge_xy(ext[0]), k3._av_edge_xy(ext[1])
        eta_xz, G_xz = k3._av_edge_xz(ext[2]), k3._av_edge_xz(ext[3])
        eta_yz, G_yz = k3._av_edge_yz(ext[4]), k3._av_edge_yz(ext[5])
        f_ext = tuple(ext[6:])
        _Gdt = 1.0 / (G * dt)
        dr = k3._dtau_r(theta, eta, _Gdt)
        fam = []
        for eta_e, G_e in ((eta_yz, G_yz), (eta_xz, G_xz), (eta_xy, G_xy)):
            _G_e = 1.0 / (G_e * dt)
            fam.append((eta_e, _G_e, k3._dtau_r(theta, eta_e, _G_e)))
        # each family's axes, whose physical-boundary edges stay as they are
        fam_axes = ((1, 2), (0, 2), (0, 1))
        masks = norm_masks_3d(mesh, decomp, P0.device)

        def stress(tau, eps):
            txx, tyy, tzz = (tau[i] + k3._inc(tau[i], tau_o[i], eta, eps[i], _Gdt, dr)
                             for i in range(3))
            shear = []
            for k, (eta_e, _G_e, dr_e) in enumerate(fam):
                a, b = fam_axes[k]
                old = tau[3 + k]
                new = old + k3._inc(old, tau_o[3 + k], eta_e, eps[3 + k], _G_e, dr_e)
                new = _freeze(old, new, a, *edges[a])
                shear.append(_freeze(old, new, b, *edges[b]))
            return (txx, tyy, tzz) + tuple(shear)

        def one_iteration(state):
            V, Pr, tau = state
            grad_V = k3.compute_grad_V_3d(*V, inv_di)
            RP, Pr = compute_P(Pr, P0, grad_V, Q, eta, K, G, dt, r, theta)
            eps = k3.compute_strain_rate_3d(grad_V, *V, inv_di)
            tau = stress(tau, eps)
            R = momentum_all_faces_3d(Pr, tau, f_ext, inv_di, extend_f=False)
            V = velocity_update_3d(V, R, etat, etadtau, edges)
            V = flow_bcs_local_3d(V, flow_bc, edges)
            V = exchange_velocity_ghosts_3d(V, nl)
            return (V, Pr, tau), RP, R

        state = ((t["Vx"], t["Vy"], t["Vz"]), t["P"],
                 tuple(t[k] for k in ("txx", "tyy", "tzz", "tyz", "txz", "txy")))
        err, err1, err_t, chunk = math.inf, 1.0, None, 0
        while chunk < 1 or (_ratio(err, err1) > eps_rel and err > eps_abs
                            and chunk < max_chunks):
            for _ in range(nout_i):
                state, RP, R = one_iteration(state)
            err_t = torch.stack(reduced_norms_3d(mesh, decomp, R, RP, masks)).amax()
            err = float(err_t)  # the one host read per chunk
            if chunk == 0:
                err1 = err
            chunk += 1
    (Vx, Vy, Vz), Pr, tau = state
    return ShardedSolveResult3D(Vx, Vy, Vz, Pr, *tau, err=err_t, iters=chunk * nout_i)
