"""Distributed PT thermal diffusion over the process mesh, 2D and 3D.

Counterpart of ``justrelax_tpu/parallel/thermal.py`` (the reference's MPI
thermal solve, DiffusionPT_solver.jl:110 + ``update_halo!(T)``). Each rank
holds its ghosted T tile ``(nxl+2, nyl+2[, nzl+2])``, computes the fluxes
on its local faces from ghost-extended K and θ, exchanges its ghost rows
after each update, and applies the physical BCs only where its mesh
position is on the domain's edge. The residual norm is one ``all_reduce``
of the sum of squares per chunk, read on the host: every rank gets the same
bits and takes the same decision.

Arguments may be this rank's tiles or the whole blocked arrays, which are
cut to the tile (``GridMesh.local``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from justrelax_tpu_torch.ops.bc import Faces, TemperatureBoundaryConditions
from justrelax_tpu_torch.parallel import halo
from justrelax_tpu_torch.parallel.decomp import Decomp2D, Decomp3D

__all__ = ["heatdiffusion_PT_sharded", "heatdiffusion_PT_sharded_3d"]


def _set_layer(T, axis, idx, vals, mask: bool):
    """``T`` with layer ``idx`` along ``axis`` set to ``vals`` where this
    rank's ``mask`` holds (the JAX ``jnp.where(mask, vals, T[layer])``)."""
    if not mask:
        return T
    T = T.clone()
    T.select(axis, idx).copy_(vals)
    return T


def _layer(T, axis, idx):
    return T.select(axis, idx % T.shape[axis])


def _thermal_bcs_local(T, bcs: TemperatureBoundaryConditions, fx, lx_, fy, ly_):
    """The scalar BCs at physical boundaries only (order as ops/bc.py)."""
    cv, nf = bcs.constant_value, bcs.no_flux
    if Faces.active(cv.bot):
        T = _set_layer(T, 1, 0, 2.0 * cv.bot - T[:, 1], fy)
    if Faces.active(cv.top):
        T = _set_layer(T, 1, -1, 2.0 * cv.top - T[:, -2], ly_)
    if Faces.active(cv.left):
        T = _set_layer(T, 0, 0, 2.0 * cv.left - T[1, :], fx)
    if Faces.active(cv.right):
        T = _set_layer(T, 0, -1, 2.0 * cv.right - T[-2, :], lx_)
    if Faces.on(nf.bot):
        T = _set_layer(T, 1, 0, T[:, 1], fy)
    if Faces.on(nf.top):
        T = _set_layer(T, 1, -1, T[:, -2], ly_)
    if Faces.on(nf.left):
        T = _set_layer(T, 0, 0, T[1, :], fx)
    if Faces.on(nf.right):
        T = _set_layer(T, 0, -1, T[-2, :], lx_)
    return T


def _thermal_bcs_local_3d(T, bcs: TemperatureBoundaryConditions, edges):
    """The 3D scalar BCs at physical boundaries (x left/right, y
    front/back, z bot/top, as the JAX package names them)."""
    cv, nf = bcs.constant_value, bcs.no_flux
    names = (("left", "right"), ("front", "back"), ("bot", "top"))
    for axis in range(3):
        lo_name, hi_name = names[axis]
        first, last = edges[axis]
        v_lo = getattr(cv, lo_name)
        v_hi = getattr(cv, hi_name)
        if Faces.active(v_lo):
            T = _set_layer(T, axis, 0, 2.0 * v_lo - _layer(T, axis, 1), first)
        if Faces.active(v_hi):
            T = _set_layer(T, axis, -1, 2.0 * v_hi - _layer(T, axis, -2), last)
        if Faces.on(getattr(nf, lo_name)):
            T = _set_layer(T, axis, 0, _layer(T, axis, 1), first)
        if Faces.on(getattr(nf, hi_name)):
            T = _set_layer(T, axis, -1, _layer(T, axis, -2), last)
    return T


def _face_average(mesh, A, axis):
    """½(A_i + A_{i+1}) on every local face along ``axis`` from the
    ghost-extended centers."""
    E = halo.extend(A, axis, 1, mesh=mesh)
    return 0.5 * (E.narrow(axis, 0, E.shape[axis] - 1) + E.narrow(axis, 1, E.shape[axis] - 1))


def _pt_loop(mesh, state, one, residual_sq, eps, nout, max_chunks, inv_sqrt_n):
    """The chunked PT loop from ``state`` (T first): ``nout`` iterations of
    ``one``, then the residual's sum of squares summed over the ranks; stop
    when err ≤ ϵ or after ``max_chunks`` chunks (err starts at 2ϵ, so one
    chunk runs). Returns (T, err, iters)."""
    err, err_t, chunk = 2.0 * eps, None, 0
    while err > eps and chunk < max_chunks:
        for _ in range(nout):
            state = one(state)
        ss = halo.psum(residual_sq(state).reshape(1), mesh)
        err_t = ss[0].sqrt() * inv_sqrt_n
        err = float(err_t)  # the one host read per chunk
        chunk += 1
    return state[0], err_t, chunk * nout


def heatdiffusion_PT_sharded(
    mesh,
    decomp: Decomp2D,
    T_blocks,  # this rank's ghosted T tile (or the blocked container)
    K,  # center conductivity (this rank's tile, or the global array)
    rho_Cp,
    H,
    pt_thermal,
    thermal_bc: TemperatureBoundaryConditions,
    dt,
    di: Tuple[float, float],
    iter_max: int = 50_000,
    nout: int = 1_000,
):
    """Distributed twin of ``solvers/thermal.py`` (the K/ρCp path). Returns
    (this rank's T tile, err, iters)."""
    nxl, nyl = decomp.ni_local
    nx_g, ny_g = decomp.ni_global
    inv_dx, inv_dy = 1.0 / di[0], 1.0 / di[1]
    inv_dt = 1.0 / dt
    nout_i = int(nout)
    max_chunks = max(1, int(math.ceil(iter_max / nout_i)))
    inv_sqrt_n = 1.0 / math.sqrt(nx_g * ny_g)
    c = (nxl, nyl)
    T = mesh.local(T_blocks, (nxl + 2, nyl + 2))
    K, rho_Cp, H = (mesh.local(A, c).to(T.dtype) for A in (K, rho_Cp, H))
    theta, dtau_rho = (mesh.local(A, c).to(T.dtype)
                       for A in (pt_thermal.theta_r_dtau, pt_thermal.dtau_rho))

    with mesh:
        fx, lx_ = halo.axis_edges("x")
        fy, ly_ = halo.axis_edges("y")
        Told = T
        Kfx, Kfy = _face_average(mesh, K, 0), _face_average(mesh, K, 1)
        thfx, thfy = _face_average(mesh, theta, 0), _face_average(mesh, theta, 1)
        den = 1.0 + dtau_rho * rho_Cp * inv_dt
        q0 = (torch.zeros((nxl + 1, nyl), dtype=T.dtype, device=T.device),
              torch.zeros((nxl, nyl + 1), dtype=T.dtype, device=T.device))

        def one(state):
            T, qx, qy, _, _ = state
            dTdx = (T[1:, 1:-1] - T[:-1, 1:-1]) * inv_dx
            dTdy = (T[1:-1, 1:] - T[1:-1, :-1]) * inv_dy
            qx2 = -Kfx * dTdx
            qy2 = -Kfy * dTdy
            qx = (qx * thfx + qx2) / (1.0 + thfx)
            qy = (qy * thfy + qy2) / (1.0 + thfy)
            divq = (qx[1:, :] - qx[:-1, :]) * inv_dx + (qy[:, 1:] - qy[:, :-1]) * inv_dy
            num = dtau_rho * (-divq + Told[1:-1, 1:-1] * rho_Cp * inv_dt + H) + T[1:-1, 1:-1]
            T = T.clone()
            T[1:-1, 1:-1] = num / den
            T = _thermal_bcs_local(T, thermal_bc, fx, lx_, fy, ly_)
            T = halo.exchange_ghosts(T, 0, nxl)
            T = halo.exchange_ghosts(T, 1, nyl)
            return (T, qx, qy, qx2, qy2)

        def residual_sq(state):
            T, _, _, qx2, qy2 = state
            divq2 = (qx2[1:, :] - qx2[:-1, :]) * inv_dx + (qy2[:, 1:] - qy2[:, :-1]) * inv_dy
            res = -rho_Cp * (T[1:-1, 1:-1] - Told[1:-1, 1:-1]) * inv_dt - divq2 + H
            return (res**2).sum()

        return _pt_loop(mesh, (T,) + q0 + q0, one, residual_sq, pt_thermal.eps, nout_i,
                        max_chunks, inv_sqrt_n)


def heatdiffusion_PT_sharded_3d(
    mesh,
    decomp: Decomp3D,
    T_blocks,  # this rank's ghosted T tile (extras (2, 2, 2)) or the container
    K,
    rho_Cp,
    H,
    pt_thermal,
    thermal_bc: TemperatureBoundaryConditions,
    dt,
    di,
    iter_max: int = 50_000,
    nout: int = 1_000,
):
    """3D distributed twin of ``heatdiffusion_PT`` (the K/ρCp path), over a
    mesh with axes ("x", "y", "z")."""
    nl = decomp.ni_local
    ng = decomp.ni_global
    inv_di = tuple(1.0 / d for d in di)
    inv_dt = 1.0 / dt
    nout_i = int(nout)
    max_chunks = max(1, int(math.ceil(iter_max / nout_i)))
    inv_sqrt_n = 1.0 / math.sqrt(ng[0] * ng[1] * ng[2])
    T = mesh.local(T_blocks, tuple(n + 2 for n in nl))
    K, rho_Cp, H = (mesh.local(A, nl).to(T.dtype) for A in (K, rho_Cp, H))
    theta, dtau_rho = (mesh.local(A, nl).to(T.dtype)
                       for A in (pt_thermal.theta_r_dtau, pt_thermal.dtau_rho))
    inner = (slice(1, -1),) * 3

    with mesh:
        edges = tuple(halo.axis_edges(a) for a in ("x", "y", "z"))
        Told = T
        Kf = [_face_average(mesh, K, a) for a in range(3)]
        thf = [_face_average(mesh, theta, a) for a in range(3)]
        den = 1.0 + dtau_rho * rho_Cp * inv_dt
        q0 = tuple(torch.zeros(tuple(nl[d] + (1 if d == a else 0) for d in range(3)),
                               dtype=T.dtype, device=T.device) for a in range(3))

        def grads(T):
            return (
                (T[1:, 1:-1, 1:-1] - T[:-1, 1:-1, 1:-1]) * inv_di[0],
                (T[1:-1, 1:, 1:-1] - T[1:-1, :-1, 1:-1]) * inv_di[1],
                (T[1:-1, 1:-1, 1:] - T[1:-1, 1:-1, :-1]) * inv_di[2],
            )

        def div(q):
            return ((q[0][1:, :, :] - q[0][:-1, :, :]) * inv_di[0]
                    + (q[1][:, 1:, :] - q[1][:, :-1, :]) * inv_di[1]
                    + (q[2][:, :, 1:] - q[2][:, :, :-1]) * inv_di[2])

        def one(state):
            T, q, _ = state
            g = grads(T)
            q2n = tuple(-Kf[a] * g[a] for a in range(3))
            qn = tuple((q[a] * thf[a] + q2n[a]) / (1.0 + thf[a]) for a in range(3))
            num = dtau_rho * (-div(qn) + Told[inner] * rho_Cp * inv_dt + H) + T[inner]
            T = T.clone()
            T[inner] = num / den
            T = _thermal_bcs_local_3d(T, thermal_bc, edges)
            for a in range(3):
                T = halo.exchange_ghosts(T, a, nl[a])
            return (T, qn, q2n)

        def residual_sq(state):
            T, _, q2 = state
            res = -rho_Cp * (T[inner] - Told[inner]) * inv_dt - div(q2) + H
            return (res**2).sum()

        return _pt_loop(mesh, (T, q0, q0), one, residual_sq, pt_thermal.eps, nout_i,
                        max_chunks, inv_sqrt_n)
