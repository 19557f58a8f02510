"""Distributed visco-elasto-plastic APT Stokes solver, 2D.

Counterpart of ``justrelax_tpu/parallel/stokes2d_vep.py``: the flagship
solver (``solvers/stokes2d_vep.py``; reference multi-phase ``_solve!``
Stokes2D.jl:577-883 under ImplicitGlobalGrid/MPI) run on each rank's tile.
It shares the fused center+vertex stress update with the serial solver,
whose center→vertex averages take an ``extend`` hook
(``ops/stokes_vep.py``): this module passes a ``halo.extend``-based one, so
ranks at a physical boundary replicate the outermost layer (the serial
clamp) and interior ranks take the neighbour's layer. Shared vertices are
computed redundantly by adjacent ranks from the same inputs, so the solve
reproduces the serial solver to rounding.

Per PT iteration the only communication is the ghost extensions of the
center fields that feed the vertex pass, the preconditioner and the
momentum stencil, and the velocity ghost-row exchange; the norms are one
``all_reduce`` per chunk.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import torch

from justrelax_tpu_torch.ops.stencil import av_a
from justrelax_tpu_torch.ops.stokes_vep import _update_stresses, rho_g_fields, vep_invariants
from justrelax_tpu_torch.parallel import halo
from justrelax_tpu_torch.parallel.decomp import Decomp2D
from justrelax_tpu_torch.parallel.stokes2d import (
    _flow_bcs_local,
    eta_tau_fields,
    momentum_all_faces,
    norm_windows,
    reduced_norms,
    velocity_update,
)
from justrelax_tpu_torch.rheology.materials import (
    _as_stack,
    get_bulk_modulus,
    get_shear_modulus,
)
from justrelax_tpu_torch.rheology.viscosity import compute_viscosity_fields
from justrelax_tpu_torch.solvers.stokes2d import _ratio

__all__ = ["solve_vep_sharded", "ShardedVEPResult2D", "tile_shapes"]


class ShardedVEPResult2D(NamedTuple):
    Vx: Any
    Vy: Any
    P: Any
    txx: Any
    tyy: Any
    txy_c: Any
    txy_v: Any
    eta: Any
    eta_v: Any
    lam: Any
    lam_v: Any
    tau_II: Any
    eta_vep: Any
    err: Any
    iters: Any


_ORDER = (
    "Vx", "Vy", "P", "Q",
    "txx", "tyy", "txy_c", "txy_v",
    "txx_o", "tyy_o", "txy_c_o", "txy_v_o",
    "EII_pl", "eta", "eta_v",
)
_OPTIONAL = ("T", "pr_c", "pr_v")
# blocks on the vertices; the rest are on the centers (velocities apart)
_VERTEX = ("txy_v", "txy_v_o", "eta_v", "pr_v", "phi_v", "vm_v")


def tile_shapes(decomp: Decomp2D):
    """The leading tile shape of each block of the 2D sharded solvers (a
    block not named here is on the centers)."""
    nxl, nyl = decomp.ni_local
    v = (nxl + 1, nyl + 1)
    return dict({k: v for k in _VERTEX}, Vx=(nxl + 1, nyl + 2), Vy=(nxl + 2, nyl + 1),
                vm_vx=(nxl + 1, nyl), vm_vy=(nxl, nyl + 1))


def local_blocks(mesh, decomp: Decomp2D, blocks: dict, names):
    """The blocks named in ``names`` as this rank's tiles (``GridMesh.local``)."""
    shapes = tile_shapes(decomp)
    return {k: mesh.local(blocks[k], shapes.get(k, decomp.ni_local)) for k in names
            if k in blocks}


def extend_ghosts(arrays):
    """One ghost layer on every face of each center tile, all in one round
    (two batches): the ``extend_many`` hook of the stress update."""
    return halo.extend2_many([(A, 1) for A in arrays])


def extend2(A):
    """One ghost layer on every face of a center tile."""
    return extend_ghosts([A])[0]


def eta_tau_ghosts(eta):
    """η with two ghost layers on every face, for the maxloc ητ."""
    return halo.extend2_many([(eta, 2)])[0]


def solve_vep_sharded(
    mesh,
    decomp: Decomp2D,
    blocks: dict,
    pt_stokes,
    flow_bc,
    material,
    dt,
    iter_max: int = 50_000,
    iter_min: int = 100,
    nout: int = 500,
    viscosity_relaxation: float = 1.0e-2,
    lambda_relaxation: float = 0.2,
    viscosity_cutoff: Tuple[float, float] = (-math.inf, math.inf),
):
    """Run the multi-phase VEP APT solve over the mesh.

    ``blocks`` holds this rank's tiles (or the whole blocked containers) of
    the fields in ``_ORDER`` plus the scalars ``inv_dx``/``inv_dy``; an
    optional ``T`` (centers) and the phase-ratio stacks ``pr_c`` (centers)
    and ``pr_v`` (vertices, shared rows), whose trailing phase axis is not
    split. ``P0 ← P`` at solve entry, as in the serial solver
    (Stokes2D.jl:610). Returns a :class:`ShardedVEPResult2D` of this rank's
    tiles, ``err`` (equal on every rank) and ``iters``.
    """
    blocks = dict(blocks)
    nxl, nyl = decomp.ni_local
    inv_dx, inv_dy = blocks.pop("inv_dx"), blocks.pop("inv_dy")
    r, theta_dtau, etadtau = pt_stokes.r, pt_stokes.theta_dtau, pt_stokes.etadtau
    eps_rel, eps_abs = pt_stokes.eps_rel, pt_stokes.eps_abs
    nout_i = int(nout)
    max_chunks = max(1, int(math.ceil(iter_max / nout_i)))
    min_chunks = int(math.ceil(iter_min / nout_i))
    t = local_blocks(mesh, decomp, blocks, _ORDER + _OPTIONAL)
    P0, Q = t["P"], t["Q"]
    T, pr_c, pr_v = t.get("T"), t.get("pr_c"), t.get("pr_v")
    material = _as_stack(material, P0)

    with mesh:
        fx, lx_ = halo.axis_edges("x")
        fy, ly_ = halo.axis_edges("y")
        edges = ((fx, lx_), (fy, ly_))
        K_c = get_bulk_modulus(material, pr_c, like=P0)
        G_c = get_shear_modulus(material, pr_c, like=P0)
        T_vertex = None if T is None else av_a(extend2(T))
        # the old stresses' vertex averages and the plastic parameters are
        # fixed during the solve
        inv = vep_invariants(t["txx_o"], t["tyy_o"], t["txy_c_o"], t["txy_v_o"], t["EII_pl"],
                             material, pr_c, pr_v, extend_many=extend_ghosts)
        mx, my = norm_windows(mesh, decomp, P0.device)

        def momentum(Pc, txx, tyy, txy_v, rho_gx, rho_gy):
            # ρg is buoyancy-coupled (it may depend on P), so it is extended
            # per call rather than hoisted
            return momentum_all_faces(Pc, txx, tyy, txy_v, rho_gx, rho_gy, inv_dx, inv_dy,
                                      extend_rho_g=True)

        def one_iteration(c: dict) -> dict:
            eta_tau, etat_x, etat_y = eta_tau_fields(eta_tau_ghosts(c["eta"]))
            Vx, Vy = c["Vx"], c["Vy"]
            grad_V = (Vx[1:, 1:-1] - Vx[:-1, 1:-1]) * inv_dx + (
                Vy[1:-1, 1:] - Vy[1:-1, :-1]) * inv_dy
            _Kdt = 1.0 / (K_c * dt)
            rhs = -grad_V + Q / dt
            RP = -(c["theta"] - P0) * _Kdt + rhs
            psi = 1.0 / (1.0 / eta_tau + 1.0 / (G_c * dt)) * (r / theta_dtau)
            theta = ((P0 * _Kdt + rhs) * psi + c["theta"]) / (1.0 + _Kdt * psi)

            rho_gx, rho_gy = rho_g_fields(material, T, c["P"], pr_c)
            third = 1.0 / 3.0
            exx = (Vx[1:, 1:-1] - Vx[:-1, 1:-1]) * inv_dx - grad_V * third
            eyy = (Vy[1:-1, 1:] - Vy[1:-1, :-1]) * inv_dy - grad_V * third
            exy = 0.5 * ((Vx[:, 1:] - Vx[:, :-1]) * inv_dy + (Vy[1:, :] - Vy[:-1, :]) * inv_dx)
            res = _update_stresses(exx, eyy, exy, c["txx"], c["tyy"], c["txy_c"], c["txy_v"],
                                   theta, c["eta"], c["lam"], c["lam_v"], inv,
                                   lambda_relaxation, dt, theta_dtau, extend_ghosts)
            zv = torch.zeros_like(c["eta_v"])
            eta, eta_v = compute_viscosity_fields(
                c["eta"], c["eta_v"], material, res.txx, res.tyy, res.txy_c, zv, zv,
                res.txy_v, pr_c, pr_v, T=T, T_v=T_vertex, mode="tau",
                relaxation=viscosity_relaxation, cutoff=viscosity_cutoff)
            Rx, Ry = momentum(res.P_corrected, res.txx, res.tyy, res.txy_v, rho_gx, rho_gy)
            Vx, Vy = velocity_update(Vx, Vy, Rx, Ry, etat_x, etat_y, etadtau, edges)
            Vx, Vy = _flow_bcs_local(Vx, Vy, flow_bc, fx, lx_, fy, ly_)
            Vx, Vy = halo.post_exchange_ghosts([(Vx, 1, nyl), (Vy, 0, nxl)]).wait()
            return dict(Vx=Vx, Vy=Vy, P=res.P_corrected, theta=theta, txx=res.txx,
                        tyy=res.tyy, txy_c=res.txy_c, txy_v=res.txy_v, eta=eta, eta_v=eta_v,
                        lam=res.lam, lam_v=res.lam_v, tau_II=res.tau_II,
                        eta_vep=res.eta_vep, RP=RP)

        def residual_norms(c):
            rho_gx, rho_gy = rho_g_fields(material, T, c["P"], pr_c)
            Rx, Ry = momentum(c["P"], c["txx"], c["tyy"], c["txy_v"], rho_gx, rho_gy)
            return reduced_norms(mesh, decomp, Rx, Ry, c["RP"], mx, my)

        zc = torch.zeros_like(P0)
        c = dict(Vx=t["Vx"], Vy=t["Vy"], P=P0, theta=P0, txx=t["txx"], tyy=t["tyy"],
                 txy_c=t["txy_c"], txy_v=t["txy_v"], eta=t["eta"], eta_v=t["eta_v"], lam=zc,
                 lam_v=torch.zeros_like(t["txy_v"]), tau_II=zc, eta_vep=zc, RP=zc)
        err, err1, err_t, chunk = math.inf, 1.0, None, 0
        while chunk < min_chunks or (_ratio(err, err1) > eps_rel and err > eps_abs
                                     and chunk < max_chunks):
            for _ in range(nout_i):
                c = one_iteration(c)
            err_t = torch.stack(residual_norms(c)).amax()
            err = float(err_t)  # the one host read per chunk
            if chunk == 0:
                err1 = err
            chunk += 1
    return ShardedVEPResult2D(**{k: c[k] for k in ShardedVEPResult2D._fields[:-2]},
                              err=err_t, iters=chunk * nout_i)
