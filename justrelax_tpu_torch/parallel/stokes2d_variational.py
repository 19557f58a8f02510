"""Distributed variational (embedded free-surface) Stokes solver, 2D.

Counterpart of ``justrelax_tpu/parallel/stokes2d_variational.py``: the
masked twin of :mod:`~justrelax_tpu_torch.parallel.stokes2d_vep`
(reference ``solve_VariationalStokes!``, variational_stokes/Stokes2D.jl:
24-333, under ImplicitGlobalGrid/MPI). Every operator is weighted or masked
by the RockRatio ϕ as in the serial solver, with the ϕ fields and the
validity masks blocked over the mesh as read-only inputs of the solve: the
masks read neighbouring ϕ, so they are computed from the *global* ϕ and
then blocked, as the reference updates the RockRatio outside the PT loop.
The ϕ-weighting happens before the ghost extension, so the neighbour's
contributions arrive weighted and the solve reproduces the serial solver to
rounding.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import torch

from justrelax_tpu_torch.ops.stokes_vep import _update_stresses, rho_g_fields, vep_invariants
from justrelax_tpu_torch.parallel import halo
from justrelax_tpu_torch.parallel.decomp import Decomp2D
from justrelax_tpu_torch.parallel.stokes2d import (
    _flow_bcs_local,
    _freeze_rows,
    eta_tau_fields,
    norm_windows,
    reduced_norms,
)
from justrelax_tpu_torch.parallel.stokes2d_vep import (
    eta_tau_ghosts,
    extend_ghosts,
    local_blocks,
)
from justrelax_tpu_torch.rheology.materials import (
    _as_stack,
    get_bulk_modulus,
    get_shear_modulus,
)
from justrelax_tpu_torch.rheology.viscosity import compute_viscosity_fields
from justrelax_tpu_torch.solvers.stokes2d import _ratio

__all__ = ["solve_variational_sharded", "ShardedVariationalResult2D"]


class ShardedVariationalResult2D(NamedTuple):
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
    err: Any
    iters: Any


_ORDER = (
    "Vx", "Vy", "P", "Q",
    "txx", "tyy", "txy_c", "txy_v",
    "txx_o", "tyy_o", "txy_c_o", "txy_v_o",
    "EII_pl", "eta", "eta_v",
    "phi_c", "phi_v", "vm_c", "vm_v", "vm_vx", "vm_vy",
)
_OPTIONAL = ("T", "pr_c", "pr_v")


def solve_variational_sharded(
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
    """``blocks``: the ``_ORDER`` tiles (or blocked containers) plus
    ``inv_dx``/``inv_dy``; ``phi_c``/``phi_v`` the RockRatio center and
    vertex fractions and ``vm_c``/``vm_v``/``vm_vx``/``vm_vy`` the validity
    masks (``ops/rock_ratio.valid_masks`` of the global ϕ, blocked).
    ``P0 ← P`` at solve entry. Returns a :class:`ShardedVariationalResult2D`
    of this rank's tiles, ``err`` and ``iters``."""
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
    phi_c, phi_v = t["phi_c"], t["phi_v"]
    vm_c, vm_v, vm_vx, vm_vy = (t[k].to(torch.bool) for k in ("vm_c", "vm_v", "vm_vx", "vm_vy"))
    T, pr_c, pr_v = t.get("T"), t.get("pr_c"), t.get("pr_v")
    material = _as_stack(material, P0)

    with mesh:
        fx, lx_ = halo.axis_edges("x")
        fy, ly_ = halo.axis_edges("y")
        K_c = get_bulk_modulus(material, pr_c, like=P0)
        G_c = get_shear_modulus(material, pr_c, like=P0)
        inv = vep_invariants(t["txx_o"], t["tyy_o"], t["txy_c_o"], t["txy_v_o"], t["EII_pl"],
                             material, pr_c, pr_v, extend_many=extend_ghosts)
        mx, my = norm_windows(mesh, decomp, P0.device)

        def masked_strain(Vx, Vy):
            grad_V = (Vx[1:, 1:-1] - Vx[:-1, 1:-1]) * inv_dx + (
                Vy[1:-1, 1:] - Vy[1:-1, :-1]) * inv_dy
            grad_V = torch.where(vm_c, grad_V, 0.0)
            third = 1.0 / 3.0
            exx = (Vx[1:, 1:-1] - Vx[:-1, 1:-1]) * inv_dx - grad_V * third
            eyy = (Vy[1:-1, 1:] - Vy[1:-1, :-1]) * inv_dy - grad_V * third
            exy = 0.5 * ((Vx[:, 1:] - Vx[:, :-1]) * inv_dy + (Vy[1:, :] - Vy[:-1, :]) * inv_dx)
            return (grad_V, torch.where(vm_c, exx, 0.0), torch.where(vm_c, eyy, 0.0),
                    torch.where(vm_v, exy, 0.0))

        def masked_momentum(Pc, txx, tyy, txy_v, rho_gx, rho_gy):
            # ϕ-weight BEFORE the ghost extension, so the neighbour's
            # contributions are the weighted values
            Pw, txxw = Pc * phi_c, txx * phi_c
            tyyw, txyw = tyy * phi_c, txy_v * phi_v
            gxw, gyw = rho_gx * phi_c, rho_gy * phi_c
            Pw_ex, txxw_ex, gxw_ex, Pw_ey, tyyw_ey, gyw_ey = halo.extend_many(
                [(Pw, 0, 1), (txxw, 0, 1), (gxw, 0, 1), (Pw, 1, 1), (tyyw, 1, 1), (gyw, 1, 1)])
            Rx = ((txxw_ex[1:, :] - txxw_ex[:-1, :]) * inv_dx
                  + (txyw[:, 1:] - txyw[:, :-1]) * inv_dy
                  - (Pw_ex[1:, :] - Pw_ex[:-1, :]) * inv_dx
                  - 0.5 * (gxw_ex[1:, :] + gxw_ex[:-1, :]))
            Ry = ((tyyw_ey[:, 1:] - tyyw_ey[:, :-1]) * inv_dy
                  + (txyw[1:, :] - txyw[:-1, :]) * inv_dx
                  - (Pw_ey[:, 1:] - Pw_ey[:, :-1]) * inv_dy
                  - 0.5 * (gyw_ey[:, 1:] + gyw_ey[:, :-1]))
            return torch.where(vm_vx, Rx, 0.0), torch.where(vm_vy, Ry, 0.0)

        def one_iteration(c: dict) -> dict:
            eta_tau, etat_x, etat_y = eta_tau_fields(eta_tau_ghosts(c["eta"]))
            grad_V, exx, eyy, exy = masked_strain(c["Vx"], c["Vy"])
            _Kdt = 1.0 / (K_c * dt)
            rhs = -grad_V + Q / dt
            RP = -(c["theta"] - P0) * _Kdt + rhs
            psi = 1.0 / (1.0 / eta_tau + 1.0 / (G_c * dt)) * (r / theta_dtau)
            theta = ((P0 * _Kdt + rhs) * psi + c["theta"]) / (1.0 + _Kdt * psi)
            theta = torch.where(vm_c, theta, 0.0)
            RP = torch.where(vm_c, RP, 0.0)
            rho_gx, rho_gy = rho_g_fields(material, T, c["P"], pr_c)
            res = _update_stresses(exx, eyy, exy, c["txx"], c["tyy"], c["txy_c"], c["txy_v"],
                                   theta, c["eta"], c["lam"], c["lam_v"], inv,
                                   lambda_relaxation, dt, theta_dtau, extend_ghosts)
            txx = torch.where(vm_c, res.txx, 0.0)
            tyy = torch.where(vm_c, res.tyy, 0.0)
            txy_c = torch.where(vm_c, res.txy_c, 0.0)
            txy_v = torch.where(vm_v, res.txy_v, 0.0)
            P_new = torch.where(vm_c, res.P_corrected, 0.0)
            zv = torch.zeros_like(c["eta_v"])
            eta, eta_v = compute_viscosity_fields(
                c["eta"], c["eta_v"], material, txx, tyy, txy_c, zv, zv, txy_v, pr_c, pr_v,
                mode="tau", relaxation=viscosity_relaxation, cutoff=viscosity_cutoff)
            Rx, Ry = masked_momentum(P_new, txx, tyy, txy_v, rho_gx, rho_gy)
            etax = 0.5 * (etat_x[1:, :] + etat_x[:-1, :])
            etay = 0.5 * (etat_y[:, 1:] + etat_y[:, :-1])
            Vx_new, Vy_new = c["Vx"].clone(), c["Vy"].clone()
            Vx_new[:, 1:-1] += torch.where(vm_vx, Rx * etadtau / etax, 0.0)
            Vy_new[1:-1, :] += torch.where(vm_vy, Ry * etadtau / etay, 0.0)
            # hard-zero the invalid faces (reference compute_V!:195-215)
            Vx_new[:, 1:-1] = torch.where(vm_vx, Vx_new[:, 1:-1], 0.0)
            Vy_new[1:-1, :] = torch.where(vm_vy, Vy_new[1:-1, :], 0.0)
            Vx = _freeze_rows(c["Vx"], Vx_new, 0, fx, lx_)
            Vy = _freeze_rows(c["Vy"], Vy_new, 1, fy, ly_)
            Vx, Vy = _flow_bcs_local(Vx, Vy, flow_bc, fx, lx_, fy, ly_)
            Vx, Vy = halo.post_exchange_ghosts([(Vx, 1, nyl), (Vy, 0, nxl)]).wait()
            return dict(Vx=Vx, Vy=Vy, P=P_new, theta=theta, txx=txx, tyy=tyy, txy_c=txy_c,
                        txy_v=txy_v, eta=eta, eta_v=eta_v, lam=res.lam, lam_v=res.lam_v,
                        tau_II=torch.where(vm_c, res.tau_II, 0.0), RP=RP)

        def residual_norms(c):
            rho_gx, rho_gy = rho_g_fields(material, T, c["P"], pr_c)
            Rx, Ry = masked_momentum(c["P"], c["txx"], c["tyy"], c["txy_v"], rho_gx, rho_gy)
            return reduced_norms(mesh, decomp, Rx, Ry, c["RP"], mx, my)

        zc = torch.zeros_like(P0)
        c = dict(Vx=t["Vx"], Vy=t["Vy"], P=P0, theta=P0, txx=t["txx"], tyy=t["tyy"],
                 txy_c=t["txy_c"], txy_v=t["txy_v"], eta=t["eta"], eta_v=t["eta_v"], lam=zc,
                 lam_v=torch.zeros_like(t["txy_v"]), tau_II=zc, RP=zc)
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
    return ShardedVariationalResult2D(
        **{k: c[k] for k in ShardedVariationalResult2D._fields[:-2]},
        err=err_t, iters=chunk * nout_i)
