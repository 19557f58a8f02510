"""Accelerated pseudo-transient Stokes solvers, 2D: the linear viscous /
visco-elastic solve ``solve_ve`` and the pieces the solvers share.

Counterpart of ``justrelax_tpu/solvers/stokes2d.py``. The PT loop runs in
chunks of ``nout`` iterations (divergence → pressure → strain rate → stress →
damped velocity + BCs, ``ops/stokes.py::ve_iteration``), then evaluates the
residual norms; the convergence test reads ``err`` on the host once per
chunk. Convergence: run at least one chunk; stop when ``err/err₁ ≤ ϵ_rel``
or ``err ≤ ϵ_abs``; cap at ``iter_max``.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from justrelax_tpu_torch.core.device import resolve_use_kernel
from justrelax_tpu_torch.ops import stokes as kernels
from justrelax_tpu_torch.ops.hopper_stokes import stokes_chunk, ve_chunk_unsupported
from justrelax_tpu_torch.ops.stencil import av_vertex_to_center, maxloc

__all__ = ["solve_ve", "StokesSolveInfo"]


class StokesSolveInfo(NamedTuple):
    iters: Any
    err: Any
    err_history: Any  # (max_chunks,) max-norm history, nan-padded
    norm_Rx: Any
    norm_Ry: Any
    norm_RP: Any


def _norm(x):
    return torch.linalg.vector_norm(x.reshape(-1))


def _ratio(err, err1):
    """err/err₁ in IEEE arithmetic, as the JAX loop takes it: 0/0 is nan
    (a state that is already exact stops after one chunk), x/0 is ±∞."""
    if err1 == 0.0:
        return math.nan if err == 0.0 or math.isnan(err) else math.copysign(math.inf, err)
    return err / err1


def solve_ve(
    stokes,
    pt_stokes,
    geometry,
    flow_bc,
    rho_g,
    G,
    K,
    dt,
    iter_max: int = 10_000,
    nout: int = 500,
    free_surface: bool = False,
    halo_exchange=None,
    reduce_norm=None,
    alpha_dT=None,
    use_kernel=None,
):
    """Visco-elastic (compressible) APT Stokes solve, one physical time step.

    Pressure relaxed with the maxloc preconditioner ``ητ``, stress updated
    with the VE PT increment, velocity damped by ``ηdτ/ητ̄``. ``G``/``K`` may
    be ∞ for the viscous / incompressible limits (SolCx et al.).
    ``alpha_dT = α·ΔT`` (cell-centered) adds the thermal-stress pressure
    source.

    ``use_kernel`` (``True`` or ``"blocked"``, which reach the same Hopper
    kernel) runs every iteration of each chunk in
    ``ops/hopper_stokes.py::stokes_chunk``; the default ``None`` does so for
    a state on the card and runs the array path for one on the CPU;
    ``False`` asks for the array path. The kernel needs all-free-slip BCs,
    a uniform serial grid, no free surface and no ``alpha_dT``; asked for
    elsewhere (a ``NonuniformGeometry`` included) it raises ``ValueError``.
    On a nonuniform grid the array path takes the spacing families of
    ``ops/stokes.py::spacing_families_2d``. The distributed arguments
    (``halo_exchange``, ``reduce_norm``) are not ported and raise
    ``NotImplementedError``.
    """
    if halo_exchange is not None or reduce_norm is not None:
        raise NotImplementedError(
            "halo_exchange/reduce_norm belong to the distributed layer, which "
            "the PyTorch port does not have yet")
    use_kernel = resolve_use_kernel(use_kernel, stokes.P)
    if use_kernel:
        reason = ve_chunk_unsupported(geometry, flow_bc, free_surface, halo_exchange,
                                      alpha_dT)
        if reason is not None:
            raise ValueError(f"the VE chunk kernel {reason}; pass use_kernel=False "
                             "for the plain path")

    nx, ny = stokes.P.shape
    inv_dx, inv_dy, strain_v, mom_spacings = kernels.spacing_families_2d(geometry, stokes.P)
    r, theta_dtau, etadtau = pt_stokes.r, pt_stokes.theta_dtau, pt_stokes.etadtau
    eps_rel, eps_abs = pt_stokes.eps_rel, pt_stokes.eps_abs
    nout = int(nout)
    max_chunks = max(1, int(math.ceil(iter_max / nout)))
    fs_dt = dt if free_surface else None
    dtype, device = stokes.P.dtype, stokes.P.device

    eta = stokes.viscosity.eta
    eta_tau = maxloc(eta, window=1)
    P0, Q = stokes.P0, stokes.Q
    tau_o = (stokes.tau_o.xx, stokes.tau_o.yy, stokes.tau_o.xy)
    rho_gx, rho_gy = rho_g
    fields = (eta, eta_tau, rho_gx, rho_gy)

    def residual_norms(Vx, Vy, P, txx, tyy, txy):
        grad_V = kernels.compute_grad_V(Vx, Vy, inv_dx, inv_dy)
        RP, _ = kernels.compute_P(P, P0, grad_V, Q, eta_tau, K, G, dt, r, theta_dtau,
                                  alpha_dT=alpha_dT)
        Rx, Ry = kernels.compute_Res(P, txx, tyy, txy, rho_gx, rho_gy, inv_dx, inv_dy,
                                     Vy=Vy, free_surface_dt=fs_dt, spacings=mom_spacings)
        nRx = _norm(Rx[1:-1, 1:-1]) / math.sqrt((nx - 2) * (ny - 1))
        nRy = _norm(Ry[1:-1, 1:-1]) / math.sqrt((nx - 1) * (ny - 2))
        nRP = _norm(RP) / math.sqrt(nx * ny)
        return nRx, nRy, nRP, RP, Rx, Ry

    c = (stokes.V.Vx, stokes.V.Vy, stokes.P, stokes.tau.xx, stokes.tau.yy, stokes.tau.xy)
    hist = torch.full((max_chunks, 3), math.nan, dtype=dtype, device=device)
    # err starts at inf, so at least one chunk runs
    err, err1, chunk = math.inf, 1.0, 0
    while chunk < 1 or ((_ratio(err, err1) > eps_rel and err > eps_abs) and chunk < max_chunks):
        if use_kernel:
            c = stokes_chunk(*c, *fields, inv_dx, inv_dy, r, theta_dtau, etadtau,
                             nout=nout, G=G, K=K, P0=P0, Q=Q, tau_o=tau_o, dt=dt)
        else:
            for _ in range(nout):
                c = kernels.ve_iteration(
                    *c, *fields, G, K, P0, Q, tau_o, dt, inv_dx, inv_dy, r,
                    theta_dtau, etadtau, flow_bc=flow_bc, free_surface_dt=fs_dt,
                    alpha_dT=alpha_dT, strain_v=strain_v, spacings=mom_spacings)
        nRx, nRy, nRP, _, _, _ = residual_norms(*c)
        err_t = torch.maximum(torch.maximum(nRx, nRy), nRP)
        hist[chunk] = torch.stack([nRx, nRy, nRP])
        err = float(err_t)  # the one host read per chunk
        if chunk == 0:
            err1 = err
        chunk += 1

    # final diagnostics + state assembly
    Vx, Vy, P, txx, tyy, txy = c
    grad_V = kernels.compute_grad_V(Vx, Vy, inv_dx, inv_dy)
    exx, eyy, exy = kernels.compute_strain_rate(grad_V, Vx, Vy, inv_dx, inv_dy, **strain_v)
    _, _, _, RP, Rx, Ry = residual_norms(*c)
    txy_c = av_vertex_to_center(txy)
    exy_c = av_vertex_to_center(exy)
    tau = stokes.tau.replace(xx=txx, yy=tyy, xy=txy, xy_c=txy_c,
                             II=kernels.tensor_invariant_2d(txx, tyy, txy_c))
    tau_o = stokes.tau_o.replace(xx=txx, yy=tyy, xy=txy, xy_c=txy_c)
    eps = stokes.eps.replace(xx=exx, yy=eyy, xy=exy, xy_c=exy_c,
                             II=kernels.tensor_invariant_2d(exx, eyy, exy_c))
    omega = stokes.omega.replace(xy=kernels.compute_vorticity(Vx, Vy, *strain_v.values()))
    new_stokes = stokes.replace(
        P=P,
        V=stokes.V.replace(Vx=Vx, Vy=Vy),
        grad_V=grad_V,
        tau=tau,
        tau_o=tau_o,
        eps=eps,
        omega=omega,
        viscosity=stokes.viscosity.replace(eta_tau=eta_tau),
        R=stokes.R.replace(RP=RP, Rx=Rx, Ry=Ry),
    )
    info = StokesSolveInfo(
        iters=chunk * nout,
        err=err_t,
        err_history=hist.amax(dim=1),
        norm_Rx=hist[:, 0],
        norm_Ry=hist[:, 1],
        norm_RP=hist[:, 2],
    )
    return new_stokes, info
