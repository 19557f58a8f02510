"""Accelerated pseudo-transient visco-elastic Stokes solver, 3D.

Counterpart of ``justrelax_tpu/solvers/stokes3d.py``. The PT loop runs in
chunks of ``nout`` iterations: divergence → compressible pressure → strain
rate → VE stress (shear components on the cell edges) → damped velocity
update with its residuals → velocity BCs. The residual norms follow the 3D
convention, ‖R‖₂ divided by a count with no square root; the convergence
test reads ``err`` on the host once per chunk. Convergence: run at least one
chunk; stop when ``err/err₁ ≤ ϵ_rel`` or ``err ≤ ϵ_abs``; cap at
``iter_max``.
"""

from __future__ import annotations

import math

import torch

from justrelax_tpu_torch.core.device import resolve_use_kernel
from justrelax_tpu_torch.ops import stokes3d as k3
from justrelax_tpu_torch.ops.bc import flow_bcs
from justrelax_tpu_torch.ops.hopper_stokes3d import (
    pack_coeffs,
    stokes3d_chunk,
    ve3d_chunk_unsupported,
)
from justrelax_tpu_torch.ops.stencil import maxloc
from justrelax_tpu_torch.ops.stokes import compute_P
from justrelax_tpu_torch.ops.stokes3d_canvas import (
    pack_carry,
    unpack_carry,
    ve3d_canvas_coefficients,
)
from justrelax_tpu_torch.solvers.stokes2d import StokesSolveInfo, _norm, _ratio

__all__ = ["solve_ve_3d", "kernel_chunk_inputs"]


def _static_all_inf(x):
    """True iff ``x`` is everywhere ±∞."""
    return bool(torch.isinf(torch.as_tensor(x)).all())


def _tensor6(t):
    return (t.xx, t.yy, t.zz, t.yz, t.xz, t.xy)


def kernel_chunk_inputs(stokes, pt_stokes, geometry, rho_g, G, K, dt):
    """What the kernel path of :func:`solve_ve_3d` hands its first chunk,
    from the state ``stokes``: (carry, packed coefficients, inv_di). The
    coefficients are built once per solve, with ψ from η as the array
    path's ``compute_P`` takes it; the kernel derives from η and ητ those
    it computes bit for bit (on SolVi, dt = ∞, all that vary)."""
    eta = stokes.viscosity.eta
    eta_tau = maxloc(eta, window=1)
    fx, fy, fz = rho_g
    r, theta_dtau, etadtau = pt_stokes.r, pt_stokes.theta_dtau, pt_stokes.etadtau
    co = ve3d_canvas_coefficients(
        eta, eta_tau, r, theta_dtau, etadtau,
        fx=fx, fy=fy, fz=fz, psi_eta=eta, G=G, K=K, P0=stokes.P0, Q=stokes.Q,
        tau_o=_tensor6(stokes.tau_o), dt=dt)
    V = stokes.V
    carry = pack_carry(V.Vx, V.Vy, V.Vz, stokes.P, *_tensor6(stokes.tau))
    packed = pack_coeffs(co, derive_from=(eta, eta_tau, (r / theta_dtau, theta_dtau, etadtau)))
    return carry, packed, k3.spacing_families_3d(geometry, stokes.P)[0]


def solve_ve_3d(
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
    mean_free_RP: bool = False,
    boundary_shear: bool = False,
    alpha_dT=None,
    use_kernel=None,
    pallas_lean=None,
):
    """Visco-elastic (compressible) APT Stokes solve in 3D, one physical time
    step. ``G``/``K`` may be ∞ for the viscous / incompressible limits.

    ``mean_free_RP`` deflates the constant pressure mode: with velocity
    imposed on every boundary, discretely incompatible boundary data (a net
    flux, e.g. the Burstedde solution sampled at cell midpoints) otherwise
    makes P drift and the continuity residual stall. ``boundary_shear``
    updates the boundary edges' shear stresses too (Dirichlet problems).

    ``use_kernel`` (``True`` or ``"blocked"``, which reach the same Hopper
    kernel) runs each chunk in ``ops/hopper_stokes3d.py::stokes3d_chunk``
    from :func:`kernel_chunk_inputs`, and the residuals are taken once
    per chunk from the state the chunk returns, one velocity update later
    than the array path's in-iteration residuals: the same criterion, with
    iteration counts that can differ slightly. The default ``None`` takes
    the kernel for a state on the card and the array path for one on the
    CPU; ``False`` asks for the array path. The kernel needs a uniform grid,
    free slip on all six faces and none of ``mean_free_RP``,
    ``boundary_shear`` and ``alpha_dT``; asked for elsewhere (a
    ``NonuniformGeometry`` included) it raises ``ValueError``. On a
    nonuniform grid the array path takes the spacing families of
    ``ops/stokes3d.py::spacing_families_3d``.

    ``pallas_lean`` chose a TPU lowering of the viscous limit and has no
    effect here; ``True`` with finite or non-constant ``G``, ``K`` or ``dt``
    raises ``ValueError`` as in the JAX package.
    """
    if pallas_lean and not (_static_all_inf(G) and _static_all_inf(K) and _static_all_inf(dt)):
        raise ValueError(
            "pallas_lean=True requires statically infinite G, K and dt "
            "(viscous incompressible limit); got finite/traced moduli. "
            "Use pallas_lean=None for auto-detection.")
    inv_di, inv_di_v, mom_spacings = k3.spacing_families_3d(geometry, stokes.P)
    use_kernel = resolve_use_kernel(use_kernel, stokes.P)
    if use_kernel:
        reason = ve3d_chunk_unsupported(geometry, flow_bc, mean_free_RP, boundary_shear,
                                        alpha_dT)
        if reason is not None:
            raise ValueError(f"the 3D VE chunk kernel {reason}; pass use_kernel=False "
                             "for the plain path")

    nx, ny, nz = stokes.P.shape
    r, theta_dtau, etadtau = pt_stokes.r, pt_stokes.theta_dtau, pt_stokes.etadtau
    eps_rel, eps_abs = pt_stokes.eps_rel, pt_stokes.eps_abs
    nout = int(nout)
    max_chunks = max(1, int(math.ceil(iter_max / nout)))
    dtype, device = stokes.P.dtype, stokes.P.device

    eta = stokes.viscosity.eta
    eta_tau = maxloc(eta, window=1)
    P0, Q = stokes.P0, stokes.Q
    tau_o = _tensor6(stokes.tau_o)
    fx, fy, fz = rho_g

    def iteration(V, P, tau):
        grad_V = k3.compute_grad_V_3d(*V, inv_di)
        if mean_free_RP:
            grad_V = grad_V - grad_V.mean()
        RP, P = compute_P(P, P0, grad_V, Q, eta, K, G, dt, r, theta_dtau, alpha_dT=alpha_dT)
        eps = k3.compute_strain_rate_3d(grad_V, *V, inv_di, inv_di_v)
        tau = k3.compute_tau_ve_3d(tau, tau_o, eps, eta, G, theta_dtau, dt,
                                   boundary_shear=boundary_shear)
        *V, Rx, Ry, Rz = k3.compute_V_3d(*V, P, tau, fx, fy, fz, eta_tau, etadtau, inv_di,
                                         spacings=mom_spacings)
        return flow_bcs(V, flow_bc), P, tau, RP, (Rx, Ry, Rz)

    V = (stokes.V.Vx, stokes.V.Vy, stokes.V.Vz)
    P = stokes.P
    tau = _tensor6(stokes.tau)
    RP, R = stokes.R.RP, (stokes.R.Rx, stokes.R.Ry, stokes.R.Rz)
    if use_kernel:
        carry, co, _ = kernel_chunk_inputs(stokes, pt_stokes, geometry, rho_g, G, K, dt)

    hist = torch.full((max_chunks, 4), math.nan, dtype=dtype, device=device)
    # err starts at inf, so at least one chunk runs
    err, err1, chunk = math.inf, 1.0, 0
    while chunk < 1 or ((_ratio(err, err1) > eps_rel and err > eps_abs) and chunk < max_chunks):
        if use_kernel:
            carry = stokes3d_chunk(carry, co, inv_di, nout)
            Vx, Vy, Vz, P, *tau = unpack_carry(carry, nx, ny, nz)
            V, tau = (Vx, Vy, Vz), tuple(tau)
            # residuals of the state the chunk returns (post-update)
            RP, _ = compute_P(P, P0, k3.compute_grad_V_3d(*V, inv_di), Q, eta, K, G, dt, r,
                              theta_dtau)
            R = k3.momentum_residuals_3d(P, tau, fx, fy, fz, inv_di)
        else:
            for _ in range(nout):
                V, P, tau, RP, R = iteration(V, P, tau)
        Rx, Ry, Rz = R
        norms = torch.stack([
            _norm(Rx[1:-1, 1:-1, 1:-1]) / ((nx - 2) * (ny - 1) * (nz - 1)),
            _norm(Ry[1:-1, 1:-1, 1:-1]) / ((nx - 1) * (ny - 2) * (nz - 1)),
            _norm(Rz[1:-1, 1:-1, 1:-1]) / ((nx - 1) * (ny - 1) * (nz - 2)),
            _norm(RP) / (nx * ny * nz),
        ])
        err_t = norms.amax()
        hist[chunk] = norms
        err = float(err_t)  # the one host read per chunk
        if chunk == 0:
            err1 = err
        chunk += 1

    # the final state: only the fields the JAX solver sets
    V, tau = tuple(t.contiguous() for t in V), tuple(t.contiguous() for t in tau)
    txx, tyy, tzz, tyz, txz, txy = tau
    new_stokes = stokes.replace(
        P=P.contiguous(),
        V=stokes.V.replace(Vx=V[0], Vy=V[1], Vz=V[2]),
        tau=stokes.tau.replace(
            xx=txx, yy=tyy, zz=tzz, yz=tyz, xz=txz, xy=txy,
            II=k3.tensor_invariant_staggered_3d(txx, tyy, tzz, tyz, txz, txy)),
        tau_o=stokes.tau_o.replace(xx=txx, yy=tyy, zz=tzz, yz=tyz, xz=txz, xy=txy),
        R=stokes.R.replace(RP=RP, Rx=R[0], Ry=R[1], Rz=R[2]),
        viscosity=stokes.viscosity.replace(eta_tau=eta_tau),
    )
    info = StokesSolveInfo(
        iters=chunk * nout,
        err=err_t,
        err_history=hist.amax(dim=1),
        norm_Rx=hist[:, 0],
        norm_Ry=hist[:, 1],
        norm_RP=hist[:, 3],
    )
    return new_stokes, info
