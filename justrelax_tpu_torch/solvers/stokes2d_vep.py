"""Multi-phase visco-elasto-plastic APT Stokes solver, 2D (the flagship).

Counterpart of ``justrelax_tpu/solvers/stokes2d_vep.py``. Per PT iteration:
maxloc preconditioner → divergence → compressible pressure iterate θ →
buoyancy → strain rate → fused center+vertex VEP stress update with plastic
return mapping and dilatancy correction → τII-based viscosity relaxation →
damped velocity update + BCs (``ops/stokes_vep.py::vep_iteration``).

The solve runs in chunks of ``nout`` iterations. With ``use_kernel`` (the
default for a state on the card) the chunk's first ``nout − 1`` iterations run in the Hopper chunk kernel
(``ops/hopper_stokes_vep.py``) and its last one on the array path, so every
diagnostic (τII, η_vep, ε_pl, RP) comes from the same code either way. The
residual norms are evaluated after every chunk and read on the host once
per chunk for the convergence test. State evolution per solve: P0 ← P at
entry; τ_o ← τ, EII/EVol accumulation and vorticity at exit.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from justrelax_tpu_torch.core.device import resolve_use_kernel
from justrelax_tpu_torch.ops import stokes as kernels
from justrelax_tpu_torch.ops.hopper_stokes_vep import (
    _resolve_static,
    stokes_vep_chunk,
    vep_chunk_supported,
)
from justrelax_tpu_torch.ops.stencil import av_a, av_vertex_to_center, expand_edges, maxloc
from justrelax_tpu_torch.ops.stokes_vep import (
    VEPCarry,
    linear_viscosity_tables,
    rho_g_fields,
    vep_invariants,
    vep_iteration,
)
from justrelax_tpu_torch.rheology.materials import _as_stack
from justrelax_tpu_torch.rheology.plasticity import second_invariant_staggered
from justrelax_tpu_torch.rheology.viscosity import _is_linear_creep
from justrelax_tpu_torch.solvers.stokes2d import StokesSolveInfo, _norm, _ratio

__all__ = ["solve_vep"]


def _gather4(A):
    """The 4 vertex values around each center."""
    return (A[:-1, :-1], A[1:, :-1], A[:-1, 1:], A[1:, 1:])


def solve_vep(
    stokes,
    pt_stokes,
    geometry,
    flow_bc,
    material,
    phase_ratios_center,
    phase_ratios_vertex,
    dt,
    T=None,
    use_kernel=None,
    **kwargs,
):
    """Public entry. ``use_kernel`` (``True`` or ``"blocked"``, which reach
    the same Hopper kernel) runs the chunks through
    ``ops/hopper_stokes_vep.py::stokes_vep_chunk``; the default ``None``
    does so for a state on the card and runs the plain path for one on the
    CPU; ``False`` asks for the plain path. A configuration the kernel does
    not cover (see ``vep_chunk_supported``) raises ``ValueError`` when the
    kernel is asked for. ``visc_plastic_tau=True`` (the regularized plastic
    element composed into the τII-mode viscosity) runs on the plain path
    only: the kernel carries the base convention, and JAX's kernel route
    mixes the two (its chunk's last iteration alone takes the variant), so
    the kernel asked for with it raises ``ValueError``. So does the kernel
    asked for on a ``NonuniformGeometry``; the plain path takes its spacing
    families (``ops/stokes.py::spacing_families_2d``). A bare ``Material``
    is stacked once, on the state's device and in its dtype. Keyword
    arguments as :func:`_solve_vep`."""
    material = _as_stack(material, stokes.P)
    use_kernel = resolve_use_kernel(use_kernel, stokes.P)
    has_cap, visc_m = False, None
    if use_kernel:
        if kwargs.get("visc_plastic_tau", False):
            raise ValueError(
                "the VEP chunk kernel carries the base viscosity convention, not "
                "visc_plastic_tau; pass use_kernel=False for the plain path")
        if not vep_chunk_supported(
            material, geometry, flow_bc, kwargs.get("free_surface", False)
        ):
            raise ValueError(
                "the VEP chunk kernel needs a linear or shared-exponent "
                "power-law creep table, a solve-invariant density (beta == 0; "
                "rho(T) is fine — T is frozen during a solve), the consistent "
                "dQ/dtau convention, a uniform grid, free-slip/no-slip BCs on "
                "every face and no free-surface term; pass use_kernel=False "
                "for the plain path"
            )
        has_cap, visc_m = _resolve_static(material, None, "auto")
    return _solve_vep(
        stokes, pt_stokes, geometry, flow_bc, material,
        phase_ratios_center, phase_ratios_vertex, dt, T=T,
        use_kernel=bool(use_kernel), kernel_has_cap=has_cap,
        kernel_visc_m=visc_m, **kwargs,
    )


def _solve_vep(
    stokes,
    pt_stokes,
    geometry,
    flow_bc,
    material,
    phase_ratios_center: Optional[torch.Tensor],
    phase_ratios_vertex: Optional[torch.Tensor],
    dt,
    T: Optional[torch.Tensor] = None,
    iter_max: int = 50_000,
    iter_min: int = 100,
    nout: int = 500,
    free_surface: bool = False,
    viscosity_relaxation: float = 1.0e-2,
    lambda_relaxation: float = 0.2,
    viscosity_cutoff: Tuple[float, float] = (-math.inf, math.inf),
    use_kernel: bool = False,
    kernel_has_cap: bool = False,
    kernel_visc_m=None,
    visc_plastic_tau: bool = False,
):
    nx, ny = stokes.P.shape
    inv_dx, inv_dy, strain_v, mom_spacings = kernels.spacing_families_2d(geometry, stokes.P)
    eps_rel, eps_abs = pt_stokes.eps_rel, pt_stokes.eps_abs
    nout_i = int(nout)
    max_chunks = max(1, int(math.ceil(iter_max / nout_i)))
    min_chunks = int(math.ceil(iter_min / nout_i))
    fs_dt = dt if free_surface else None
    dtype, device = stokes.P.dtype, stokes.P.device

    P0 = stokes.P  # P0 ← P at solve entry
    Q = stokes.Q
    txx_o, tyy_o = stokes.tau_o.xx, stokes.tau_o.yy
    txy_c_o, txy_v_o = stokes.tau_o.xy_c, stokes.tau_o.xy
    EII_pl = stokes.EII_pl
    T_vertex = None if T is None else av_vertex_to_center(expand_edges(T))
    inv = vep_invariants(txx_o, tyy_o, txy_c_o, txy_v_o, EII_pl, material,
                         phase_ratios_center, phase_ratios_vertex)
    eta_tables = None
    # the plastic variant depends on τII, so the linear tables do not serve it
    if _is_linear_creep(material) and not visc_plastic_tau:
        eta_tables = linear_viscosity_tables(
            material, phase_ratios_center, phase_ratios_vertex, T, T_vertex,
            stokes.P, stokes.tau.xy)

    def iteration(c):
        return vep_iteration(
            c, inv, P0, Q, material, phase_ratios_center, phase_ratios_vertex,
            T, T_vertex, dt, inv_dx, inv_dy,
            pt_stokes.r, pt_stokes.theta_dtau, pt_stokes.etadtau,
            lambda_relaxation, viscosity_relaxation, viscosity_cutoff,
            flow_bc, free_surface_dt=fs_dt, eta_tables=eta_tables,
            visc_plastic_tau=visc_plastic_tau, strain_v=strain_v, spacings=mom_spacings,
        )

    def residual_norms(c, RP):
        rho_gx, rho_gy = rho_g_fields(material, T, c.P, phase_ratios_center)
        Rx, Ry = kernels.compute_Res(
            c.P, c.txx, c.tyy, c.txy_v, rho_gx, rho_gy, inv_dx, inv_dy,
            Vy=c.Vy, free_surface_dt=fs_dt, spacings=mom_spacings,
        )
        nRx = _norm(Rx[1:-1, 1:-1]) / math.sqrt((nx - 2) * (ny - 1))
        nRy = _norm(Ry[1:-1, 1:-1]) / math.sqrt((nx - 1) * (ny - 2))
        nRP = _norm(RP) / math.sqrt(nx * ny)
        return nRx, nRy, nRP, Rx, Ry

    c = VEPCarry(
        Vx=stokes.V.Vx, Vy=stokes.V.Vy, theta=stokes.P, P=stokes.P,
        txx=stokes.tau.xx, tyy=stokes.tau.yy, txy_c=stokes.tau.xy_c,
        txy_v=stokes.tau.xy, eta=stokes.viscosity.eta,
        eta_v=stokes.viscosity.eta_v, lam=torch.zeros_like(stokes.P),
        lam_v=torch.zeros_like(stokes.tau.xy),
    )
    hist = torch.full((max_chunks, 3), math.nan, dtype=dtype, device=device)
    # err starts at inf, so at least one chunk runs and sets the diagnostics
    err, err1, chunk = math.inf, 1.0, 0
    while chunk < min_chunks or (
        (_ratio(err, err1) > eps_rel and err > eps_abs) and chunk < max_chunks
    ):
        if use_kernel:
            c = VEPCarry(*stokes_vep_chunk(
                *c, P0, Q, txx_o, tyy_o, txy_c_o, txy_v_o, EII_pl, material,
                phase_ratios_center, phase_ratios_vertex, T, dt, inv_dx, inv_dy, pt_stokes.r,
                pt_stokes.theta_dtau, pt_stokes.etadtau, lambda_relaxation,
                viscosity_relaxation, viscosity_cutoff, nout=nout_i - 1,
                has_cap=kernel_has_cap, flow_bc=flow_bc, T_v=T_vertex,
                visc_m=kernel_visc_m,
            ))
        else:
            for _ in range(nout_i - 1):
                c, _, _ = iteration(c)
        # the chunk's last iteration on the array path yields every diagnostic
        c, res, RP = iteration(c)
        tau_II, eta_vep, eps_vol_pl = res.tau_II, res.eta_vep, res.eps_vol_pl
        eps_pl_xx, eps_pl_yy, eps_pl_xy_v = res.eps_pl_xx, res.eps_pl_yy, res.eps_pl_xy_v
        nRx, nRy, nRP, _, _ = residual_norms(c, RP)
        err_t = torch.maximum(torch.maximum(nRx, nRy), nRP)
        # iter_min may ask for more chunks than iter_max: the history keeps
        # the last in its last row, as JAX's clamped dynamic update does
        hist[min(chunk, max_chunks - 1)] = torch.stack([nRx, nRy, nRP])
        err = float(err_t)  # the one host read per chunk
        if chunk == 0:
            err1 = err
        chunk += 1

    # --- post-loop diagnostics & state assembly ----------------------------
    grad_V = kernels.compute_grad_V(c.Vx, c.Vy, inv_dx, inv_dy)
    exx, eyy, exy = kernels.compute_strain_rate(grad_V, c.Vx, c.Vy, inv_dx, inv_dy,
                                                **strain_v)
    _, _, _, Rx, Ry = residual_norms(c, RP)
    omega_xy = kernels.compute_vorticity(c.Vx, c.Vy, *strain_v.values())

    EII_new = EII_pl + second_invariant_staggered(
        eps_pl_xx, eps_pl_yy, _gather4(eps_pl_xy_v)
    ) * dt
    EVol_new = stokes.EVol_pl + dt * eps_vol_pl

    tau = stokes.tau.replace(xx=c.txx, yy=c.tyy, xy=c.txy_v, xy_c=c.txy_c, II=tau_II)
    tau_o = stokes.tau_o.replace(xx=c.txx, yy=c.tyy, xy=c.txy_v, xy_c=c.txy_c)
    eps = stokes.eps.replace(
        xx=exx, yy=eyy, xy=exy, xy_c=av_a(exy),
        II=second_invariant_staggered(exx, eyy, _gather4(exy)),
    )
    eps_pl = stokes.eps_pl.replace(
        xx=eps_pl_xx, yy=eps_pl_yy, xy=eps_pl_xy_v, xy_c=av_a(eps_pl_xy_v)
    )
    new_stokes = stokes.replace(
        P=c.P,
        P0=P0,
        V=stokes.V.replace(Vx=c.Vx, Vy=c.Vy),
        grad_V=grad_V,
        tau=tau,
        tau_o=tau_o,
        eps=eps,
        eps_pl=eps_pl,
        EII_pl=EII_new,
        EVol_pl=EVol_new,
        eps_vol_pl=eps_vol_pl,
        lam=c.lam,
        lam_v=c.lam_v,
        viscosity=stokes.viscosity.replace(
            eta=c.eta, eta_v=c.eta_v, eta_vep=eta_vep, eta_tau=maxloc(c.eta, 1)
        ),
        omega=stokes.omega.replace(xy=omega_xy),
        R=stokes.R.replace(RP=RP, Rx=Rx, Ry=Ry),
    )
    info = StokesSolveInfo(
        iters=chunk * nout_i,
        err=err_t,
        err_history=hist.amax(dim=1),
        norm_Rx=hist[:, 0],
        norm_Ry=hist[:, 1],
        norm_RP=hist[:, 2],
    )
    return new_stokes, info
