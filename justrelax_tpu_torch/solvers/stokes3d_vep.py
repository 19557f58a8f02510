"""Multi-phase visco-elasto-plastic APT Stokes solver, 3D.

Counterpart of ``justrelax_tpu/solvers/stokes3d_vep.py``. Per PT iteration:
divergence → compressible pressure iterate θ → strain rate → fused center +
edge VEP stress update (plastic return mapping at the centers and on the
three shear-edge families, dilatancy pressure correction) → τII-based
viscosity relaxation → damped velocity update + BCs.

The solve runs in chunks of ``nout`` iterations, one host read of ``err``
per chunk. On the canvas routes (``use_kernel`` ``"edges"``, the default on
the card, ``"edges_split"``, ``"blocked"`` and ``"canvas"``) a chunk's first
``nout − 1`` iterations run on the collocated canvases
(``ops/stokes3d_vep_canvas.py``): the hybrid iteration, whose edge passes
run in the edge kernel (``ops/hopper_vep3d_edges.py``: B6, or B9 on the
hoisted old-stress interpolants), the fused chunk kernel (``ops/hopper_stokes3d_vep.py``, B8), or
the plain canvas chunk. Its last iteration runs on the staggered arrays, so
every diagnostic (τII, η_vep, ε_pl, RP) comes from the same code on every
route. State
evolution per solve: P0 ← P at entry; τ_o ← τ, EII/EVol accumulation at
exit.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from justrelax_tpu_torch.core.device import resolve_use_kernel
from justrelax_tpu_torch.ops import stokes3d as k3
from justrelax_tpu_torch.ops.bc import Faces, flow_bcs
from justrelax_tpu_torch.ops.hopper_stokes3d_vep import pack_chunk_consts, stokes3d_vep_chunk
from justrelax_tpu_torch.ops.hopper_vep3d_edges import (
    pack_edge_consts,
    vep3d_blocked_supported,
    vep3d_edges,
)
from justrelax_tpu_torch.ops.stencil import maxloc
from justrelax_tpu_torch.ops.stokes import compute_P
from justrelax_tpu_torch.ops.stokes3d_vep import (
    _edge_to_center,
    _inv_II,
    make_vep_params_3d,
    update_stresses_center_edges_3d,
)
from justrelax_tpu_torch.ops.stokes3d_vep_canvas import (
    pack_vep_carry,
    unpack_vep_carry,
    vep3d_canvas_consts,
    vep3d_chunk_canvas,
)
from justrelax_tpu_torch.rheology.materials import (
    _as_stack,
    compute_density,
    get_bulk_modulus,
    get_shear_modulus,
    phase_average,
)
from justrelax_tpu_torch.rheology.viscosity import (
    continuation_linear,
    phase_viscosity,
    shared_powerlaw_exponent,
)
from justrelax_tpu_torch.ops.rock_ratio import valid_masks_3d
from justrelax_tpu_torch.solvers.stokes2d import StokesSolveInfo, _ratio
from justrelax_tpu_torch.solvers.stokes3d_variational import (
    masked_momentum_3d,
    masked_velocity_update_3d,
    variational_norms_3d,
)

__all__ = ["solve_vep_3d", "canvas_chunk_inputs"]

ROUTES = (False, True, "edges", "edges_split", "canvas", "blocked")
KERNEL_ROUTES = ("edges", "edges_split", "blocked")


def edges_unsupported(material):
    """Why the kernel routes (the edge kernel and the fused chunk) do not
    take ``material`` (a stack), or ``None``: they need phase-uniform
    plasticity with softening off (``vep3d_blocked_supported``) and a
    phase-uniform bulk modulus Kb."""
    if not vep3d_blocked_supported(material):
        return "needs phase-uniform plasticity with strain softening off"
    Kb = material.params.Kb
    if not bool((Kb == Kb[0]).all()):
        return "needs a phase-uniform bulk modulus Kb"
    return None


def _route_unsupported(geometry, flow_bc, phi):
    """JAX's guards of the canvas routes."""
    if hasattr(geometry, "di_center"):
        return "requires a uniform grid"
    if phi is not None:
        return "does not support variational phi"
    fs = flow_bc.free_slip
    if not all(Faces.on(v) for v in (fs.left, fs.right, fs.top, fs.bot, fs.front, fs.back)) \
            or flow_bc.no_slip.any():
        return "supports all-free-slip BCs only"
    return None


def _visc_exponent(material):
    """The canvas routes' viscosity target: ``None`` for a linear creep
    table, else the shared power-law exponent minus one."""
    p = material.params
    linear = not any(bool((getattr(p, a) > 0).any())
                     for a in ("disl_A", "diff_A", "peierls_A", "gbs_A"))
    visc_m = None if linear else shared_powerlaw_exponent(material)
    if visc_m is None and not linear:
        raise ValueError("the canvas routes require a linear or shared-exponent power-law "
                         "creep table (shared_powerlaw_exponent)")
    return visc_m


def canvas_chunk_inputs(stokes, material, phase_ratios_center, phase_ratios_edges, T=None,
                        route="edges", visc_m="auto"):
    """What the ``route`` of :func:`solve_vep_3d` hands its first chunk,
    from the state at solve entry: (carry, consts, kernel consts). The
    consts are built once per solve: scalar plastic parameters and K on the
    kernel routes, the τ_o edge interpolants hoisted on ``"edges_split"``
    and ``"canvas"`` (B6 and B8 re-derive them); the kernel consts are
    ``pack_edge_consts`` on the edge routes, ``pack_chunk_consts`` on
    ``"blocked"`` and ``None`` on ``"canvas"``."""
    material = _as_stack(material, stokes.P)
    if visc_m == "auto":
        visc_m = _visc_exponent(material)
    to = stokes.tau_o
    scalar = route in KERNEL_ROUTES
    co = vep3d_canvas_consts(
        material, (to.xx, to.yy, to.zz, to.yz_c, to.xz_c, to.xy_c), (to.yz, to.xz, to.xy),
        stokes.EII_pl, stokes.P, stokes.Q, phase_ratios_center, phase_ratios_edges, T=T,
        visc_m=visc_m, hoist_tau_o=route in ("edges_split", "canvas"),
        scalar_plastic=scalar, scalar_K=scalar)
    tau, z = stokes.tau, torch.zeros_like
    carry = pack_vep_carry(
        (stokes.V.Vx, stokes.V.Vy, stokes.V.Vz), stokes.P, stokes.P,
        (tau.xx, tau.yy, tau.zz, tau.yz_c, tau.xz_c, tau.xy_c), (tau.yz, tau.xz, tau.xy),
        stokes.viscosity.eta, z(stokes.P), (z(tau.yz), z(tau.xz), z(tau.xy)))
    if route == "blocked":
        packed = pack_chunk_consts(co)
    elif scalar:
        packed = pack_edge_consts(co, split=route == "edges_split")
    else:
        packed = None
    return carry, co, packed


def solve_vep_3d(
    stokes,
    pt_stokes,
    geometry,
    flow_bc,
    material,
    phase_ratios_center: Optional[torch.Tensor],
    phase_ratios_edges,   # (yz, xz, xy) ratios or (None, None, None)
    dt,
    T: Optional[torch.Tensor] = None,
    iter_max: int = 50_000,
    iter_min: int = 100,
    nout: int = 500,
    viscosity_relaxation: float = 1.0e-2,
    lambda_relaxation: float = 0.2,
    viscosity_cutoff: Tuple[float, float] = (-math.inf, math.inf),
    phi=None,
    use_kernel=None,
    pallas_visc_m="auto",
):
    """One 3D VEP Stokes solve (one physical time step); returns
    ``(stokes, info)``.

    ``use_kernel`` picks the route:

    - ``None`` (the default): ``True`` for a state on the card, ``False`` for
      one on the CPU.
    - ``False``: the staggered serial iteration.
    - ``True`` or ``"edges"``: the hybrid canvas iteration with the three
      edge passes in one launch of ``csrc/stokes3d_vep.cu`` per iteration
      (B6). It needs phase-uniform plasticity with softening off and a
      phase-uniform Kb (``edges_unsupported``); elsewhere ``True`` raises
      ``ValueError`` naming ``use_kernel=False`` and ``"canvas"`` (the JAX
      package falls back to ``"canvas"`` there).
    - ``"edges_split"``: the same with the edge families' old-stress
      interpolants hoisted into the consts (B9), also one launch per
      iteration.
    - ``"blocked"``: the fully fused chunk kernel (B8), three launches of
      ``csrc/stokes3d_vep.cu`` per iteration; the material guard is the edge
      kernel's.
    - ``"canvas"``: the plain canvas chunk.

    On CPU tensors the kernel routes run the kernels' plain versions. The
    canvas routes need a uniform grid, no ``phi`` and free slip on all six
    faces (``ValueError`` otherwise), and a linear or shared-exponent
    power-law creep table; ``pallas_visc_m`` is that exponent minus one
    (``"auto"`` resolves it). A bare ``Material`` is stacked once, on the
    state's device and in its dtype. ``phi`` (a
    :class:`~justrelax_tpu_torch.ops.rock_ratio.RockRatio3D`) makes the solve
    the masked variational VEP solve of ``solvers/stokes3d_variational.py``'s
    masking with the fused plastic return mapping; it runs on the serial
    route only (``use_kernel=False``), as the JAX package's ``use_pallas``
    refuses it; so does a ``NonuniformGeometry``, whose spacing families
    (``ops/stokes3d.py::spacing_families_3d``) the serial route takes.
    """
    material = _as_stack(material, stokes.P)
    route = resolve_use_kernel(use_kernel, stokes.P, allowed=ROUTES)
    if route is True:
        route = "edges"
    if route in KERNEL_ROUTES:
        reason = edges_unsupported(material)
        if reason is not None:
            raise ValueError(
                f"use_kernel={route!r} {reason} (vep3d_blocked_supported); pass "
                "use_kernel=False for the serial path or use_kernel='canvas' for the "
                "plain canvas chunk")
    if route:
        reason = _route_unsupported(geometry, flow_bc, phi)
        if reason is not None:
            raise ValueError(f"use_kernel={route!r} {reason}; pass use_kernel=False")
        if pallas_visc_m == "auto":
            pallas_visc_m = _visc_exponent(material)
    return _solve_vep_3d(
        stokes, pt_stokes, geometry, flow_bc, material, phase_ratios_center,
        phase_ratios_edges, dt, T=T, iter_max=iter_max, iter_min=iter_min, nout=nout,
        viscosity_relaxation=viscosity_relaxation, lambda_relaxation=lambda_relaxation,
        viscosity_cutoff=viscosity_cutoff, route=route,
        visc_m=None if pallas_visc_m == "auto" else pallas_visc_m, phi=phi)


class _Carry(NamedTuple):
    V: tuple
    P: torch.Tensor
    theta: torch.Tensor
    tau_c: tuple
    tau_e: tuple
    eta: torch.Tensor
    lam: torch.Tensor
    lam_e: tuple


def _solve_vep_3d(stokes, pt_stokes, geometry, flow_bc, material, phase_ratios_center,
                  phase_ratios_edges, dt, T, iter_max, iter_min, nout, viscosity_relaxation,
                  lambda_relaxation, viscosity_cutoff, route, visc_m, phi=None):
    nx, ny, nz = stokes.P.shape
    inv_di, inv_di_v, mom_spacings = k3.spacing_families_3d(geometry, stokes.P)
    r, theta_dtau, etadtau = pt_stokes.r, pt_stokes.theta_dtau, pt_stokes.etadtau
    eps_rel, eps_abs = pt_stokes.eps_rel, pt_stokes.eps_abs
    nout_i = int(nout)
    max_chunks = max(1, int(math.ceil(iter_max / nout_i)))
    min_chunks = int(math.ceil(iter_min / nout_i))
    dtype, device = stokes.P.dtype, stokes.P.device
    pr_c = phase_ratios_center

    P0 = stokes.P  # P0 ← P at solve entry
    Q = stokes.Q
    to = stokes.tau_o
    tau_o_c6 = (to.xx, to.yy, to.zz, to.yz_c, to.xz_c, to.xy_c)
    tau_o_e3 = (to.yz, to.xz, to.xy)
    EII_pl = stokes.EII_pl
    K_c = get_bulk_modulus(material, pr_c, like=P0)
    G_c = get_shear_modulus(material, pr_c, like=P0)
    # the solve-invariants of the fused update (phase blends, τ_o edge
    # interpolants), evaluated once
    vep_params = make_vep_params_3d(material, EII_pl, pr_c, phase_ratios_edges,
                                    tau_o_c6, tau_o_e3)
    gravity = phase_average(material.params.gravity, pr_c)

    def rho_g_fields(P):
        rho = compute_density(material, T=T, P=P, phase_ratios=pr_c)
        z = torch.zeros_like(rho)
        return z, z, rho * gravity.expand(rho.shape)

    def refresh_viscosity(eta_old, tau_c6):
        eps0 = (sum(t.abs() for t in tau_c6) == 0).to(dtype) * torch.finfo(dtype).eps
        tII = _inv_II((tau_c6[0] + eps0,) + tuple(tau_c6[1:]))
        eta_n = phase_viscosity(material, tII, T, pr_c, "tau")
        eta_n = continuation_linear(eta_n, eta_old, viscosity_relaxation)
        return torch.clamp(eta_n, viscosity_cutoff[0], viscosity_cutoff[1])

    # the masked solve: air carries no equations (phi, the variational mask)
    vm = None if phi is None else valid_masks_3d(phi)

    def mask(A, m):
        return A if vm is None else torch.where(m, A, 0.0)

    def mask_tau(tau_c, tau_e):
        if vm is None:
            return tau_c, tau_e
        return (tuple(torch.where(vm.c, x, 0.0) for x in tau_c),
                tuple(torch.where(m, x, 0.0) for m, x in zip((vm.yz, vm.xz, vm.xy), tau_e)))

    def momentum(P, tau6, fz):
        # fx and fy are zero: the masked residuals leave their terms out
        return masked_momentum_3d(P, tau6, (None, None, fz * phi.center), inv_di, phi, vm,
                                  mom_spacings)

    def one_iteration(c: _Carry):
        Vx, Vy, Vz = c.V
        eta_tau = maxloc(c.eta, window=1)
        grad_V = k3.compute_grad_V_3d(Vx, Vy, Vz, inv_di)
        RP, theta = compute_P(c.theta, P0, grad_V, Q, eta_tau, K_c, G_c, dt, r, theta_dtau)
        fx, fy, fz = rho_g_fields(c.P)
        exx, eyy, ezz, eyz, exz, exy = k3.compute_strain_rate_3d(grad_V, Vx, Vy, Vz, inv_di,
                                                                 inv_di_v)
        if vm is not None:
            exx, eyy, ezz = mask(exx, vm.c), mask(eyy, vm.c), mask(ezz, vm.c)
            eyz, exz, exy = mask(eyz, vm.yz), mask(exz, vm.xz), mask(exy, vm.xy)
            theta, RP = mask(theta, vm.c), mask(RP, vm.c)
        res = update_stresses_center_edges_3d(
            (exx, eyy, ezz), (eyz, exz, exy), c.tau_c, c.tau_e, tau_o_c6, tau_o_e3,
            theta, c.eta, c.lam, c.lam_e, EII_pl, material, pr_c, phase_ratios_edges,
            lambda_relaxation, dt, theta_dtau, params=vep_params)
        eta = refresh_viscosity(c.eta, res.tau_c)
        tau_c, tau_e = mask_tau(res.tau_c, res.tau_e)
        P_corr = res.P_corrected if vm is None else mask(res.P_corrected, vm.c)
        tau6 = tuple(tau_c[:3]) + tuple(tau_e)
        if vm is None:
            Vx, Vy, Vz, _, _, _ = k3.compute_V_3d(Vx, Vy, Vz, P_corr, tau6, fx, fy, fz,
                                                  eta_tau, etadtau, inv_di,
                                                  spacings=mom_spacings)
            V = flow_bcs((Vx, Vy, Vz), flow_bc)
        else:
            V = tuple(v.clone() for v in c.V)
            masked_velocity_update_3d(V, momentum(P_corr, tau6, fz), eta_tau, etadtau, vm,
                                      flow_bc)
        core = _Carry(V=tuple(V), P=P_corr, theta=theta, tau_c=tau_c, tau_e=tau_e, eta=eta,
                      lam=res.lam, lam_e=res.lam_e)
        return core, res, RP

    def residual_norms(c: _Carry, RP):
        fx, fy, fz = rho_g_fields(c.P)
        tau6 = tuple(c.tau_c[:3]) + tuple(c.tau_e)
        if vm is None:
            R = k3.momentum_residuals_3d(c.P, tau6, fx, fy, fz, inv_di, mom_spacings)
        else:
            R = momentum(c.P, tau6, fz)
        return variational_norms_3d(R, RP), R

    if route:
        _, co_canvas, packed = canvas_chunk_inputs(
            stokes, material, pr_c, phase_ratios_edges, T=T, route=route, visc_m=visc_m)
        chunk_kw = dict(dt=dt, r=r, theta_dtau=theta_dtau, etadtau=etadtau,
                        lambda_relaxation=lambda_relaxation,
                        viscosity_relaxation=viscosity_relaxation,
                        viscosity_cutoff=viscosity_cutoff)
        if route in ("edges", "edges_split"):
            chunk_kw["edges_fn"] = functools.partial(vep3d_edges, co=packed,
                                                     split=route == "edges_split")

    tau = stokes.tau
    c = _Carry(
        V=(stokes.V.Vx, stokes.V.Vy, stokes.V.Vz), P=stokes.P, theta=stokes.P,
        tau_c=(tau.xx, tau.yy, tau.zz, tau.yz_c, tau.xz_c, tau.xy_c),
        tau_e=(tau.yz, tau.xz, tau.xy), eta=stokes.viscosity.eta,
        lam=torch.zeros_like(stokes.P),
        lam_e=tuple(torch.zeros_like(t) for t in (tau.yz, tau.xz, tau.xy)),
    )
    hist = torch.full((max_chunks, 4), math.nan, dtype=dtype, device=device)
    # err starts at inf, so at least one chunk runs and sets the diagnostics
    err, err1, chunk = math.inf, 1.0, 0
    while chunk < min_chunks or (
            (_ratio(err, err1) > eps_rel and err > eps_abs) and chunk < max_chunks):
        if route == "blocked":
            out = stokes3d_vep_chunk(pack_vep_carry(*c), packed, inv_di, nout_i - 1,
                                     **chunk_kw)
            c = _Carry(*unpack_vep_carry(out))
        elif route:
            out = vep3d_chunk_canvas(pack_vep_carry(*c), co_canvas, material, inv_di,
                                     nout_i - 1, **chunk_kw)
            c = _Carry(*unpack_vep_carry(out))
        else:
            for _ in range(nout_i - 1):
                c, _, _ = one_iteration(c)
        # the chunk's last iteration on the staggered arrays yields every
        # diagnostic
        c, res, RP = one_iteration(c)
        norms, _ = residual_norms(c, RP)
        err_t = norms.amax()
        # iter_min may ask for more chunks than iter_max: the history keeps
        # the last in its last row, as JAX's clamped dynamic update does
        hist[min(chunk, max_chunks - 1)] = norms
        err = float(err_t)  # the one host read per chunk
        if chunk == 0:
            err1 = err
        chunk += 1

    # --- post-loop diagnostics & state assembly ----------------------------
    Vx, Vy, Vz = c.V
    grad_V = k3.compute_grad_V_3d(Vx, Vy, Vz, inv_di)
    exx, eyy, ezz, eyz, exz, exy = k3.compute_strain_rate_3d(grad_V, Vx, Vy, Vz, inv_di,
                                                             inv_di_v)
    _, (Rx, Ry, Rz) = residual_norms(c, RP)

    eyz_c = _edge_to_center(eyz, 1, 2)
    exz_c = _edge_to_center(exz, 0, 2)
    exy_c = _edge_to_center(exy, 0, 1)
    pl_e = res.eps_pl_e
    pl_yz_c = _edge_to_center(pl_e[0], 1, 2)
    pl_xz_c = _edge_to_center(pl_e[1], 0, 2)
    pl_xy_c = _edge_to_center(pl_e[2], 0, 1)
    pl_c = res.eps_pl_c
    EII_new = EII_pl + _inv_II((pl_c[0], pl_c[1], pl_c[2], pl_yz_c, pl_xz_c, pl_xy_c)) * dt
    EVol_new = stokes.EVol_pl + dt * res.eps_vol_pl

    txx, tyy, tzz, tyz_c, txz_c, txy_c = c.tau_c
    tyz, txz, txy = c.tau_e
    shear = dict(xx=txx, yy=tyy, zz=tzz, yz=tyz, xz=txz, xy=txy,
                 yz_c=tyz_c, xz_c=txz_c, xy_c=txy_c)
    new_stokes = stokes.replace(
        P=c.P, P0=P0,
        V=stokes.V.replace(Vx=Vx, Vy=Vy, Vz=Vz),
        tau=stokes.tau.replace(**shear, II=res.tau_II),
        tau_o=stokes.tau_o.replace(**shear),
        eps=stokes.eps.replace(
            xx=exx, yy=eyy, zz=ezz, yz=eyz, xz=exz, xy=exy,
            yz_c=eyz_c, xz_c=exz_c, xy_c=exy_c,
            II=_inv_II((exx, eyy, ezz, eyz_c, exz_c, exy_c))),
        eps_pl=stokes.eps_pl.replace(
            xx=pl_c[0], yy=pl_c[1], zz=pl_c[2], yz=pl_e[0], xz=pl_e[1], xy=pl_e[2],
            yz_c=pl_yz_c, xz_c=pl_xz_c, xy_c=pl_xy_c),
        EII_pl=EII_new, EVol_pl=EVol_new, eps_vol_pl=res.eps_vol_pl,
        lam=c.lam,
        viscosity=stokes.viscosity.replace(eta=c.eta, eta_vep=res.eta_vep,
                                           eta_tau=maxloc(c.eta, 1)),
        R=stokes.R.replace(RP=RP, Rx=Rx, Ry=Ry, Rz=Rz),
    )
    info = StokesSolveInfo(
        iters=chunk * nout_i,
        err=err_t,
        err_history=hist.amax(dim=1),
        norm_Rx=hist[:, 0],
        norm_Ry=hist[:, 1],
        norm_RP=hist[:, 3],
    )
    return new_stokes, info
