"""Variational (embedded free-surface) APT Stokes solver, 2D.

Counterpart of ``justrelax_tpu/solvers/stokes2d_variational.py``: the
multi-phase VEP iteration with every field masked by the
:class:`~justrelax_tpu_torch.ops.rock_ratio.RockRatio`. Air carries no
equations (its fields are zeroed and its velocity updates skipped), stencil
differences weight their operands by the local rock fraction φ, and the
residual norms follow the plain solvers' convention (the rows next to the
walls are left out). Two terms beyond the reference's update, as in the JAX
package: with ``free_surface`` the masked stabilization Vy·∂(φρg)/∂y·dt in
the y momentum, and a velocity pseudo-step divided by max(φ_face,
``mask_step_floor``).

The solve runs in chunks of ``nout`` iterations: ``nout − 1`` core
iterations, then one that also yields the diagnostics, and the residual
norms, read on the host once per chunk. The core iterations update the
solve's static tensors in place (:class:`_VariationalSolve`); on the card
they are replays of CUDA graphs captured once per call
(``solvers/graphed_chunk.py``), on the CPU they run eagerly. The material's
constants are read to the host once per call, before any capture.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from justrelax_tpu_torch.ops import stokes as kernels
from justrelax_tpu_torch.ops.bc import _free_slip_velocity_2d, _no_slip_velocity_2d
from justrelax_tpu_torch.ops.rock_ratio import RockRatio, valid_masks
from justrelax_tpu_torch.ops.stencil import av_a, maxloc
from justrelax_tpu_torch.ops.stokes_vep import (
    _update_stresses,
    linear_viscosity_tables,
    vep_invariants,
)
from justrelax_tpu_torch.rheology.materials import _as_stack, compute_density, phase_average
from justrelax_tpu_torch.rheology.plasticity import second_invariant_staggered
from justrelax_tpu_torch.rheology.viscosity import (
    _is_linear_creep,
    compute_viscosity_fields,
    continuation_linear,
    correct_phase_ratio,
)
from justrelax_tpu_torch.solvers.graphed_chunk import GraphedChunk
from justrelax_tpu_torch.solvers.stokes2d_vep import _gather4
from justrelax_tpu_torch.solvers.stokes2d import StokesSolveInfo, _norm, _ratio

__all__ = ["solve_variational"]


class _VariationalSolve(GraphedChunk):
    """One ``solve_variational`` call: the carried fields (updated in place
    by :meth:`iteration`) and the constants of the call."""

    CARRIED = ("Vx", "Vy", "P", "theta", "txx", "tyy", "txy_c", "txy_v", "eta", "eta_v",
               "lam", "lam_v")

    def __init__(self, stokes, pt_stokes, geometry, flow_bc, material, pr_c, pr_v,
                 phi: RockRatio, dt, T, viscosity_relaxation, lambda_relaxation,
                 viscosity_cutoff, air_phase, mask_step_floor, free_surface):
        # the spacing families (tensors on a nonuniform grid, made before any
        # capture): center, vertex (the shear strain rate) and momentum,
        # (∂x, ∂y) at the x faces and (∂y, ∂x) at the y faces
        self.inv_dx, self.inv_dy, self.strain_v, self.mom = kernels.spacing_families_2d(
            geometry, stokes.P)
        self.r, self.theta_dtau = pt_stokes.r, pt_stokes.theta_dtau
        self.etadtau = pt_stokes.etadtau
        self.flow_bc, self.dt, self.phi = flow_bc, dt, phi
        self.material, self.pr_c = material, pr_c
        self.lambda_relaxation = lambda_relaxation
        self.viscosity_relaxation, self.viscosity_cutoff = viscosity_relaxation, viscosity_cutoff
        self.free_surface = free_surface
        self.vm = valid_masks(phi)
        self.P0, self.Q = stokes.P, stokes.Q
        to = stokes.tau_o
        self.inv = vep_invariants(to.xx, to.yy, to.xy_c, to.xy, stokes.EII_pl, material,
                                  pr_c, pr_v)
        # the viscosity's phase blend leaves the air out: corrected once
        if air_phase is not None:
            self.visc_c = correct_phase_ratio(pr_c, air_phase)
            self.visc_v = correct_phase_ratio(pr_v, air_phase)
        else:
            self.visc_c, self.visc_v = pr_c, pr_v
        # the host reads of the call: a linear creep table's viscosity is
        # one evaluation (the JAX iteration's, without the invariant it does
        # not read), and a pressure-independent density one buoyancy field
        self.eta_tables = None
        if _is_linear_creep(material):
            self.eta_tables = linear_viscosity_tables(
                material, self.visc_c, self.visc_v, None, None, stokes.P, stokes.tau.xy)
        self.T = T
        self.gravity = phase_average(material.params.gravity, pr_c)
        self.rho_gy = None
        if not bool((material.params.beta != 0).any()):
            self.rho_gy = self.rho_g_y(stokes.P)
        # the rock-fraction step preconditioner
        self.pcx = torch.clamp_min(phi.Vx[1:-1, :], mask_step_floor)
        self.pcy = torch.clamp_min(phi.Vy[:, 1:-1], mask_step_floor)
        # the carried fields
        self.Vx, self.Vy = stokes.V.Vx.clone(), stokes.V.Vy.clone()
        self.P, self.theta = stokes.P.clone(), stokes.P.clone()
        tau = stokes.tau
        self.txx, self.tyy = tau.xx.clone(), tau.yy.clone()
        self.txy_c, self.txy_v = tau.xy_c.clone(), tau.xy.clone()
        self.eta = stokes.viscosity.eta.clone()
        self.eta_v = stokes.viscosity.eta_v.clone()
        self.lam, self.lam_v = torch.zeros_like(stokes.P), torch.zeros_like(tau.xy)

    def carried(self):
        return [getattr(self, k) for k in self.CARRIED]

    # ---- the masked operators -------------------------------------------
    def rho_g_y(self, P):
        """ρ(T, P)·g at the centers (the x component is zero)."""
        rho = compute_density(self.material, T=self.T, P=P, phase_ratios=self.pr_c)
        return rho * self.gravity.expand(rho.shape)

    def buoyancy(self, P):
        return self.rho_gy if self.rho_gy is not None else self.rho_g_y(P)

    def masked_strain(self, Vx, Vy):
        vm = self.vm
        grad_V = kernels.compute_grad_V(Vx, Vy, self.inv_dx, self.inv_dy)
        grad_V = torch.where(vm.c, grad_V, 0.0)
        exx, eyy, exy = kernels.compute_strain_rate(grad_V, Vx, Vy, self.inv_dx, self.inv_dy,
                                                    **self.strain_v)
        return (grad_V, torch.where(vm.c, exx, 0.0), torch.where(vm.c, eyy, 0.0),
                torch.where(vm.v, exy, 0.0))

    def masked_momentum(self, P, txx, tyy, txy, rho_gy, Vy):
        """φ-weighted momentum residuals at the interior faces, zero at the
        invalid ones; with ``free_surface`` the y residual gains the
        stabilization Vy·∂(φρg)/∂y·dt (the reference's variational
        compute_Vy!, the damper of the piston mode an open surface leaves
        undamped in pseudo-time)."""
        phi, vm = self.phi, self.vm
        sxx, sxy, syy, syx = self.mom
        Pw = P * phi.center
        txxw = txx * phi.center
        tyyw = tyy * phi.center
        txyw = txy * phi.vertex
        gyw = rho_gy * phi.center
        # ρg_x is zero: the x residual has no buoyancy term
        Rx = (
            (txxw[1:, :] - txxw[:-1, :]) * sxx
            + (txyw[1:-1, 1:] - txyw[1:-1, :-1]) * sxy
            - (Pw[1:, :] - Pw[:-1, :]) * sxx
        )
        Ry = (
            (tyyw[:, 1:] - tyyw[:, :-1]) * syy
            + (txyw[1:, 1:-1] - txyw[:-1, 1:-1]) * syx
            - (Pw[:, 1:] - Pw[:, :-1]) * syy
            - 0.5 * (gyw[:, 1:] + gyw[:, :-1])
        )
        if self.free_surface:
            # ∂(φρg)/∂y spans adjacent centers, the family of ∂P/∂y
            drho = (gyw[:, 1:] - gyw[:, :-1]) * syy
            Ry = Ry + Vy[1:-1, 1:-1] * drho * self.dt
        return torch.where(vm.vx[1:-1, :], Rx, 0.0), torch.where(vm.vy[:, 1:-1], Ry, 0.0)

    def viscosity(self, txx, tyy, txy_c, txy_v):
        if self.eta_tables is not None:
            return tuple(
                torch.clamp(continuation_linear(tab, old, self.viscosity_relaxation),
                            self.viscosity_cutoff[0], self.viscosity_cutoff[1])
                for tab, old in zip(self.eta_tables, (self.eta, self.eta_v)))
        zv = torch.zeros_like(self.eta_v)
        return compute_viscosity_fields(
            self.eta, self.eta_v, self.material, txx, tyy, txy_c, zv, zv, txy_v,
            self.visc_c, self.visc_v, mode="tau", relaxation=self.viscosity_relaxation,
            cutoff=self.viscosity_cutoff)

    # ---- the iteration ----------------------------------------------------
    def iteration(self):
        """One masked VEP iteration on the carried fields, in place; returns
        the stress update's result (τII masked) and RP, the diagnostics."""
        vm, inv, dt = self.vm, self.inv, self.dt
        eta_tau = maxloc(self.eta, window=1)
        grad_V, exx, eyy, exy = self.masked_strain(self.Vx, self.Vy)
        RP, theta = kernels.compute_P(self.theta, self.P0, grad_V, self.Q, eta_tau, inv.K_c,
                                      inv.G_c, dt, self.r, self.theta_dtau)
        theta = torch.where(vm.c, theta, 0.0)
        RP = torch.where(vm.c, RP, 0.0)
        rho_gy = self.buoyancy(self.P)
        res = _update_stresses(exx, eyy, exy, self.txx, self.tyy, self.txy_c, self.txy_v,
                               theta, self.eta, self.lam, self.lam_v, inv,
                               self.lambda_relaxation, dt, self.theta_dtau)
        txx = torch.where(vm.c, res.txx, 0.0)
        tyy = torch.where(vm.c, res.tyy, 0.0)
        txy_c = torch.where(vm.c, res.txy_c, 0.0)
        txy_v = torch.where(vm.v, res.txy_v, 0.0)
        P_new = torch.where(vm.c, res.P_corrected, 0.0)
        eta, eta_v = self.viscosity(txx, tyy, txy_c, txy_v)
        Rx, Ry = self.masked_momentum(P_new, txx, tyy, txy_v, rho_gy, self.Vy)
        etax = 0.5 * (eta_tau[1:, :] + eta_tau[:-1, :])
        etay = 0.5 * (eta_tau[:, 1:] + eta_tau[:, :-1])
        # the masked update, the invalid faces set to zero
        Vx_in = torch.where(vm.vx[1:-1, :],
                            self.Vx[1:-1, 1:-1] + Rx * self.etadtau / (etax * self.pcx), 0.0)
        Vy_in = torch.where(vm.vy[:, 1:-1],
                            self.Vy[1:-1, 1:-1] + Ry * self.etadtau / (etay * self.pcy), 0.0)
        self.Vx[1:-1, 1:-1] = Vx_in
        self.Vy[1:-1, 1:-1] = Vy_in
        if self.flow_bc.no_slip.any():
            _no_slip_velocity_2d(self.Vx, self.Vy, self.flow_bc.no_slip)
        if self.flow_bc.free_slip.any():
            _free_slip_velocity_2d(self.Vx, self.Vy, self.flow_bc.free_slip)
        for name, value in (("P", P_new), ("theta", theta), ("txx", txx), ("tyy", tyy),
                            ("txy_c", txy_c), ("txy_v", txy_v), ("eta", eta),
                            ("eta_v", eta_v), ("lam", res.lam), ("lam_v", res.lam_v)):
            getattr(self, name).copy_(value)
        return res._replace(tau_II=torch.where(vm.c, res.tau_II, 0.0)), RP

    def residuals(self):
        """The momentum residuals of the carried state."""
        return self.masked_momentum(self.P, self.txx, self.tyy, self.txy_v,
                                    self.buoyancy(self.P), self.Vy)


def solve_variational(
    stokes,
    pt_stokes,
    geometry,
    flow_bc,
    material,
    phase_ratios_center: torch.Tensor,
    phase_ratios_vertex: torch.Tensor,
    phi: RockRatio,
    dt,
    T: Optional[torch.Tensor] = None,
    iter_max: int = 50_000,
    iter_min: int = 100,
    nout: int = 500,
    viscosity_relaxation: float = 1.0e-2,
    lambda_relaxation: float = 0.2,
    viscosity_cutoff: Tuple[float, float] = (-math.inf, math.inf),
    air_phase: Optional[int] = None,
    mask_step_floor: float = 1.0,
    free_surface: bool = False,
):
    """One variational VEP Stokes solve (one physical time step); returns
    ``(stokes, info)`` as the JAX package does. ``T`` enters the density
    only. ``air_phase`` leaves the air out of the viscosity's phase blend.
    The solve runs on the state's device; on the card the chunks' core
    iterations are CUDA graph replays. A bare ``Material`` is stacked once
    on the state's device and in its dtype. On a ``NonuniformGeometry``
    the operators take its spacing families
    (``ops/stokes.py::spacing_families_2d``)."""
    material = _as_stack(material, stokes.P)
    nx, ny = stokes.P.shape
    eps_rel, eps_abs = pt_stokes.eps_rel, pt_stokes.eps_abs
    nout_i = int(nout)
    max_chunks = max(1, int(math.ceil(iter_max / nout_i)))
    min_chunks = int(math.ceil(iter_min / nout_i))
    dtype, device = stokes.P.dtype, stokes.P.device

    s = _VariationalSolve(stokes, pt_stokes, geometry, flow_bc, material,
                          phase_ratios_center, phase_ratios_vertex, phi, dt, T,
                          viscosity_relaxation, lambda_relaxation, viscosity_cutoff, air_phase,
                          mask_step_floor, free_surface)

    def residual_norms(RP):
        Rx, Ry = s.residuals()
        nRx = _norm(Rx[1:-1, 1:-1]) / math.sqrt((nx - 2) * (ny - 1))
        nRy = _norm(Ry[1:-1, 1:-1]) / math.sqrt((nx - 1) * (ny - 2))
        nRP = _norm(RP) / math.sqrt(nx * ny)
        return nRx, nRy, nRP, Rx, Ry

    hist = torch.full((max_chunks, 3), math.nan, dtype=dtype, device=device)
    # err starts at inf, so at least one chunk runs and sets the diagnostics
    err, err1, chunk = math.inf, 1.0, 0
    while chunk < min_chunks or (
        (_ratio(err, err1) > eps_rel and err > eps_abs) and chunk < max_chunks
    ):
        s.run_chunk(nout_i - 1)
        # the chunk's last iteration, eagerly, yields every diagnostic
        res, RP = s.iteration()
        nRx, nRy, nRP, _, _ = residual_norms(RP)
        err_t = torch.maximum(torch.maximum(nRx, nRy), nRP)
        # iter_min may ask for more chunks than iter_max: the history keeps
        # the last in its last row, as JAX's clamped dynamic update does
        hist[min(chunk, max_chunks - 1)] = torch.stack([nRx, nRy, nRP])
        err = float(err_t)  # the one host read per chunk
        if chunk == 0:
            err1 = err
        chunk += 1

    # --- post-loop diagnostics & state assembly ----------------------------
    grad_V, exx, eyy, exy = s.masked_strain(s.Vx, s.Vy)
    _, _, _, Rx, Ry = residual_norms(RP)
    new_tau = dict(xx=s.txx, yy=s.tyy, xy=s.txy_v, xy_c=s.txy_c)
    new_stokes = stokes.replace(
        P=s.P, P0=s.P0,
        V=stokes.V.replace(Vx=s.Vx, Vy=s.Vy),
        grad_V=grad_V,
        tau=stokes.tau.replace(**new_tau, II=res.tau_II),
        tau_o=stokes.tau_o.replace(**new_tau),
        eps=stokes.eps.replace(
            xx=exx, yy=eyy, xy=exy, xy_c=av_a(exy),
            II=second_invariant_staggered(exx, eyy, _gather4(exy))),
        EII_pl=stokes.EII_pl + second_invariant_staggered(
            res.eps_pl_xx, res.eps_pl_yy, _gather4(res.eps_pl_xy_v)) * dt,
        lam=s.lam, lam_v=s.lam_v,
        viscosity=stokes.viscosity.replace(eta=s.eta, eta_v=s.eta_v, eta_vep=res.eta_vep),
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
