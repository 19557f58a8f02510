"""Variational (embedded free-surface) APT Stokes solver, 3D.

Counterpart of ``justrelax_tpu/solvers/stokes3d_variational.py``: the
visco-elastic 3D iteration of ``solvers/stokes3d.py`` with every field
masked by the :class:`~justrelax_tpu_torch.ops.rock_ratio.RockRatio3D`. Air
carries no equations, stencil differences weight their operands by the
local rock fraction φ, invalid faces are set to zero, and the residual
norms follow the 3D convention (‖R‖₂ over a node count, no square root).

The solve runs in chunks of ``nout`` iterations: ``nout − 1`` core
iterations, then one whose residuals are read on the host once per chunk.
The core iterations update the solve's static tensors in place
(:class:`_Variational3DSolve`); on the card they are replays of CUDA
graphs captured once per call (``solvers/graphed_chunk.py``), on the CPU
they run eagerly.
"""

from __future__ import annotations

import math

import torch

from justrelax_tpu_torch.ops import stokes3d as k3
from justrelax_tpu_torch.ops.bc import _free_slip_velocity_3d, _no_slip_velocity_3d
from justrelax_tpu_torch.ops.rock_ratio import RockRatio3D, valid_masks_3d
from justrelax_tpu_torch.ops.stencil import maxloc
from justrelax_tpu_torch.ops.stokes import compute_P
from justrelax_tpu_torch.solvers.graphed_chunk import GraphedChunk
from justrelax_tpu_torch.solvers.stokes2d import StokesSolveInfo, _norm, _ratio

__all__ = ["solve_variational_3d", "masked_momentum_3d", "masked_velocity_update_3d",
           "variational_norms_3d"]


def masked_momentum_3d(P, tau6, fw, inv_di, phi: RockRatio3D, vm, spacings=None):
    """φ-weighted momentum residuals at the interior faces, zero at the
    invalid ones. ``fw`` holds the φ-weighted body forces (fx·φ, fy·φ,
    fz·φ at the centers; ``None`` for a zero component); ``spacings`` the
    nonuniform momentum bundle (``ops/stokes3d.py::spacing_families_3d``)."""
    (_dx, _dy, _dz), (_dxv, _dyv, _dzv) = k3.momentum_families_3d(inv_di, spacings)
    txx, tyy, tzz, tyz, txz, txy = tau6
    Pw = P * phi.center
    txxw, tyyw, tzzw = txx * phi.center, tyy * phi.center, tzz * phi.center
    tyzw, txzw, txyw = tyz * phi.yz, txz * phi.xz, txy * phi.xy
    fxw, fyw, fzw = fw
    Rx = (
        (txxw[1:, :, :] - txxw[:-1, :, :]) * _dxv
        + (txyw[1:-1, 1:, :] - txyw[1:-1, :-1, :]) * _dy
        + (txzw[1:-1, :, 1:] - txzw[1:-1, :, :-1]) * _dz
        - (Pw[1:, :, :] - Pw[:-1, :, :]) * _dxv
    )
    Ry = (
        (txyw[1:, 1:-1, :] - txyw[:-1, 1:-1, :]) * _dx
        + (tyyw[:, 1:, :] - tyyw[:, :-1, :]) * _dyv
        + (tyzw[:, 1:-1, 1:] - tyzw[:, 1:-1, :-1]) * _dz
        - (Pw[:, 1:, :] - Pw[:, :-1, :]) * _dyv
    )
    Rz = (
        (txzw[1:, :, 1:-1] - txzw[:-1, :, 1:-1]) * _dx
        + (tyzw[:, 1:, 1:-1] - tyzw[:, :-1, 1:-1]) * _dy
        + (tzzw[:, :, 1:] - tzzw[:, :, :-1]) * _dzv
        - (Pw[:, :, 1:] - Pw[:, :, :-1]) * _dzv
    )
    # a zero body force adds nothing (x − 0 is x), so it is left out
    if fxw is not None:
        Rx = Rx - 0.5 * (fxw[1:, :, :] + fxw[:-1, :, :])
    if fyw is not None:
        Ry = Ry - 0.5 * (fyw[:, 1:, :] + fyw[:, :-1, :])
    if fzw is not None:
        Rz = Rz - 0.5 * (fzw[:, :, 1:] + fzw[:, :, :-1])
    return (torch.where(vm.vx[1:-1, :, :], Rx, 0.0),
            torch.where(vm.vy[:, 1:-1, :], Ry, 0.0),
            torch.where(vm.vz[:, :, 1:-1], Rz, 0.0))


def masked_velocity_update_3d(V, R, eta_tau, etadtau, vm, flow_bc):
    """The damped velocity update of the valid interior faces (the invalid
    ones set to zero) and the velocity BCs, in place on ``V``."""
    Vx, Vy, Vz = V
    Rx, Ry, Rz = R
    etax = 0.5 * (eta_tau[1:, :, :] + eta_tau[:-1, :, :])
    etay = 0.5 * (eta_tau[:, 1:, :] + eta_tau[:, :-1, :])
    etaz = 0.5 * (eta_tau[:, :, 1:] + eta_tau[:, :, :-1])
    new = (
        torch.where(vm.vx[1:-1, :, :], Vx[1:-1, 1:-1, 1:-1] + Rx * etadtau / etax, 0.0),
        torch.where(vm.vy[:, 1:-1, :], Vy[1:-1, 1:-1, 1:-1] + Ry * etadtau / etay, 0.0),
        torch.where(vm.vz[:, :, 1:-1], Vz[1:-1, 1:-1, 1:-1] + Rz * etadtau / etaz, 0.0),
    )
    for v, n in zip(V, new):
        v[1:-1, 1:-1, 1:-1] = n
    if flow_bc.no_slip.any():
        _no_slip_velocity_3d(Vx, Vy, Vz, flow_bc.no_slip)
    if flow_bc.free_slip.any():
        _free_slip_velocity_3d(Vx, Vy, Vz, flow_bc.free_slip)


def variational_norms_3d(R, RP):
    """(nRx, nRy, nRz, nRP): ‖·‖₂ of the residuals' interior over their node
    counts (the JAX package's 3D convention, no square root)."""
    Rx, Ry, Rz = R
    nx, ny, nz = RP.shape
    return torch.stack([
        _norm(Rx[1:-1, 1:-1, 1:-1]) / ((nx - 2) * (ny - 1) * (nz - 1)),
        _norm(Ry[1:-1, 1:-1, 1:-1]) / ((nx - 1) * (ny - 2) * (nz - 1)),
        _norm(Rz[1:-1, 1:-1, 1:-1]) / ((nx - 1) * (ny - 1) * (nz - 2)),
        _norm(RP) / (nx * ny * nz),
    ])


class _Variational3DSolve(GraphedChunk):
    """One ``solve_variational_3d`` call: the carried fields (V, P, τ;
    updated in place by :meth:`iteration`) and the constants of the call."""

    def __init__(self, stokes, pt_stokes, geometry, flow_bc, rho_g, G, K, phi, dt):
        # the spacing families (tensors on a nonuniform grid, made before any
        # capture)
        self.inv_di, self.inv_di_v, self.mom = k3.spacing_families_3d(geometry, stokes.P)
        self.r, self.theta_dtau = pt_stokes.r, pt_stokes.theta_dtau
        self.etadtau = pt_stokes.etadtau
        self.flow_bc, self.phi, self.G, self.K, self.dt = flow_bc, phi, G, K, dt
        self.vm = valid_masks_3d(phi)
        self.eta = stokes.viscosity.eta
        self.eta_tau = maxloc(self.eta, window=1)
        self.P0, self.Q = stokes.P0, stokes.Q
        to = stokes.tau_o
        self.tau_o = (to.xx, to.yy, to.zz, to.yz, to.xz, to.xy)
        self.fw = tuple(f * phi.center for f in rho_g)
        tau = stokes.tau
        self.V = tuple(v.clone() for v in (stokes.V.Vx, stokes.V.Vy, stokes.V.Vz))
        self.P = stokes.P.clone()
        self.tau = tuple(t.clone() for t in (tau.xx, tau.yy, tau.zz, tau.yz, tau.xz, tau.xy))

    def carried(self):
        return list(self.V) + [self.P] + list(self.tau)

    def iteration(self):
        """One masked VE iteration on the carried fields, in place; returns
        RP and the momentum residuals (before the velocity update)."""
        vm = self.vm
        Vx, Vy, Vz = self.V
        grad_V = torch.where(vm.c, k3.compute_grad_V_3d(Vx, Vy, Vz, self.inv_di), 0.0)
        exx, eyy, ezz, eyz, exz, exy = k3.compute_strain_rate_3d(grad_V, Vx, Vy, Vz,
                                                                 self.inv_di, self.inv_di_v)
        eps = (torch.where(vm.c, exx, 0.0), torch.where(vm.c, eyy, 0.0),
               torch.where(vm.c, ezz, 0.0), torch.where(vm.yz, eyz, 0.0),
               torch.where(vm.xz, exz, 0.0), torch.where(vm.xy, exy, 0.0))
        RP, P = compute_P(self.P, self.P0, grad_V, self.Q, self.eta, self.K, self.G, self.dt,
                          self.r, self.theta_dtau)
        P = torch.where(vm.c, P, 0.0)
        RP = torch.where(vm.c, RP, 0.0)
        txx, tyy, tzz, tyz, txz, txy = k3.compute_tau_ve_3d(
            self.tau, self.tau_o, eps, self.eta, self.G, self.theta_dtau, self.dt)
        tau = (torch.where(vm.c, txx, 0.0), torch.where(vm.c, tyy, 0.0),
               torch.where(vm.c, tzz, 0.0), torch.where(vm.yz, tyz, 0.0),
               torch.where(vm.xz, txz, 0.0), torch.where(vm.xy, txy, 0.0))
        R = masked_momentum_3d(P, tau, self.fw, self.inv_di, self.phi, vm, self.mom)
        masked_velocity_update_3d(self.V, R, self.eta_tau, self.etadtau, vm, self.flow_bc)
        self.P.copy_(P)
        for t, new in zip(self.tau, tau):
            t.copy_(new)
        return RP, R


def solve_variational_3d(
    stokes,
    pt_stokes,
    geometry,
    flow_bc,
    rho_g,
    G,
    K,
    phi: RockRatio3D,
    dt,
    iter_max: int = 50_000,
    nout: int = 500,
):
    """One masked 3D VE Stokes solve; returns ``(stokes, info)`` as the JAX
    package does. ``rho_g`` is the (fx, fy, fz) body force at the centers;
    ``G``/``K`` may be ∞. On the card the chunks' core iterations are CUDA
    graph replays. On a ``NonuniformGeometry`` the operators take its
    spacing families (``ops/stokes3d.py::spacing_families_3d``)."""
    eps_rel, eps_abs = pt_stokes.eps_rel, pt_stokes.eps_abs
    nout_i = int(nout)
    max_chunks = max(1, int(math.ceil(iter_max / nout_i)))
    dtype, device = stokes.P.dtype, stokes.P.device
    s = _Variational3DSolve(stokes, pt_stokes, geometry, flow_bc, rho_g, G, K, phi, dt)

    hist = torch.full((max_chunks, 4), math.nan, dtype=dtype, device=device)
    # err starts at inf, so at least one chunk runs
    err, err1, chunk = math.inf, 1.0, 0
    while chunk < 1 or ((_ratio(err, err1) > eps_rel and err > eps_abs) and chunk < max_chunks):
        s.run_chunk(nout_i - 1)
        RP, R = s.iteration()
        norms = variational_norms_3d(R, RP)
        err_t = norms.amax()
        hist[chunk] = norms
        err = float(err_t)  # the one host read per chunk
        if chunk == 0:
            err1 = err
        chunk += 1

    Vx, Vy, Vz = s.V
    txx, tyy, tzz, tyz, txz, txy = s.tau
    new_stokes = stokes.replace(
        P=s.P,
        V=stokes.V.replace(Vx=Vx, Vy=Vy, Vz=Vz),
        tau=stokes.tau.replace(
            xx=txx, yy=tyy, zz=tzz, yz=tyz, xz=txz, xy=txy,
            II=k3.tensor_invariant_staggered_3d(txx, tyy, tzz, tyz, txz, txy)),
        tau_o=stokes.tau_o.replace(xx=txx, yy=tyy, zz=tzz, yz=tyz, xz=txz, xy=txy),
        R=stokes.R.replace(RP=RP, Rx=R[0], Ry=R[1], Rz=R[2]),
        viscosity=stokes.viscosity.replace(eta_tau=s.eta_tau),
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
