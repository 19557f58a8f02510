"""Distributed visco-elasto-plastic APT Stokes solver, 3D.

Counterpart of ``justrelax_tpu/parallel/stokes3d_vep.py`` (the reference's
3D GeoParams ``_solve!``, Stokes3D.jl:204-660, under
ImplicitGlobalGrid/MPI): the plastic return-mapping loop (the compressible
pressure iterate θ, the fused center + edge Drucker-Prager stress update,
the τII viscosity relaxation) on each rank's tile of an ("x", "y", "z")
mesh.

The fused stress update is the serial solver's
(``ops/stokes3d_vep.py::update_stresses_center_edges_3d``), parameterized
by :class:`~justrelax_tpu_torch.ops.stokes3d_vep.StaggeredMoves`; this
module supplies halo-aware moves:

- the backward clamped pair average (center → edge) is a plain pair average
  of a ghost-extended block: ``extend`` replicates the outermost layer on a
  physical-boundary rank, which is the serial clamp, and takes the
  neighbour's layer elsewhere;
- the forward center-count-clamped pair average and the index clamp act on
  the shared staggered faces, the clamp only on the last rank along the
  axis.

Called one at a time, each move is one exchange. The solver asks the moves
for all of an iteration's edge interpolants up front
(:meth:`HaloMoves.prefetch`): the first extensions of every family go in one
batch of slabs and the second in another, and the stress update reads them
back. The arithmetic is the same, so the values are the same bits.

Shared faces and edges are computed redundantly, in the same order, on
adjacent ranks, so the solve reproduces the serial solver to rounding. As in
the JAX package, the plastic-strain outputs (EII/EVol), the φ-masked
variational variant and nonuniform spacing are not threaded: asking for them
raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import torch

from justrelax_tpu_torch.ops import stokes3d as k3
from justrelax_tpu_torch.ops.stokes import compute_P
from justrelax_tpu_torch.ops.stokes3d_vep import (
    _EDGE_AXES,
    _edge_to_center,
    _inv_II,
    _other_axes,
    _pair,
    StaggeredMoves,
    make_vep_params_3d,
    update_stresses_center_edges_3d,
)
from justrelax_tpu_torch.parallel import halo
from justrelax_tpu_torch.parallel.decomp import Decomp3D
from justrelax_tpu_torch.parallel.stokes3d import (
    eta_ghosts_3d,
    eta_tau_fields_3d,
    exchange_velocity_ghosts_3d,
    flow_bcs_local_3d,
    local_blocks_3d,
    momentum_all_faces_3d,
    norm_masks_3d,
    reduced_norms_3d,
    velocity_update_3d,
)
from justrelax_tpu_torch.rheology.materials import (
    _as_stack,
    compute_density,
    get_bulk_modulus,
    get_shear_modulus,
    phase_average,
)
from justrelax_tpu_torch.rheology.viscosity import continuation_linear, phase_viscosity
from justrelax_tpu_torch.solvers.stokes2d import _ratio

__all__ = ["solve_vep_sharded_3d", "distributed_moves", "HaloMoves", "ShardedVEPResult3D"]

_NAMES = ("yz", "xz", "xy")


class ShardedVEPResult3D(NamedTuple):
    Vx: Any
    Vy: Any
    Vz: Any
    P: Any
    txx: Any
    tyy: Any
    tzz: Any
    tyz_c: Any
    txz_c: Any
    txy_c: Any
    tyz: Any
    txz: Any
    txy: Any
    eta: Any
    lam: Any
    tau_II: Any
    err: Any
    iters: Any


def _last_as_penultimate(A, axis, last: bool):
    """``A`` with its last slice along ``axis`` replaced by the one before it
    on the last rank along the axis (the serial center-count clamp)."""
    if not last:
        return A
    s = A.shape[axis]
    return torch.cat([A.narrow(axis, 0, s - 1), A.narrow(axis, s - 2, 1)], dim=axis)


class HaloMoves:
    """Halo-aware clamped staggered moves for blocked-local tiles, with the
    edge interpolants of a stress update computed ahead in two batches.

    ``edges[axis] = (is_first, is_last)``. Center inputs are disjoint tiles;
    edge-family arrays carry shared faces. Each move gives the serial
    clamped move's values bit for bit (shared outputs computed redundantly
    in the same order on adjacent ranks). :attr:`moves` is the
    :class:`StaggeredMoves`; a move whose input was prefetched reads its
    result back, any other runs at once (one exchange)."""

    def __init__(self, edges):
        self.edges = edges
        self._table = {}
        self.moves = StaggeredMoves(
            center_to_edge=self.center_to_edge,
            harm_center_to_edge=self.harm_center_to_edge,
            other_to_edge=self.other_to_edge,
            edge_to_center=_edge_to_center,  # interior 4-point average: local
        )

    # ---- the moves, one at a time
    @staticmethod
    def pair_back(A, axis):
        """The serial ``_pair_back`` (size n → n+1 with the edge clamp) from
        the block extended by one layer along ``axis``."""
        return _pair(halo.extend(A, axis, 1), axis)

    def pair_fwd(self, A, axis):
        """The serial ``_pair_fwd`` on a face array: the local faces are
        shared, so no exchange; only the last rank's final entry clamps
        (½(A[n−1] + A[n−1]) = A[n−1], its penultimate face)."""
        out = _pair(A, axis)
        if not self.edges[axis][1]:
            return out
        s = A.shape[axis]
        return torch.cat([out.narrow(axis, 0, s - 2), A.narrow(axis, s - 2, 1)], dim=axis)

    def idx_clamp(self, A, axis):
        """The serial ``_idx_clamp`` along a shared staggered axis: the
        identity but for the last rank's outermost face."""
        return _last_as_penultimate(A, axis, self.edges[axis][1])

    def _lookup(self, key, A):
        hit = self._table.get(key)
        return hit[1] if hit is not None and hit[0] is A else None

    def center_to_edge(self, A, a, b):
        got = self._lookup(("c", id(A), a, b), A)
        return got if got is not None else self.pair_back(self.pair_back(A, a), b)

    def harm_center_to_edge(self, A, a, b):
        got = self._lookup(("h", id(A), a, b), A)
        return got if got is not None else 1.0 / self.center_to_edge(1.0 / A, a, b)

    def other_to_edge(self, src_name, dst_name, A):
        got = self._lookup(("o", id(A), src_name, dst_name), A)
        if got is not None:
            return got
        shared, src_only, dst_only = _other_axes(src_name, dst_name)
        out = self.pair_back(self.pair_fwd(A, src_only), dst_only)
        return self.idx_clamp(out, shared)

    # ---- every interpolant of a stress update, in two batches
    def prefetch(self, centers=(), harmonic=(), shear=()):
        """Compute ahead ``center_to_edge`` of each array of ``centers`` and
        ``harm_center_to_edge`` of each of ``harmonic`` onto the three edge
        families, and ``other_to_edge`` of each ``(family name, array)`` of
        ``shear`` onto the other two: every first extension in one batch,
        every second in another. Replaces what an earlier call held."""
        self._table = {}
        srcs = [("c", A, A) for A in centers] + [("h", A, 1.0 / A) for A in harmonic]
        # level 1: each center array along x (the xz and xy families) and
        # along y (yz); each shear array forward-paired along its own axis,
        # then extended along the destination's
        items, pend = [], []
        for kind, key, A in srcs:
            items += [(A, 0, 1), (A, 1, 1)]
        for name, A in shear:
            for dst in _NAMES:
                if dst == name:
                    continue
                shared, src_only, dst_only = _other_axes(name, dst)
                items.append((self.pair_fwd(A, src_only), dst_only, 1))
                pend.append((name, dst, A, shared, dst_only))
        got = iter(halo.extend_many(items))
        firsts = []
        for kind, key, A in srcs:
            firsts.append((_pair(next(got), 0), _pair(next(got), 1)))
        for name, dst, A, shared, dst_only in pend:
            out = self.idx_clamp(_pair(next(got), dst_only), shared)
            self._table[("o", id(A), name, dst)] = (A, out)
        # level 2: yz along z from the y pair, xz along z and xy along y
        # from the x pair
        items = []
        for B0, B1 in firsts:
            items += [(B1, 2, 1), (B0, 2, 1), (B0, 1, 1)]
        got = iter(halo.extend_many(items)) if items else iter(())
        for (kind, key, _), _ in zip(srcs, firsts):
            for name in _NAMES:
                a, b = _EDGE_AXES[name]
                out = _pair(next(got), b)
                self._table[(kind, id(key), a, b)] = (key, 1.0 / out if kind == "h" else out)


def distributed_moves(edges) -> StaggeredMoves:
    """Halo-aware clamped staggered moves for blocked-local tiles (the JAX
    package's name): ``edges[axis] = (is_first, is_last)``, read inside
    ``with mesh:``. Each move exchanges at once; the solver's prefetching
    form is :class:`HaloMoves`."""
    return HaloMoves(edges).moves


# blocked-local inputs, in the JAX package's order
_ORDER = (
    "Vx", "Vy", "Vz", "P", "Q",
    "txx", "tyy", "tzz", "tyz_c", "txz_c", "txy_c", "tyz", "txz", "txy",
    "txx_o", "tyy_o", "tzz_o", "tyz_c_o", "txz_c_o", "txy_c_o",
    "tyz_o", "txz_o", "txy_o",
    "EII_pl", "eta",
)
_OPTIONAL = ("T", "pr_c", "pr_yz", "pr_xz", "pr_xy")
_SPACINGS = ("inv_dx", "inv_dy", "inv_dz")


def _not_threaded(blocks):
    """Refuse what the sharded 3D VEP solve does not thread, as the JAX
    package's does not: other blocks (the φ-masked variant's, EII/EVol
    outputs) and per-node spacings."""
    extra = sorted(set(blocks) - set(_ORDER + _OPTIONAL + _SPACINGS))
    if extra:
        raise NotImplementedError(
            f"solve_vep_sharded_3d threads no {extra}: the φ-masked variant and the "
            "plastic-strain outputs run on the serial solve_vep_3d only")
    for k in _SPACINGS:
        if torch.as_tensor(blocks[k]).numel() != 1:
            raise NotImplementedError(
                "solve_vep_sharded_3d runs on a uniform grid only (scalar inv_dx/dy/dz)")


def solve_vep_sharded_3d(
    mesh,
    decomp: Decomp3D,
    blocks: dict,
    pt_stokes,
    flow_bc,
    material,
    dt,
    iter_max: int = 10_000,
    iter_min: int = 100,
    nout: int = 500,
    viscosity_relaxation: float = 1.0e-2,
    lambda_relaxation: float = 0.2,
    viscosity_cutoff: Tuple[float, float] = (-math.inf, math.inf),
):
    """Run the VEP APT Stokes solve over a 3D mesh.

    ``blocks`` holds this rank's tiles (or the whole blocked containers) of
    the fields in ``_ORDER`` plus the scalars ``inv_dx/dy/dz``; optional:
    ``T`` (centers) and the phase-ratio stacks ``pr_c``/``pr_yz``/``pr_xz``/
    ``pr_xy``, whose trailing phase axis is not split. ``P0 ← P`` at solve
    entry, as in the serial solver. Returns a :class:`ShardedVEPResult3D`
    of this rank's tiles, ``err`` (equal on every rank) and ``iters``.
    """
    blocks = dict(blocks)
    _not_threaded(blocks)
    nl = decomp.ni_local
    inv_di = tuple(float(torch.as_tensor(blocks.pop(k))) for k in _SPACINGS)
    r, theta_dtau, etadtau = pt_stokes.r, pt_stokes.theta_dtau, pt_stokes.etadtau
    eps_rel, eps_abs = pt_stokes.eps_rel, pt_stokes.eps_abs
    nout_i = int(nout)
    max_chunks = max(1, int(math.ceil(iter_max / nout_i)))
    min_chunks = int(math.ceil(iter_min / nout_i))
    t = local_blocks_3d(mesh, decomp, blocks, _ORDER + _OPTIONAL)
    P0, Q, EII_pl = t["P"], t["Q"], t["EII_pl"]
    T, pr_c = t.get("T"), t.get("pr_c")
    pr_e = tuple(t.get(k) for k in ("pr_yz", "pr_xz", "pr_xy"))
    material = _as_stack(material, P0)
    dtype = P0.dtype
    tau_o_c6 = tuple(t[k] for k in ("txx_o", "tyy_o", "tzz_o", "tyz_c_o", "txz_c_o", "txy_c_o"))
    tau_o_e3 = tuple(t[k] for k in ("tyz_o", "txz_o", "txy_o"))

    with mesh:
        edges = tuple(halo.axis_edges(a) for a in ("x", "y", "z"))
        hm = HaloMoves(edges)
        K_c = get_bulk_modulus(material, pr_c, like=P0)
        G_c = get_shear_modulus(material, pr_c, like=P0)
        # the solve-invariants of the fused update, with the halo-aware moves
        hm.prefetch(centers=(EII_pl,) + tau_o_c6[:3],
                    shear=tuple(zip(_NAMES, tau_o_e3)))
        vep_params = make_vep_params_3d(material, EII_pl, pr_c, pr_e, tau_o_c6, tau_o_e3,
                                        moves=hm.moves)
        gravity = phase_average(material.params.gravity, pr_c)
        masks = norm_masks_3d(mesh, decomp, P0.device)

        def rho_g_fields(Pc):
            rho = compute_density(material, T=T, P=Pc, phase_ratios=pr_c)
            z = torch.zeros_like(rho)
            return z, z, rho * gravity.expand(rho.shape)

        def refresh_viscosity(eta_old, tau_c6):
            eps0 = (sum(x.abs() for x in tau_c6) == 0).to(dtype) * torch.finfo(dtype).eps
            tII = _inv_II((tau_c6[0] + eps0,) + tuple(tau_c6[1:]))
            eta_n = phase_viscosity(material, tII, T, pr_c, "tau")
            eta_n = continuation_linear(eta_n, eta_old, viscosity_relaxation)
            return torch.clamp(eta_n, viscosity_cutoff[0], viscosity_cutoff[1])

        def one_iteration(c: dict) -> dict:
            V = c["V"]
            eta_tau, *etat = eta_tau_fields_3d(eta_ghosts_3d(c["eta"]))
            grad_V = k3.compute_grad_V_3d(*V, inv_di)
            RP, theta = compute_P(c["theta"], P0, grad_V, Q, eta_tau, K_c, G_c, dt, r,
                                  theta_dtau)
            f = rho_g_fields(c["P"])
            exx, eyy, ezz, eyz, exz, exy = k3.compute_strain_rate_3d(grad_V, *V, inv_di)
            tau_c, tau_e = c["tau_c"], c["tau_e"]
            hm.prefetch(centers=(theta,) + tuple(tau_c[:3]) + (exx, eyy, ezz),
                        harmonic=(c["eta"],),
                        shear=tuple(zip(_NAMES, tau_e)) + tuple(zip(_NAMES, (eyz, exz, exy))))
            res = update_stresses_center_edges_3d(
                (exx, eyy, ezz), (eyz, exz, exy), tau_c, tau_e, tau_o_c6, tau_o_e3,
                theta, c["eta"], c["lam"], c["lam_e"], EII_pl, material, pr_c, pr_e,
                lambda_relaxation, dt, theta_dtau, moves=hm.moves, params=vep_params)
            eta = refresh_viscosity(c["eta"], res.tau_c)
            tau6 = tuple(res.tau_c[:3]) + tuple(res.tau_e)
            R = momentum_all_faces_3d(res.P_corrected, tau6, f, inv_di)
            V = velocity_update_3d(V, R, etat, etadtau, edges)
            V = flow_bcs_local_3d(V, flow_bc, edges)
            V = exchange_velocity_ghosts_3d(V, nl)
            return dict(V=V, P=res.P_corrected, theta=theta, tau_c=tuple(res.tau_c),
                        tau_e=tuple(res.tau_e), eta=eta, lam=res.lam, lam_e=tuple(res.lam_e),
                        tau_II=res.tau_II, RP=RP)

        def residual_norms(c):
            tau6 = tuple(c["tau_c"][:3]) + tuple(c["tau_e"])
            R = momentum_all_faces_3d(c["P"], tau6, rho_g_fields(c["P"]), inv_di)
            return reduced_norms_3d(mesh, decomp, R, c["RP"], masks)

        zc = torch.zeros_like(P0)
        tau_e3 = tuple(t[k] for k in ("tyz", "txz", "txy"))
        c = dict(V=(t["Vx"], t["Vy"], t["Vz"]), P=P0, theta=P0,
                 tau_c=tuple(t[k] for k in ("txx", "tyy", "tzz", "tyz_c", "txz_c", "txy_c")),
                 tau_e=tau_e3, eta=t["eta"], lam=zc,
                 lam_e=tuple(torch.zeros_like(x) for x in tau_e3), tau_II=zc, RP=zc)
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
    (Vx, Vy, Vz), (txx, tyy, tzz, tyz_c, txz_c, txy_c), (tyz, txz, txy) = (
        c["V"], c["tau_c"], c["tau_e"])
    return ShardedVEPResult3D(Vx=Vx, Vy=Vy, Vz=Vz, P=c["P"], txx=txx, tyy=tyy, tzz=tzz,
                              tyz_c=tyz_c, txz_c=txz_c, txy_c=txy_c, tyz=tyz, txz=txz,
                              txy=txy, eta=c["eta"], lam=c["lam"], tau_II=c["tau_II"],
                              err=err_t, iters=chunk * nout_i)
