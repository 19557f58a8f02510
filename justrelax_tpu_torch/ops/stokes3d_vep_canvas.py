"""Collocated-canvas 3D VEP iteration: the plain chunk, and the hybrid
iteration whose edge passes run in the edge kernel.

Counterpart of ``justrelax_tpu/ops/stokes3d_vep_canvas.py``. Every field
lives in one (nx+2, ny+2, nz+2) canvas, collocated as in
``ops/stokes3d_canvas.py`` (cell (i,j,k) at (i+1, j+1, k+1); τyz/λyz edge at
(i+1, j, k), τxz at (i, j+1, k), τxy at (i, j, k+1); Vx face i at a = i).
The return mapping is not duplicated: the chunk drives
``ops/stokes3d_vep.py::update_stresses_center_edges_3d`` through
canvas-collocated :class:`StaggeredMoves` (:func:`canvas_moves`), where a
center canvas's ghost refresh (slot 0 ← 1, slot n+1 ← n) stands for the
reference's clamped indices, shifts are ``torch.roll`` and selections
``torch.where`` on index bands; the slots a band leaves alone keep their
values. Every phase blend is evaluated once per solve
(:func:`vep3d_canvas_consts`).

With an ``edges_fn`` (the caller binds ``ops/hopper_vep3d_edges.py::
vep3d_edges`` to its consts: B6, or B9 with ``split=True``) the three edge
return-mapping passes run there (the hybrid iteration), and the center
pass, θ/P, the viscosity continuation and the velocity update stay here.
Both read the pre-iteration state (a Jacobi update), so the split is
exact. The fully fused chunk (B8) is ``ops/hopper_stokes3d_vep.py``. The
TPU lowering choices (the "slice"/"roll" shift, ``x_off``/``y_off``
windows) are not ported.

Supported configuration (guarded by the solver): uniform grid, all
free-slip BCs, no variational mask, and a creep table that is linear or
collapses to a shared-exponent power law.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F

from justrelax_tpu_torch.ops.stencil import _pad_arg
from justrelax_tpu_torch.ops.stokes import compute_P
from justrelax_tpu_torch.ops.stokes3d_canvas import _band, _sm1, _sp1
from justrelax_tpu_torch.ops.stokes3d_vep import (
    StaggeredMoves,
    VEPParams3D,
    _inv_II,
    _other_axes,
    _pad_edge,
    update_stresses_center_edges_3d,
)
from justrelax_tpu_torch.rheology.materials import (
    _as_stack,
    _bcast,
    get_bulk_modulus,
    get_shear_modulus,
    phase_average,
)
from justrelax_tpu_torch.rheology.plasticity import plastic_params_phase
from justrelax_tpu_torch.rheology.viscosity import (
    continuation_linear,
    phase_viscosity,
    powerlaw_recip_coeffs,
    shared_powerlaw_exponent,
)

__all__ = [
    "VEP3DCanvasConsts",
    "VEP3DCanvasCarry",
    "canvas_moves",
    "canvas_strain_rates",
    "edge_masks",
    "embed_center",
    "embed_edge",
    "extract_center",
    "extract_edge",
    "vep3d_canvas_consts",
    "iteration_vep3d_canvas",
    "vep3d_chunk_canvas",
    "pack_vep_carry",
    "unpack_vep_carry",
]

_EDGE_PADS = {
    0: ((1, 1), (0, 1), (0, 1)),  # yz edges at (i+1, j, k)
    1: ((0, 1), (1, 1), (0, 1)),  # xz edges at (i, j+1, k)
    2: ((0, 1), (0, 1), (1, 1)),  # xy edges at (i, j, k+1)
}
_EDGE_AXES3 = ((1, 2), (0, 2), (0, 1))
_NAMES3 = ("yz", "xz", "xy")


def _embed(A, pads, mode):
    """Pad the leading three axes of ``A`` by ``pads`` (``numpy.pad`` style),
    with zeros (``"constant"``) or copies of the boundary slabs
    (``"edge"``)."""
    if mode == "edge":
        for ax, (lo, hi) in enumerate(pads):
            A = _pad_edge(A, ax, lo, hi)
        return A
    return F.pad(A, _pad_arg(tuple(pads) + ((0, 0),) * (A.ndim - 3)))


def embed_center(A, mode="constant"):
    """(nx, ny, nz[, p]) cell field → canvas at slots (i+1, j+1, k+1)."""
    return _embed(A, ((1, 1), (1, 1), (1, 1)), mode)


def embed_edge(A, fam, mode="constant"):
    """Edge-family field → canvas (fam 0 = yz, 1 = xz, 2 = xy)."""
    return _embed(A, _EDGE_PADS[fam], mode)


def extract_center(C):
    return C[1:-1, 1:-1, 1:-1]


def extract_edge(C, fam):
    sl = tuple(slice(1, -1) if p == (1, 1) else slice(None, -1) for p in _EDGE_PADS[fam])
    return C[sl]


def _ghost_refresh(A, ax, n):
    """Copy the boundary interior slabs of a center-collocated canvas axis
    (slots 1..n) into its ghost slabs: slot 0 ← slot 1, slot n+1 ← slot n,
    the reference's clamped indexing."""
    out = A.clone()
    out.narrow(ax, 0, 1).copy_(A.narrow(ax, 1, 1))
    out.narrow(ax, n + 1, 1).copy_(A.narrow(ax, n, 1))
    return out


def _slab_from(A, ax, dst, src):
    """``A`` with its slab ``dst`` along ``ax`` replaced by slab ``src``."""
    out = A.clone()
    out.narrow(ax, dst, 1).copy_(A.narrow(ax, src, 1))
    return out


def canvas_moves(ni) -> StaggeredMoves:
    """Canvas-collocated clamped staggered moves: on the slots each family
    owns, the values of ``ops/stokes3d_vep.py::serial_moves``."""

    def center_to_edge(A, a, b):
        out = A
        for ax in (a, b):
            out = _ghost_refresh(out, ax, ni[ax])
            out = 0.5 * (out + _sm1(out, ax))
        return out

    def harm_center_to_edge(A, a, b):
        return 1.0 / center_to_edge(1.0 / A, a, b)

    def other_to_edge(src_name, dst_name, A):
        shared, src_only, dst_only = _other_axes(src_name, dst_name)
        n = ni[src_only]
        # forward pair with the center-count clamp (the outermost face along
        # src_only is never read): slot n takes slot n-1, then the backward
        # pair average onto center slots 1..n
        Ax = _slab_from(A, src_only, n, n - 1)
        out = 0.5 * (_sp1(Ax, src_only) + Ax)
        # backward pair along the destination's own staggered axis
        out = _ghost_refresh(out, dst_only, ni[dst_only])
        out = 0.5 * (out + _sm1(out, dst_only))
        # index clamp along the shared staggered axis: slot n takes slot n-1
        return _slab_from(out, shared, ni[shared], ni[shared] - 1)

    def edge_to_center(A, ax0, ax1):
        out = 0.5 * (_sp1(A, ax0) + A)
        return 0.5 * (_sp1(out, ax1) + out)

    return StaggeredMoves(
        center_to_edge=center_to_edge,
        harm_center_to_edge=harm_center_to_edge,
        other_to_edge=other_to_edge,
        edge_to_center=edge_to_center,
    )


def canvas_strain_rates(V, inv_di):
    """(∇·V, the deviatoric normal strain rates at the cell slots, the shear
    strain rates at the edge slots) of the velocity canvases ``V``."""
    Vx, Vy, Vz = V
    inv_dx, inv_dy, inv_dz = inv_di
    dVxdx = (Vx - _sp1(Vx, 0)) * inv_dx
    dVydy = (Vy - _sp1(Vy, 1)) * inv_dy
    dVzdz = (Vz - _sp1(Vz, 2)) * inv_dz
    grad_V = dVxdx + dVydy + dVzdz
    third = 1.0 / 3.0
    eps_c3 = (dVxdx - grad_V * third, dVydy - grad_V * third, dVzdz - grad_V * third)
    eps_e3 = (
        0.5 * ((_sm1(Vy, 2) - Vy) * inv_dz + (_sm1(Vz, 1) - Vz) * inv_dy),
        0.5 * ((_sm1(Vx, 2) - Vx) * inv_dz + (_sm1(Vz, 0) - Vz) * inv_dx),
        0.5 * ((_sm1(Vx, 1) - Vx) * inv_dy + (_sm1(Vy, 0) - Vy) * inv_dx),
    )
    return grad_V, eps_c3, eps_e3


def _maxloc_canvas(A, ni):
    """maxloc(window=1) with clamped boundaries on a center canvas: a
    separable 3-point max per axis after the ghost refresh."""
    B = A
    for ax in range(3):
        B = _ghost_refresh(B, ax, ni[ax])
        B = torch.maximum(B, torch.maximum(_sm1(B, ax), _sp1(B, ax)))
    return B


def edge_masks(shape, device=None):
    """(Mc, Me): the cell mask and the three edge families' masks of a canvas
    of ``shape``. The VEP update writes every edge of a family, the boundary
    edges included (slot 0 along the family's edge axes)."""
    nx, ny, nz = shape[0] - 2, shape[1] - 2, shape[2] - 2

    def b(ax, lo, hi):
        return _band(shape, ax, lo, hi, device)

    Mc = b(0, 1, nx) & b(1, 1, ny) & b(2, 1, nz)
    Me = (
        b(0, 1, nx) & b(1, 0, ny) & b(2, 0, nz),
        b(0, 0, nx) & b(1, 1, ny) & b(2, 0, nz),
        b(0, 0, nx) & b(1, 0, ny) & b(2, 1, nz),
    )
    return Mc, Me


class VEP3DCanvasConsts(NamedTuple):
    """Loop-invariant canvases, every phase blend evaluated at build time."""

    params: Any                # VEPParams3D of canvases (plastic + moduli)
    tau_o_c: tuple             # 6 center canvases
    tau_o_e: tuple             # 3 edge canvases
    P0: Any
    Q: Any
    fzA: Optional[Any]         # buoyancy affine coefficients: fz_cell = fzA + fzB·P
    fzB: Optional[Any]         #   (None, None ⇒ zero body force)
    visc_eta: Optional[Any]    # linear creep: constant viscosity target
    visc_A: Optional[Any]      # else collapsed power law 1/η = A + B·τII^m
    visc_B: Optional[Any]
    visc_m: Any                # float exponent (None ⇒ linear)


class VEP3DCanvasCarry(NamedTuple):
    V: tuple                   # (Vx, Vy, Vz) face canvases
    P: Any
    theta: Any
    tau_c: tuple               # 6 center canvases
    tau_e: tuple               # 3 edge canvases
    eta: Any
    lam: Any
    lam_e: tuple               # 3 edge canvases


def _has_creep(p):
    return any(bool((getattr(p, a) > 0).any())
               for a in ("disl_A", "diff_A", "peierls_A", "gbs_A"))


def vep3d_canvas_consts(material, tau_o_c6, tau_o_e3, EII_pl, P0, Q,
                        phase_ratios_center, phase_ratios_edges,
                        T=None, visc_m="auto", hoist_tau_o=True,
                        scalar_plastic=False, scalar_K=False) -> VEP3DCanvasConsts:
    """The loop-invariant canvases of a solve, built once, with the material
    evaluated on the device and in the dtype of ``EII_pl``.

    ``visc_m`` is the creep table's shared power-law exponent minus one
    (``rheology.viscosity.shared_powerlaw_exponent``), ``None`` for a linear
    table, or ``"auto"`` to resolve it from the material.
    ``hoist_tau_o=False`` leaves the τ_o edge interpolants to the edge pass
    (B6 re-derives them); with ``True`` each family carries its six
    (B9 and the plain chunk). ``scalar_plastic=True`` collapses the plastic
    parameters to 0-d tensors by a one-hot evaluation, exact only where
    plasticity is phase-uniform with softening off
    (``ops/hopper_vep3d_edges.py::vep3d_blocked_supported``);
    ``scalar_K=True`` likewise collapses the bulk modulus (guard: Kb
    phase-uniform)."""
    kw = dict(dtype=EII_pl.dtype, device=EII_pl.device)
    material = _as_stack(material, EII_pl).to(**kw)
    m = material.params
    nphase = material.nphase
    ni = tuple(EII_pl.shape)

    def as_t(v):
        return None if v is None else v.to(**kw)

    pr_c = as_t(phase_ratios_center)
    pr_cc = None if pr_c is None else embed_center(pr_c, mode="edge")
    pr_ec = tuple(None if p is None else embed_edge(as_t(p), k, mode="edge")
                  for k, p in enumerate(phase_ratios_edges))
    EII_c = embed_center(EII_pl, mode="edge")
    T_c = None if T is None else embed_center(as_t(T), mode="edge")
    moves = canvas_moves(ni)

    onehot = torch.zeros((1, nphase), **kw)
    onehot[0, 0] = 1.0
    if scalar_plastic:
        pp_s = plastic_params_phase(material, torch.zeros((1,), **kw), onehot)
        pp_s = type(pp_s)(*(v[0] for v in pp_s))
        ppc = pp_s
    else:
        ppc = plastic_params_phase(material, EII_c, pr_cc)
    K_scalar = get_bulk_modulus(material, onehot)[0] if scalar_K else None
    G_c = get_shear_modulus(material, pr_cc, like=EII_c)
    K_c = K_scalar if scalar_K else get_bulk_modulus(material, pr_cc, like=EII_c)
    tau_oc_canvas = tuple(embed_center(as_t(t)) for t in tau_o_c6)
    tau_oe_canvas = tuple(embed_edge(as_t(t), k) for k, t in enumerate(tau_o_e3))
    ppe, G_e, K_e, tau_o6_e = [], [], [], []
    for k, (a, b) in enumerate(_EDGE_AXES3):
        if scalar_plastic:
            ppe.append(pp_s)
        else:
            EII_e = moves.center_to_edge(EII_c, a, b)
            ppe.append(plastic_params_phase(material, EII_e, pr_ec[k]))
        G_e.append(get_shear_modulus(material, pr_ec[k], like=EII_c))
        K_e.append(K_scalar if scalar_K else get_bulk_modulus(material, pr_ec[k], like=EII_c))
        if not hoist_tau_o:
            continue
        t_no = [moves.center_to_edge(tau_oc_canvas[i], a, b) for i in range(3)]
        t_so = [tau_oe_canvas[j] if j == k else
                moves.other_to_edge(_NAMES3[j], _NAMES3[k], tau_oe_canvas[j])
                for j in range(3)]
        tau_o6_e.append(tuple(t_no) + tuple(t_so))
    params = VEPParams3D(
        ppc=ppc, G_c=G_c, K_c=K_c,
        ppe=tuple(ppe), G_e=tuple(G_e), K_e=tuple(K_e),
        tau_o6_e=tuple(tau_o6_e) if hoist_tau_o else None,
    )

    # buoyancy: ρ(T, P)·g is affine in P with T frozen (phase_average is
    # linear), the density law of materials.compute_density:
    # ρ = Σ_p r·[ρ0(1 − α(T − T0)) + ρ0·β·(P − P0_mat)] = Aρ + Bρ·P
    if bool((m.rho0 != 0).any()):
        ref = EII_c
        rho0 = _bcast(m.rho0, ref)
        A_p = rho0
        if T_c is not None:
            A_p = A_p * (1.0 - _bcast(m.alpha, ref) * (T_c[..., None] - _bcast(m.T0, ref)))
        B_p = rho0 * _bcast(m.beta, ref)
        A_p = A_p - B_p * _bcast(m.P0, ref)
        B_p = B_p.expand(tuple(ref.shape) + (B_p.shape[-1],))
        A_rho = phase_average(A_p, pr_cc)
        B_rho = phase_average(B_p, pr_cc)
        g = phase_average(m.gravity, pr_cc).expand(A_rho.shape)
        fzA, fzB = A_rho * g, B_rho * g
    else:
        fzA = fzB = None

    if visc_m == "auto":
        visc_m = shared_powerlaw_exponent(material)
        if visc_m is None and _has_creep(m):
            raise ValueError(
                "canvas VEP needs a creep table that is linear or collapses "
                "to a shared-exponent power law (shared_powerlaw_exponent)")
    if visc_m is None:
        # linear table: the tau-mode viscosity does not depend on τII, so one
        # evaluation is the refresh target
        visc_eta = phase_viscosity(material, torch.ones_like(EII_c), T_c, pr_cc, "tau")
        visc_A = visc_B = None
    else:
        visc_eta = None
        visc_A, visc_B = powerlaw_recip_coeffs(material, EII_c, T_c, pr_cc)

    return VEP3DCanvasConsts(
        params=params,
        tau_o_c=tau_oc_canvas,
        tau_o_e=tau_oe_canvas,
        P0=embed_center(as_t(P0)),
        Q=embed_center(as_t(Q)),
        fzA=fzA, fzB=fzB,
        visc_eta=visc_eta, visc_A=visc_A, visc_B=visc_B, visc_m=visc_m,
    )


def iteration_vep3d_canvas(
    c: VEP3DCanvasCarry,
    co: VEP3DCanvasConsts,
    material,
    inv_di,
    *,
    nx, ny, nz,
    dt,
    r, theta_dtau, etadtau,
    lambda_relaxation,
    viscosity_relaxation,
    viscosity_cutoff=(-math.inf, math.inf),
    edges_fn=None,
):
    """One fused 3D VEP PT iteration on collocated canvases, with the
    semantics of the solver's serial iteration: maxloc → θ update → ρ(T,P)·g
    → strain rate → fused center + edges return mapping → τII viscosity
    continuation → damped velocity update + free-slip BCs.

    ``edges_fn=None`` runs the edge passes here with the center pass. Else
    the iteration is the hybrid one and ``edges_fn(V, θ, η, τ_c normals,
    τ_e, λ_e, inv_di=…, dt=…, theta_dtau=…, lambda_relaxation=…)`` returns
    the new (τ_e, λ_e): ``vep3d_edges`` or ``vep3d_edges_reference`` of
    ``ops/hopper_vep3d_edges.py`` with its consts (and ``split``) bound."""
    ni = (nx, ny, nz)
    moves = canvas_moves(ni)
    Vx, Vy, Vz = c.V
    inv_dx, inv_dy, inv_dz = inv_di
    shape = tuple(c.P.shape)
    dtype, device = c.P.dtype, c.P.device

    def b(ax, lo, hi):
        return _band(shape, ax, lo, hi, device)

    Mc, Me = edge_masks(shape, device)
    MVx = b(0, 1, nx - 1) & b(1, 1, ny) & b(2, 1, nz)
    MVy = b(0, 1, nx) & b(1, 1, ny - 1) & b(2, 1, nz)
    MVz = b(0, 1, nx) & b(1, 1, ny) & b(2, 1, nz - 1)

    # 1. maxloc preconditioner + divergence + compressible θ iterate
    eta_tau = _maxloc_canvas(c.eta, ni)
    grad_V, eps_c3, eps_e3 = canvas_strain_rates(c.V, inv_di)
    _, theta = compute_P(c.theta, co.P0, grad_V, co.Q, eta_tau, co.params.K_c,
                         co.params.G_c, dt, r, theta_dtau)
    theta = torch.where(Mc, theta, c.theta)

    # 2. buoyancy from the previous corrected pressure (solver order)
    if co.fzA is not None:
        fz_cell = co.fzA + co.fzB * c.P
        fz = 0.5 * (fz_cell + _sm1(fz_cell, 2))
    else:
        fz = None

    # 3-4. fused center + edges return mapping on the strain rates: the
    # serial body through the canvas moves and the precomputed parameter
    # canvases
    args = (eps_c3, eps_e3, c.tau_c, c.tau_e, co.tau_o_c, co.tau_o_e,
            theta, c.eta, c.lam, c.lam_e, None, material, None, (None, None, None),
            lambda_relaxation, dt, theta_dtau)
    if edges_fn is not None:
        res = update_stresses_center_edges_3d(*args, moves=moves, params=co.params,
                                              probe_passes=("center",))
        tau_e_k, lam_e_k = edges_fn(
            c.V, theta, c.eta, c.tau_c[:3], c.tau_e, c.lam_e, inv_di=inv_di,
            dt=dt, theta_dtau=theta_dtau, lambda_relaxation=lambda_relaxation)
        res = res._replace(tau_e=tau_e_k, lam_e=lam_e_k)
    else:
        res = update_stresses_center_edges_3d(*args, moves=moves, params=co.params)
    tau_c = tuple(torch.where(Mc, t, old) for t, old in zip(res.tau_c, c.tau_c))
    tau_e = tuple(torch.where(m, t, old) for m, t, old in zip(Me, res.tau_e, c.tau_e))
    lam = torch.where(Mc, res.lam, c.lam)
    lam_e = tuple(torch.where(m, t, old) for m, t, old in zip(Me, res.lam_e, c.lam_e))
    P = torch.where(Mc, res.P_corrected, c.P)

    # 5. τII viscosity continuation: the creep target is the precomputed
    # constant canvas (linear table) or the collapsed power law
    # 1/η = A + B·τII^m
    eps0 = (sum(t.abs() for t in tau_c) == 0).to(dtype) * torch.finfo(dtype).eps
    tII = _inv_II((tau_c[0] + eps0,) + tau_c[1:])
    if co.visc_m is None:
        eta_n = co.visc_eta
    else:
        eta_n = 1.0 / (co.visc_A + co.visc_B * tII ** co.visc_m)
    eta_n = continuation_linear(eta_n, c.eta, viscosity_relaxation)
    eta = torch.clamp(eta_n, viscosity_cutoff[0], viscosity_cutoff[1])
    eta = torch.where(Mc, eta, c.eta)

    # 6. damped velocity update on the interior faces + free-slip mirrors
    txx, tyy, tzz = tau_c[:3]
    tyz, txz, txy = tau_e
    etat = eta_tau
    rx = ((_sm1(txx, 0) - txx) * inv_dx
          + (txy - _sp1(txy, 1)) * inv_dy
          + (txz - _sp1(txz, 2)) * inv_dz
          - (_sm1(P, 0) - P) * inv_dx)
    Vx = torch.where(MVx, Vx + rx * (etadtau / (0.5 * (etat + _sm1(etat, 0)))), Vx)
    ry = ((txy - _sp1(txy, 0)) * inv_dx
          + (_sm1(tyy, 1) - tyy) * inv_dy
          + (tyz - _sp1(tyz, 2)) * inv_dz
          - (_sm1(P, 1) - P) * inv_dy)
    Vy = torch.where(MVy, Vy + ry * (etadtau / (0.5 * (etat + _sm1(etat, 1)))), Vy)
    rz = ((txz - _sp1(txz, 0)) * inv_dx
          + (tyz - _sp1(tyz, 1)) * inv_dy
          + (_sm1(tzz, 2) - tzz) * inv_dz
          - (_sm1(P, 2) - P) * inv_dz)
    if fz is not None:
        rz = rz - fz
    Vz = torch.where(MVz, Vz + rz * (etadtau / (0.5 * (etat + _sm1(etat, 2)))), Vz)

    # free-slip tangential mirrors in the serial order: front, back, top,
    # bot, left, right
    Vx, Vz = _slab_from(Vx, 1, 0, 1), _slab_from(Vz, 1, 0, 1)
    Vx, Vz = _slab_from(Vx, 1, ny + 1, ny), _slab_from(Vz, 1, ny + 1, ny)
    Vx, Vy = _slab_from(Vx, 2, 0, 1), _slab_from(Vy, 2, 0, 1)
    Vx, Vy = _slab_from(Vx, 2, nz + 1, nz), _slab_from(Vy, 2, nz + 1, nz)
    Vy, Vz = _slab_from(Vy, 0, 0, 1), _slab_from(Vz, 0, 0, 1)
    Vy, Vz = _slab_from(Vy, 0, nx + 1, nx), _slab_from(Vz, 0, nx + 1, nx)

    return VEP3DCanvasCarry(V=(Vx, Vy, Vz), P=P, theta=theta, tau_c=tau_c, tau_e=tau_e,
                            eta=eta, lam=lam, lam_e=lam_e)


def vep3d_chunk_canvas(c: VEP3DCanvasCarry, co: VEP3DCanvasConsts, material, inv_di,
                       nout, **kw):
    """Advance ``nout`` canvas VEP iterations (keywords: those of
    :func:`iteration_vep3d_canvas`)."""
    X, Y, Z = c.P.shape
    for _ in range(int(nout)):
        c = iteration_vep3d_canvas(c, co, material, inv_di, nx=X - 2, ny=Y - 2, nz=Z - 2,
                                   **kw)
    return c


def pack_vep_carry(V, P, theta, tau_c, tau_e, eta, lam, lam_e) -> VEP3DCanvasCarry:
    """Staggered solver fields → canvas carry."""
    Vx, Vy, Vz = V
    return VEP3DCanvasCarry(
        V=(F.pad(Vx, (0, 0, 0, 0, 0, 1)), F.pad(Vy, (0, 0, 0, 1, 0, 0)),
           F.pad(Vz, (0, 1, 0, 0, 0, 0))),
        P=embed_center(P),
        theta=embed_center(theta),
        tau_c=tuple(embed_center(t) for t in tau_c),
        tau_e=tuple(embed_edge(t, k) for k, t in enumerate(tau_e)),
        eta=embed_center(eta),
        lam=embed_center(lam),
        lam_e=tuple(embed_edge(t, k) for k, t in enumerate(lam_e)),
    )


def unpack_vep_carry(c: VEP3DCanvasCarry):
    """Inverse of :func:`pack_vep_carry` (views of the canvases)."""
    Vx, Vy, Vz = c.V
    return (
        (Vx[:-1], Vy[:, :-1], Vz[:, :, :-1]),
        extract_center(c.P),
        extract_center(c.theta),
        tuple(extract_center(t) for t in c.tau_c),
        tuple(extract_edge(t, k) for k, t in enumerate(c.tau_e)),
        extract_center(c.eta),
        extract_center(c.lam),
        tuple(extract_edge(t, k) for k, t in enumerate(c.lam_e)),
    )
