"""Fused center + edge visco-elasto-plastic stress update, 3D.

Counterpart of ``justrelax_tpu/ops/stokes3d_vep.py``: one pass computes the
visco-elastic trial stress and the Drucker-Prager return mapping at cell
centers and on the three shear-edge families (yz, xz, xy), with the
reference's clamped interpolation conventions, including the center-count
clamp that never reads the outermost face of a cross-family edge array.
Plastic multipliers λ (centers) and λ_yz/λ_xz/λ_xy (edges) are relaxed;
the volume term K·dt·∂F/∂P·∂Q/∂P enters the λ denominator and the corrected
pressure. Branchless: the yield branch is a ``torch.where`` mask, and
divisions by τII are guarded.

How values move between the center and edge lattices is pluggable
(:class:`StaggeredMoves`): :func:`serial_moves` works on the staggered
arrays, ``ops/stokes3d_vep_canvas.py::canvas_moves`` on collocated canvases.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from justrelax_tpu_torch.rheology.materials import get_bulk_modulus, get_shear_modulus
from justrelax_tpu_torch.rheology.plasticity import (
    flow_gradients_P,
    plastic_params_phase,
    yield_function,
)

__all__ = [
    "update_stresses_center_edges_3d",
    "VEPStressResult3D",
    "VEPParams3D",
    "make_vep_params_3d",
    "StaggeredMoves",
    "serial_moves",
]


class StaggeredMoves(NamedTuple):
    """The staggered interpolation moves of the fused update: how values
    move between the center lattice and the edge lattices."""

    center_to_edge: Any       # (A, ax0, ax1) -> edge-family array
    harm_center_to_edge: Any
    other_to_edge: Any        # (src_name, dst_name, A) -> dst-family array
    edge_to_center: Any       # (A, ax0, ax1) -> center array


class VEPParams3D(NamedTuple):
    """Solve-invariants of :func:`update_stresses_center_edges_3d`: the
    phase-blended plastic parameters and moduli per lattice and, optionally,
    the clamped edge interpolants of the old stress τ_o (EII, the phase
    ratios and τ_o are frozen during a PT solve), evaluated once."""

    ppc: Any          # PlasticParams at centers
    G_c: Any
    K_c: Any
    ppe: tuple        # PlasticParams per edge family (yz, xz, xy)
    G_e: tuple
    K_e: tuple
    tau_o6_e: Any = None  # per family: 6-tuple of τ_o interpolated to the edges


# edge-family axes: τyz varies along (y, z) edges, τxz along (x, z), τxy (x, y)
_EDGE_AXES = {"yz": (1, 2), "xz": (0, 2), "xy": (0, 1)}
_NAMES = ("yz", "xz", "xy")


def make_vep_params_3d(material, EII_pl, phase_ratios_center, phase_ratios_edges,
                       tau_o_c6, tau_o_e3, moves: "StaggeredMoves | None" = None
                       ) -> VEPParams3D:
    """Everything in the fused update that is frozen during a PT solve,
    with the same arithmetic as its in-loop evaluation."""
    if moves is None:
        moves = serial_moves(tuple(EII_pl.shape))
    ppe, G_e, K_e, tau_o6_e = [], [], [], []
    for k, name in enumerate(_NAMES):
        a, b = _EDGE_AXES[name]
        pr_e = phase_ratios_edges[k]
        EII_e = moves.center_to_edge(EII_pl, a, b)
        ppe.append(plastic_params_phase(material, EII_e, pr_e))
        G_e.append(get_shear_modulus(material, pr_e, like=EII_pl))
        K_e.append(get_bulk_modulus(material, pr_e, like=EII_pl))
        t_no = [moves.center_to_edge(tau_o_c6[i], a, b) for i in range(3)]
        t_so = [tau_o_e3[m] if mname == name else moves.other_to_edge(mname, name, tau_o_e3[m])
                for m, mname in enumerate(_NAMES)]
        tau_o6_e.append(tuple(t_no) + tuple(t_so))
    return VEPParams3D(
        ppc=plastic_params_phase(material, EII_pl, phase_ratios_center),
        G_c=get_shear_modulus(material, phase_ratios_center, like=EII_pl),
        K_c=get_bulk_modulus(material, phase_ratios_center, like=EII_pl),
        ppe=tuple(ppe), G_e=tuple(G_e), K_e=tuple(K_e),
        tau_o6_e=tuple(tau_o6_e),
    )


class VEPStressResult3D(NamedTuple):
    tau_c: tuple      # (xx, yy, zz, yz_c, xz_c, xy_c) centers
    tau_e: tuple      # (yz, xz, xy) edges
    lam: Any
    lam_e: tuple      # (yz, xz, xy)
    tau_II: Any
    eta_vep: Any
    P_corrected: Any
    eps_pl_c: tuple   # (xx, yy, zz, yz_c, xz_c, xy_c) centers
    eps_pl_e: tuple   # (yz, xz, xy) edges
    eps_vol_pl: Any


def _inv_II(t6):
    """3D second invariant of a 6-tuple (xx, yy, zz, yz, xz, xy)."""
    xx, yy, zz, yz, xz, xy = t6
    return torch.sqrt(0.5 * (xx**2 + yy**2 + zz**2) + yz**2 + xz**2 + xy**2)


def _safe_div(a, b):
    return a / torch.where(b == 0, 1.0, b)


# --- the reference's clamped staggered moves --------------------------------
def _pad_edge(A, axis, lo, hi):
    """``A`` with ``lo``/``hi`` copies of its first/last slab along ``axis``."""
    parts = [A.narrow(axis, 0, 1)] * lo + [A] + [A.narrow(axis, A.shape[axis] - 1, 1)] * hi
    return torch.cat(parts, dim=axis)


def _pair(P, axis):
    """0.5·(P[j] + P[j+1]) along ``axis`` (size n+1 → n)."""
    n = P.shape[axis]
    return 0.5 * (P.narrow(axis, 0, n - 1) + P.narrow(axis, 1, n - 1))


def _pair_back(A, axis):
    """Backward clamped pair average, size n → n+1: (A[j-1] + A[j])/2 with
    the index clamped into the array."""
    return _pair(_pad_edge(A, axis, 1, 1), axis)


def _pair_fwd(A, axis, n_center):
    """Forward pair average clamped by the center count: A[min(i, n-1)] and
    A[min(i+1, n-1)] for i = 0..n-1 (A's last face is never read)."""
    return _pair(_pad_edge(A.narrow(axis, 0, n_center), axis, 0, 1), axis)


def _idx_clamp(A, axis, n_center):
    """B[k] = A[min(k, n-1)]: the identity read through the center-count
    clamp (drops the outermost face value)."""
    extra = A.shape[axis] - n_center
    Ax = A.narrow(axis, 0, n_center)
    return Ax if extra == 0 else _pad_edge(Ax, axis, 0, extra)


def _center_to_edge(A, ax0, ax1):
    """Clamped center → edge average over the two edge axes."""
    return _pair_back(_pair_back(A, ax0), ax1)


def _harm_center_to_edge(A, ax0, ax1):
    return 1.0 / _center_to_edge(1.0 / A, ax0, ax1)


def _edge_to_center(A, ax0, ax1):
    """Interior 4-point edge → center average."""
    return _pair(_pair(A, ax0), ax1)


def _stress_increment(tau, tau_o, eta, eps, _Gdt, dtau_r):
    return dtau_r * (2.0 * eta * eps - (tau - tau_o) * eta * _Gdt - tau)


def _other_axes(src_name, dst_name):
    """(shared, src_only, dst_only) axes of a cross-family move."""
    sa, da = _EDGE_AXES[src_name], _EDGE_AXES[dst_name]
    shared = [a for a in sa if a in da][0]
    src_only = [a for a in sa if a not in da][0]
    dst_only = [a for a in da if a not in sa][0]
    return shared, src_only, dst_only


def serial_moves(ni) -> StaggeredMoves:
    """The single-device clamped moves on the staggered arrays, closed over
    the center counts ``ni``."""

    def other_to_edge(src_name, dst_name, A):
        """Shear family ``src`` onto ``dst`` edges: forward pair along the
        source-only axis (center-count clamp), backward pair along the
        destination-only axis, index clamp along the shared one."""
        shared, src_only, dst_only = _other_axes(src_name, dst_name)
        out = _pair_fwd(A, src_only, ni[src_only])
        out = _pair_back(out, dst_only)
        return _idx_clamp(out, shared, ni[shared])

    return StaggeredMoves(
        center_to_edge=_center_to_edge,
        harm_center_to_edge=_harm_center_to_edge,
        other_to_edge=other_to_edge,
        edge_to_center=_edge_to_center,
    )


def update_stresses_center_edges_3d(
    eps_c3,            # (exx, eyy, ezz) centers
    eps_e3,            # (eyz, exz, exy) edges
    tau_c6,            # current center stress (xx, yy, zz, yz_c, xz_c, xy_c)
    tau_e3,            # current edge shear (yz, xz, xy)
    tau_o_c6,
    tau_o_e3,
    Pr,                # pressure iterate θ (centers)
    eta,               # effective viscosity (centers)
    lam, lam_e3,       # plastic multipliers: centers + 3 edge families
    EII_pl,            # accumulated plastic strain (centers)
    material,
    phase_ratios_center,   # (nx, ny, nz, nphase) or None
    phase_ratios_edges,    # (yz, xz, xy) ratios or (None, None, None)
    rel_lambda: float,
    dt,
    theta_dtau,
    moves: "StaggeredMoves | None" = None,
    params: "VEPParams3D | None" = None,
    probe_passes=None,
    edge_families=None,
) -> VEPStressResult3D:
    """One fused return mapping. ``probe_passes`` runs a subset of the
    passes: ``("center",)`` skips the three edge passes, ``("edges",)`` the
    center pass; a skipped pass returns its inputs (and zero plastic
    strain). ``edge_families`` restricts the edge passes to a subset of
    family indices (0 = yz, 1 = xz, 2 = xy); the others pass through. These
    two arguments define the plain versions of the edge kernel
    (``ops/hopper_vep3d_edges.py``): the three passes at once, or one family
    per call. Only the three normal components of ``tau_c6`` and
    ``tau_o_c6`` reach the edge passes."""
    ni = tuple(Pr.shape)
    if moves is None:
        moves = serial_moves(ni)
    other_to_edge = moves.other_to_edge
    do_edges = probe_passes is None or "edges" in probe_passes
    do_center = probe_passes is None or "center" in probe_passes
    fam_sel = tuple(range(3)) if edge_families is None else tuple(edge_families)

    # ---------------- edge passes ------------------------------------------
    new_tau_e, new_lam_e, eps_pl_e = list(tau_e3), list(lam_e3), [None] * 3
    for k, name in enumerate(_NAMES if do_edges else ()):
        if k not in fam_sel:
            continue
        a, b = _EDGE_AXES[name]
        Pv = moves.center_to_edge(Pr, a, b)
        eta_e = moves.harm_center_to_edge(eta, a, b)
        if params is None:
            pr_e = phase_ratios_edges[k]
            EII_e = moves.center_to_edge(EII_pl, a, b)
            ppe = plastic_params_phase(material, EII_e, pr_e)
            G_e = get_shear_modulus(material, pr_e, like=Pr)
            K_e = get_bulk_modulus(material, pr_e, like=Pr)
        else:
            ppe, G_e, K_e = params.ppe[k], params.G_e[k], params.K_e[k]
        _Gedt = 1.0 / (G_e * dt)
        dtau_re = 1.0 / (theta_dtau + eta_e * _Gedt + 1.0)

        # the normal components interpolate from the centers; this family's
        # own shear lives here, the other two interpolate over
        hoisted_o = params is not None and params.tau_o6_e is not None
        t_n = [moves.center_to_edge(tau_c6[i], a, b) for i in range(3)]
        e_n = [moves.center_to_edge(eps_c3[i], a, b) for i in range(3)]
        t_s, e_s = [], []
        for m, mname in enumerate(_NAMES):
            if m == k:
                t_s.append(tau_e3[m])
                e_s.append(eps_e3[m])
            else:
                t_s.append(other_to_edge(mname, name, tau_e3[m]))
                e_s.append(other_to_edge(mname, name, eps_e3[m]))
        if hoisted_o:
            t6o = params.tau_o6_e[k]
        else:
            t6o = tuple(moves.center_to_edge(tau_o_c6[i], a, b) for i in range(3)) + tuple(
                tau_o_e3[m] if m == k else other_to_edge(mname, name, tau_o_e3[m])
                for m, mname in enumerate(_NAMES))
        t6 = tuple(t_n) + tuple(t_s)
        e6 = tuple(e_n) + tuple(e_s)
        d6 = tuple(_stress_increment(t6[i], t6o[i], eta_e, e6[i], _Gedt, dtau_re)
                   for i in range(6))
        trial6 = tuple(t6[i] + d6[i] for i in range(6))
        tau_II_e = _inv_II(trial6)

        dFdP_e, dQdP_e = flow_gradients_P(ppe, Pv, tau_II_e)
        volume_e = torch.where(torch.isinf(torch.as_tensor(K_e)), 0.0,
                               K_e * dt * dFdP_e * dQdP_e)
        F_e = yield_function(ppe, Pv, tau_II_e)
        yield_e = ppe.is_pl & (tau_II_e != 0.0) & (F_e > 0.0)
        lam_new = (1.0 - rel_lambda) * lam_e3[k] + rel_lambda * (
            torch.clamp_min(F_e, 0.0) / (eta_e * dtau_re + ppe.eta_reg + volume_e))
        lam_new = torch.where(yield_e, lam_new, lam_e3[k])
        # tensor convention: the shear slot of ∂Q/∂τ is pl_frac · τ_trial/(2 τII)
        slot = 3 + k
        dQdt = ppe.pl_frac * 0.5 * _safe_div(trial6[slot], tau_II_e)
        e_pl = torch.where(yield_e, lam_new * dQdt, 0.0)
        d_own = d6[slot]
        new_tau_e[k] = tau_e3[k] + torch.where(
            yield_e, d_own - 2.0 * eta_e * e_pl * dtau_re, d_own)
        new_lam_e[k] = lam_new
        eps_pl_e[k] = e_pl
    eps_pl_e = tuple(torch.zeros_like(t) if e is None else e
                     for t, e in zip(tau_e3, eps_pl_e))

    if not do_center:
        return VEPStressResult3D(
            tau_c=tuple(tau_c6), tau_e=tuple(new_tau_e), lam=lam,
            lam_e=tuple(new_lam_e), tau_II=_inv_II(tau_c6), eta_vep=eta,
            P_corrected=Pr,
            eps_pl_c=tuple(torch.zeros_like(t) for t in tau_c6),
            eps_pl_e=eps_pl_e, eps_vol_pl=torch.zeros_like(Pr),
        )

    # ---------------- center pass ------------------------------------------
    if params is None:
        ppc = plastic_params_phase(material, EII_pl, phase_ratios_center)
        G_c = get_shear_modulus(material, phase_ratios_center, like=Pr)
        K_c = get_bulk_modulus(material, phase_ratios_center, like=Pr)
    else:
        ppc, G_c, K_c = params.ppc, params.G_c, params.K_c
    _Gdt = 1.0 / (G_c * dt)
    dtau_r = 1.0 / (theta_dtau + eta * _Gdt + 1.0)

    e_sc = (
        moves.edge_to_center(eps_e3[0], 1, 2),
        moves.edge_to_center(eps_e3[1], 0, 2),
        moves.edge_to_center(eps_e3[2], 0, 1),
    )
    e6c = tuple(eps_c3) + e_sc
    d6c = tuple(_stress_increment(tau_c6[i], tau_o_c6[i], eta, e6c[i], _Gdt, dtau_r)
                for i in range(6))
    trial = tuple(tau_c6[i] + d6c[i] for i in range(6))
    tau_II_t = _inv_II(trial)

    inf_K = torch.isinf(torch.as_tensor(K_c))
    dFdP, dQdP = flow_gradients_P(ppc, Pr, tau_II_t)
    volume = torch.where(inf_K, 0.0, K_c * dt * dFdP * dQdP)
    F = yield_function(ppc, Pr, tau_II_t)
    yield_c = ppc.is_pl & (tau_II_t != 0.0) & (F > 0.0)
    lam_new = (1.0 - rel_lambda) * lam + rel_lambda * (
        torch.clamp_min(F, 0.0) / (eta * dtau_r + ppc.eta_reg + volume))
    lam_new = torch.where(yield_c, lam_new, lam)

    scale = ppc.pl_frac * 0.5
    eps_pl_c = tuple(
        torch.where(yield_c, lam_new * scale * _safe_div(trial[i], tau_II_t), 0.0)
        for i in range(6))
    corr = 2.0 * eta * dtau_r
    tau_new = tuple(torch.where(yield_c, trial[i] - corr * eps_pl_c[i], trial[i])
                    for i in range(6))
    eps_vol_pl = torch.where(yield_c, -lam_new * dQdP, 0.0)
    tau_II = torch.where(yield_c, _inv_II(tau_new), tau_II_t)
    eps_II = _inv_II(e6c)
    eta_vep = tau_II * 0.5 * _safe_div(torch.ones_like(eps_II), eps_II)
    P_corr = Pr - torch.where(inf_K, 0.0, K_c * dt * lam_new * dQdP)

    return VEPStressResult3D(
        tau_c=tau_new,
        tau_e=tuple(new_tau_e),
        lam=lam_new,
        lam_e=tuple(new_lam_e),
        tau_II=tau_II,
        eta_vep=eta_vep,
        P_corrected=P_corr,
        eps_pl_c=eps_pl_c,
        eps_pl_e=eps_pl_e,
        eps_vol_pl=eps_vol_pl,
    )
