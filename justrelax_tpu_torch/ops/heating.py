"""Shear heating and adiabatic heating source terms.

Counterpart of ``justrelax_tpu/ops/heating.py``. Shear heating is the
non-elastic dissipation H_s = τ : (ε̇ − ε̇_el) with ε̇_el = (τ − τ_o)/(2 G dt),
clamped ≥ 0; shear components count twice in the contraction (tensor
double-dot).
"""

from __future__ import annotations

import torch

from justrelax_tpu_torch.ops.stencil import av_a
from justrelax_tpu_torch.rheology.materials import get_shear_modulus

__all__ = [
    "compute_shear_heating",
    "compute_shear_heating_3d",
    "shear_components_to_centers_3d",
    "adiabatic_heating",
]


def compute_shear_heating(
    txx, tyy, txy_c, txx_o, tyy_o, txy_c_o, exx, eyy, exy_v,
    material, dt, phase_ratios=None,
):
    """H_s at cell centers (2D). ``exy_v`` is the vertex strain rate,
    averaged onto the centers."""
    G = get_shear_modulus(material, phase_ratios, like=txx)
    _Gdt = 1.0 / (G * dt)
    exy_c = av_a(exy_v)
    e_el = tuple(0.5 * (t - to) * _Gdt
                 for t, to in ((txx, txx_o), (tyy, tyy_o), (txy_c, txy_c_o)))
    H = (
        txx * (exx - e_el[0])
        + tyy * (eyy - e_el[1])
        + 2.0 * txy_c * (exy_c - e_el[2])
    )
    return torch.clamp_min(H, 0.0)


def adiabatic_heating(alpha, T_in, Vx, Vy, P, rho_gy, inv_di):
    """α·(V·∇P) at the cell centers (2D), the pressure gradients one-sided
    with the first row and column repeated; ``update_T`` multiplies it by T.
    ``T_in`` and ``rho_gy`` are not read, as in the JAX function."""
    dPdx = (P[1:, :] - P[:-1, :]) * inv_di[0]
    dPdy = (P[:, 1:] - P[:, :-1]) * inv_di[1]
    dPdx = torch.cat([dPdx[:1], dPdx], dim=0)
    dPdy = torch.cat([dPdy[:, :1], dPdy], dim=1)
    Vx_c = 0.5 * (Vx[:-1, 1:-1] + Vx[1:, 1:-1])
    Vy_c = 0.5 * (Vy[1:-1, :-1] + Vy[1:-1, 1:])
    return alpha * (Vx_c * dPdx + Vy_c * dPdy)


def compute_shear_heating_3d(tau, tau_o, eps, material, dt, phase_ratios=None):
    """H_s at cell centers, 3D. ``tau``/``tau_o``/``eps`` are center
    6-tuples (xx, yy, zz, yz, xz, xy), the shear slots already averaged to
    the centers. H = τ:(ε − ε_el) with ε_el = ½·(τ − τ_o)/(G dt), clamped
    at 0."""
    G = get_shear_modulus(material, phase_ratios, like=tau[0])
    _Gdt = 1.0 / (G * dt)
    H = 0.0
    for k in range(6):
        e_el = 0.5 * (tau[k] - tau_o[k]) * _Gdt
        w = 1.0 if k < 3 else 2.0
        H = H + w * tau[k] * (eps[k] - e_el)
    return torch.clamp_min(H, 0.0)


def shear_components_to_centers_3d(yz, xz, xy):
    """Average the three edge shear families onto the cell centers."""
    yz_c = 0.25 * (yz[:, :-1, :-1] + yz[:, 1:, :-1] + yz[:, :-1, 1:] + yz[:, 1:, 1:])
    xz_c = 0.25 * (xz[:-1, :, :-1] + xz[1:, :, :-1] + xz[:-1, :, 1:] + xz[1:, :, 1:])
    xy_c = 0.25 * (xy[:-1, :-1, :] + xy[1:, :-1, :] + xy[:-1, 1:, :] + xy[1:, 1:, :])
    return yz_c, xz_c, xy_c
