"""The bytes one 2D VEP pseudo-transient iteration must move, counted from
the inputs of the solve it belongs to (frozen here, apart from any kernel's
own packing).

Per cell, in words of the run's precision: each of the 12 carried fields
(Vx, Vy, θ, P, τxx, τyy, τxy at centres and vertices, η at centres and
vertices, λ at centres and vertices) written once and, but for P, which the
iteration only writes, read once: 23. Then each solve-invariant input once,
where it is not one value everywhere and where it can change the result:
P0 and the bulk modulus only where some bulk modulus is finite; the old
stresses (τxx, τyy, τxy at centres and vertices) and the shear modulus
(centres, vertices) only where some shear modulus is finite; Q; the creep
viscosity (centres, vertices); the Drucker-Prager parameters (C·cosϕ,
sinϕ, sinψ, η_reg, the plastic share, at centres and vertices) only where
some node is plastic; the buoyancy ρg at centres. The vertex averages of
the old normal stresses are not counted: they follow from the centre ones.
EII_pl is read only through softening, which the configurations here do
not have.

This counts one iteration at a time. A kernel that fuses several
iterations on chip moves fewer bytes than this per iteration; before such a
kernel lands the convention must be revisited, or its share would pass the
roofline.
"""

from __future__ import annotations

import torch

CARRIED = 23


def _varies(t):
    t = torch.as_tensor(t)
    return bool(t.numel() > 1 and (t.max() != t.min()))


def _finite_any(t):
    return bool(torch.isfinite(torch.as_tensor(t)).any())


def words_per_cell(entry: dict, mat) -> int:
    """``entry``: the solve's entry fields (``P0``, ``Q``, ``txx_o``,
    ``tyy_o``, ``txy_c_o``, ``txy_v_o``); ``mat``: the reference's material
    fields of that solve (``perfbench.reference.vep2d.Fields``)."""
    words = CARRIED
    if _finite_any(mat.K_c) or _finite_any(mat.K_v):
        words += _varies(entry["P0"]) + _varies(mat.K_c) + _varies(mat.K_v)
    if _finite_any(mat.G_c) or _finite_any(mat.G_v):
        words += sum(_varies(entry[k]) for k in ("txx_o", "tyy_o", "txy_c_o", "txy_v_o"))
        words += _varies(mat.G_c) + _varies(mat.G_v)
    words += _varies(entry["Q"])
    words += _varies(mat.eta_c) + _varies(mat.eta_v)
    for pl in (mat.pl_c, mat.pl_v):
        if bool(pl["on"].any()):
            words += sum(_varies(pl[k]) for k in ("C_cosphi", "sinphi", "sinpsi", "eta_reg", "frac"))
    words += _varies(mat.rho_gy)
    return int(words)


def bytes_per_iteration(entry: dict, mat, n_cells: int, itemsize: int) -> int:
    return words_per_cell(entry, mat) * int(n_cells) * int(itemsize)
