"""Principal stresses at cell centers.

Counterpart of ``justrelax_tpu/ops/principal_stresses.py``. 2D: the closed
form of the 2×2 symmetric eigendecomposition, as eigenvalue-scaled
eigenvectors. 3D: a batched symmetric eigensolve of the 3×3 deviatoric
stress tensors, ordered σ1 ≥ σ2 ≥ σ3.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["principal_stresses_2d", "principal_stresses_3d"]


class PrincipalStress2D(NamedTuple):
    sigma1: torch.Tensor  # (2, nx, ny) eigenvalue-scaled eigenvector
    sigma2: torch.Tensor


class PrincipalStress3D(NamedTuple):
    sigma1: torch.Tensor  # (3, nx, ny, nz)
    sigma2: torch.Tensor
    sigma3: torch.Tensor


def principal_stresses_2d(txx, tyy, txy_c) -> PrincipalStress2D:
    a = 0.5 * (txx + tyy)
    b = torch.sqrt((txx - tyy) ** 2 / 2.0 + txy_c**2)
    s1 = a + b
    s2 = a - b
    theta = 0.5 * torch.atan2(2.0 * txy_c, txx - tyy)
    st, ct = torch.sin(theta), torch.cos(theta)
    sigma1 = torch.stack([s1 * ct, s1 * st])
    sigma2 = torch.stack([-s2 * st, s2 * ct])
    return PrincipalStress2D(sigma1=sigma1, sigma2=sigma2)


def principal_stresses_3d(txx, tyy, tzz, tyz_c, txz_c, txy_c) -> PrincipalStress3D:
    T = torch.stack(
        [
            torch.stack([txx, txy_c, txz_c], dim=-1),
            torch.stack([txy_c, tyy, tyz_c], dim=-1),
            torch.stack([txz_c, tyz_c, tzz], dim=-1),
        ],
        dim=-2,
    )  # (..., 3, 3)
    w, v = torch.linalg.eigh(T)  # ascending eigenvalues
    sig = []
    for k in (2, 1, 0):  # descending, σ1 ≥ σ2 ≥ σ3
        vec = v[..., :, k] * w[..., k][..., None]
        sig.append(torch.movedim(vec, -1, 0))
    return PrincipalStress3D(sigma1=sig[0], sigma2=sig[1], sigma3=sig[2])
