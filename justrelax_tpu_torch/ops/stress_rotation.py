"""Elastic stress rotation (advection coupling).

Counterpart of ``justrelax_tpu/ops/stress_rotation.py``. The old deviatoric
stress τ_o co-rotates with the material between time steps:

- on the grid, the Jaumann update at cell centers
  τ ← τ + dt·(τ·ω − ω·τ) with ω the xy vorticity at the center;
- per particle, the finite rotation τ* = R τ Rᵀ by θ = ω·dt (a closed form
  in 2D, Euler–Rodrigues in 3D). The particle forms are plain array
  functions over any trailing particle shape.
"""

from __future__ import annotations

import torch

from justrelax_tpu_torch.ops.stencil import av_a

__all__ = [
    "rotate_stress_grid_2d",
    "rotate_stress_particles_2d",
    "rotate_stress_particles_3d",
    "compute_vorticity_center",
]


def compute_vorticity_center(Vx, Vy, inv_dx, inv_dy):
    """ω_xy = ½(∂Vy/∂x − ∂Vx/∂y) averaged to cell centers."""
    w_v = 0.5 * (
        (Vy[1:, :] - Vy[:-1, :]) * inv_dx - (Vx[:, 1:] - Vx[:, :-1]) * inv_dy
    )
    return av_a(w_v)


def rotate_stress_grid_2d(txx, tyy, txy_c, omega_c, dt):
    """Jaumann co-rotation of the center stress tensor by ω·dt."""
    dxx = -2.0 * omega_c * txy_c
    dyy = 2.0 * omega_c * txy_c
    dxy = omega_c * (txx - tyy)
    return txx + dt * dxx, tyy + dt * dyy, txy_c + dt * dxy


def rotate_stress_particles_2d(p_txx, p_tyy, p_txy, omega_p, dt):
    """Finite rotation of per-particle stress by θ = ω·dt."""
    theta = omega_p * dt
    c, s = torch.cos(theta), torch.sin(theta)
    # R τ Rᵀ for R = [[c, −s], [s, c]]
    xx = c * c * p_txx - 2 * c * s * p_txy + s * s * p_tyy
    yy = s * s * p_txx + 2 * c * s * p_txy + c * c * p_tyy
    xy = c * s * (p_txx - p_tyy) + (c * c - s * s) * p_txy
    return xx, yy, xy


def rotate_stress_particles_3d(
    p_txx, p_tyy, p_tzz, p_tyz, p_txz, p_txy,
    omega_yz, omega_xz, omega_xy, dt,
):
    """Euler–Rodrigues finite rotation of per-particle 3D stress.

    ``omega_ab = ½(∂V_a/∂x_b − ∂V_b/∂x_a)`` are the spin-tensor components
    (a pure ``omega_xy`` spin reduces exactly to
    :func:`rotate_stress_particles_2d`). The rotation vector is
    ``w = (ω_yz, −ω_xz, ω_xy)``, the angle θ = |w|·dt; τ' = R τ Rᵀ over the
    trailing particle axes."""
    wx, wy, wz = omega_yz, -omega_xz, omega_xy
    wmag = torch.sqrt(wx * wx + wy * wy + wz * wz)
    theta = wmag * dt
    safe = torch.where(wmag > 0.0, wmag, 1.0)
    nx_, ny_, nz_ = wx / safe, wy / safe, wz / safe
    c, s = torch.cos(theta), torch.sin(theta)
    one_c = 1.0 - c

    # R = I + sinθ [n]× + (1−cosθ)[n]×²  (3, 3, ...)
    R = torch.stack(
        [
            torch.stack([c + nx_ * nx_ * one_c, nx_ * ny_ * one_c - nz_ * s, nx_ * nz_ * one_c + ny_ * s]),
            torch.stack([ny_ * nx_ * one_c + nz_ * s, c + ny_ * ny_ * one_c, ny_ * nz_ * one_c - nx_ * s]),
            torch.stack([nz_ * nx_ * one_c - ny_ * s, nz_ * ny_ * one_c + nx_ * s, c + nz_ * nz_ * one_c]),
        ]
    )
    tau = torch.stack(
        [
            torch.stack([p_txx, p_txy, p_txz]),
            torch.stack([p_txy, p_tyy, p_tyz]),
            torch.stack([p_txz, p_tyz, p_tzz]),
        ]
    )
    taur = torch.einsum("ik...,kl...,jl...->ij...", R, tau, R)
    return (
        taur[0, 0], taur[1, 1], taur[2, 2],
        taur[1, 2], taur[0, 2], taur[0, 1],
    )
