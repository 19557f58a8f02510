"""Pseudo-transient thermal diffusion solver, 2D.

Counterpart of ``justrelax_tpu/solvers/thermal.py``. The PT loop runs in
chunks of ``nout`` iterations (flux relaxation → damped T update → ghost
BCs, ``ops/thermal.py``), then evaluates the residual norm
err = ‖ResT‖₂ / √(nx·ny); the host reads ``err`` once per chunk. The loop
runs while err > ϵ and fewer than ⌈iter_max / nout⌉ chunks have run (err
starts at 2ϵ, so one chunk always runs).

With ``use_kernel`` (the default for a state on the card) each chunk's first
``nout − 1`` iterations run in the Hopper chunk kernel
(``ops/hopper_thermal.py``) and its last one on the array path, which also
yields the un-relaxed flux q2 that the residual reads.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from justrelax_tpu_torch.core.device import resolve_use_kernel
from justrelax_tpu_torch.ops import thermal as kernels
from justrelax_tpu_torch.ops.bc import thermal_bcs
from justrelax_tpu_torch.ops.hopper_thermal import thermal_chunk, thermal_chunk_unsupported
from justrelax_tpu_torch.rheology.materials import _as_stack

__all__ = ["heatdiffusion_PT", "ThermalSolveInfo"]


class ThermalSolveInfo(NamedTuple):
    iters: Any  # total PT iterations executed
    err: Any  # final residual norm (a 0-d tensor)
    err_history: Any  # per-chunk residual norms, nan-padded


def heatdiffusion_PT(
    thermal,
    pt_thermal,
    thermal_bc,
    dt: float,
    geometry,
    K: Optional[torch.Tensor] = None,
    rho_Cp: Optional[torch.Tensor] = None,
    material=None,
    P: Optional[torch.Tensor] = None,
    phase_ratios: Optional[torch.Tensor] = None,
    phase_ratios_faces=None,
    dirichlet=None,
    iter_max: int = 50_000,
    nout: int = 1_000,
    halo_exchange=None,
    reduce_norm=None,
    use_kernel=None,
):
    """Solve one implicit time step of the heat equation with PT iterations.

    Pass ``K`` and ``rho_Cp`` center tensors, or a ``material`` (with ``P``
    and optional phase ratios; a bare ``Material`` is stacked once on the
    state's device and in its dtype). ``dirichlet = (mask, value)`` pins
    cells. Returns the updated :class:`ThermalState` (T, Told, dT, fluxes,
    ResT) and a :class:`ThermalSolveInfo`.

    ``use_kernel=True`` runs the chunks through
    ``ops/hopper_thermal.py::thermal_chunk``; the default ``None`` does so
    for a state on the card and runs the array path for one on the CPU;
    ``False`` asks for the array path. The kernel covers the K/ρCp path
    with constant_value / no_flux BCs (an adiabatic term included); asked
    for with a material, a Dirichlet mask, or constant_flux or periodic BCs
    it raises ``ValueError``. The distributed arguments (``halo_exchange``,
    ``reduce_norm``) and a nonuniform grid are not ported and raise
    ``NotImplementedError``.
    """
    if thermal.T.ndim != 2:
        raise NotImplementedError("the PyTorch port covers 2D grids only")
    if halo_exchange is not None or reduce_norm is not None:
        raise NotImplementedError(
            "halo_exchange/reduce_norm belong to the distributed layer, which "
            "the PyTorch port does not have yet")
    if hasattr(geometry, "inv_flux_di"):
        raise NotImplementedError(
            "heatdiffusion_PT on a nonuniform grid needs NonuniformGeometry, "
            "which the PyTorch port does not have yet")
    use_kernel = resolve_use_kernel(use_kernel, thermal.T)
    if use_kernel:
        reason = thermal_chunk_unsupported(thermal_bc, geometry, K, rho_Cp, material,
                                           dirichlet, halo_exchange)
        if reason is not None:
            raise ValueError(f"the thermal chunk kernel {reason}; pass use_kernel=False "
                             "for the plain path")
    if material is not None:
        material = _as_stack(material, thermal.T)

    inv_di = tuple(1.0 / d for d in geometry.di)
    inv_dt = 1.0 / dt
    nout = int(nout)
    max_chunks = max(1, int(math.ceil(iter_max / nout)))
    eps = pt_thermal.eps
    theta_r_dtau, dtau_rho = pt_thermal.theta_r_dtau, pt_thermal.dtau_rho
    Told, H, sh, adiabatic = thermal.T, thermal.H, thermal.shear_heating, thermal.adiabatic
    inv_sqrt_n = 1.0 / math.sqrt(float(H.numel()))
    cell_kw = dict(rho_Cp=rho_Cp, material=material, P=P, phase_ratios=phase_ratios,
                   adiabatic=adiabatic, dirichlet=dirichlet)

    def one_iteration(T, q, q2):
        q, q2 = kernels.compute_flux(q, q2, T, inv_di, theta_r_dtau, thermal_bc.constant_flux,
                                     K=K, material=material, P=P,
                                     phase_ratios_faces=phase_ratios_faces)
        T = kernels.update_T(T, Told, q, H, sh, inv_dt, inv_di, dtau_rho, **cell_kw)
        return thermal_bcs(T, thermal_bc), q, q2

    T, q, q2 = thermal.T, (thermal.qTx, thermal.qTy), (thermal.qTx2, thermal.qTy2)
    hist = torch.full((max_chunks,), math.nan, dtype=T.dtype, device=T.device)
    err, err_t, chunk = 2.0 * eps, None, 0
    while err > eps and chunk < max_chunks:
        if use_kernel:
            T, qx, qy = thermal_chunk(T, q[0], q[1], Told, K, rho_Cp, H + sh, dtau_rho,
                                      theta_r_dtau, inv_dt, inv_di[0], inv_di[1], thermal_bc,
                                      adiabatic=adiabatic, nout=nout - 1)
            q = (qx, qy)
        else:
            for _ in range(nout - 1):
                T, q, _ = one_iteration(T, q, q2)
        # the chunk's last iteration on the array path refreshes q2
        T, q, q2 = one_iteration(T, q, q2)
        res = kernels.check_res(T, Told, q2, H, sh, inv_dt, inv_di, **cell_kw)
        err_t = torch.linalg.vector_norm(res.reshape(-1)) * inv_sqrt_n
        hist[chunk] = err_t
        err = float(err_t)  # the one host read per chunk
        chunk += 1

    res = kernels.check_res(T, Told, q2, H, sh, inv_dt, inv_di, **cell_kw)
    new_thermal = thermal.replace(
        T=T, Told=Told, dT=T - Told, qTx=q[0], qTy=q[1], qTx2=q2[0], qTy2=q2[1], ResT=res)
    return new_thermal, ThermalSolveInfo(iters=chunk * nout, err=err_t, err_history=hist)
