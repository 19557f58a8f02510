"""Pseudo-transient thermal diffusion sweeps (2D and 3D).

Counterpart of ``justrelax_tpu/ops/thermal.py``. Shapes (2D): T ghosted
``(nx+2, ny+2)``, fluxes on faces qTx ``(nx+1, ny)`` / qTy ``(nx, ny+1)``,
coefficients and sources at centers ``(nx, ny)``; in 3D every field gains
a z axis and qTz ``(nx, ny, nz+1)`` joins.

The PT flux relaxation is

    q_new = (q_old·θ + q_physical) / (1 + θ),  θ = face-averaged θr_dτ

and the temperature update the damped implicit form

    T ← (dτ_ρ·(−∇·q + Told·ρCp/dt + H_tot) + T) / (1 + dτ_ρ·ρCp/dt)

with H_tot = (H + shear heating [+ radiogenic]) + adiabatic·T. Material
properties are either center tensors (``K``, ``rho_Cp``) or evaluated from a
material (``rheology/materials.py``) at the current temperature.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from justrelax_tpu_torch.core.grid import spacing_tensors
from justrelax_tpu_torch.ops.bc import Faces
from justrelax_tpu_torch.ops.stencil import interior_set
from justrelax_tpu_torch.rheology import materials as mat

Tensor = torch.Tensor

__all__ = [
    "thermal_spacings",
    "compute_flux",
    "update_T",
    "check_res",
    "face_average_x",
    "face_average_y",
    "face_average_z",
]


def thermal_spacings(geometry, like):
    """``(inv_flux_di, inv_div_di)``: the reciprocal spacings of the face
    gradients and of the cell divergences. On a uniform grid both are the
    scalar ``1/di``; on a ``NonuniformGeometry`` they are
    ``core/grid.py::spacing_tensors``."""
    tensors = spacing_tensors(geometry, like)
    if tensors is None:
        inv_di = tuple(1.0 / d for d in geometry.di)
        return inv_di, inv_di
    return tensors


def _pad_edge(A, axis):
    """``A`` with its first and last slices along ``axis`` repeated once."""
    n = A.shape[axis]
    return torch.cat([A.narrow(axis, 0, 1), A, A.narrow(axis, n - 1, 1)], dim=axis)


def face_average_x(C):
    """Center field → x-faces incl. boundary faces, edge-clamped (nx+1, ny)."""
    Cp = _pad_edge(C, 0)
    return 0.5 * (Cp[:-1, ...] + Cp[1:, ...])


def face_average_y(C):
    """Center field → y-faces incl. boundary faces, edge-clamped (nx, ny+1[, nz])."""
    Cp = _pad_edge(C, 1)
    return 0.5 * (Cp[:, :-1, ...] + Cp[:, 1:, ...])


def face_average_z(C):
    """Center field → z-faces incl. boundary faces, edge-clamped (nx, ny, nz+1)."""
    Cp = _pad_edge(C, 2)
    return 0.5 * (Cp[:, :, :-1] + Cp[:, :, 1:])


_FACE_AVERAGE = (face_average_x, face_average_y, face_average_z)


def _shifted(T, axis, lo):
    """The interior of the ghosted ``T`` shifted along ``axis``: the
    ``[:-1]`` (``lo``) or ``[1:]`` slice there, ``[1:-1]`` on the others."""
    return T[tuple((slice(None, -1) if lo else slice(1, None)) if a == axis
                   else slice(1, -1) for a in range(T.ndim))]


def _grad_T(T, inv_di):
    """Temperature gradients on the faces from the ghosted T: (nx+1, ny),
    (nx, ny+1)[, (nx, ny, nz+1)]."""
    return tuple((_shifted(T, a, False) - _shifted(T, a, True)) * inv_di[a]
                 for a in range(T.ndim))


def _face_T(T):
    """Face temperature: the average of the two straddling centers."""
    return tuple(0.5 * (_shifted(T, a, True) + _shifted(T, a, False)) for a in range(T.ndim))


def _face_conductivities(T, P, material, phase_ratios_faces):
    """Per-face conductivity: the mean of the two straddling center
    evaluations, both at the face temperature; with face phase ratios, one
    evaluation at the face (face temperature, side-averaged pressure)."""
    Ks = []
    for axis, Tf in enumerate(_face_T(T)):
        Pp = _pad_edge(P, axis)
        n = Pp.shape[axis]
        lo, hi = Pp.narrow(axis, 0, n - 1), Pp.narrow(axis, 1, n - 1)
        pr = None if phase_ratios_faces is None else phase_ratios_faces[axis]
        if pr is None:
            K1 = mat.compute_conductivity(material, T=Tf, P=lo)
            K2 = mat.compute_conductivity(material, T=Tf, P=hi)
            Ks.append(0.5 * (K1 + K2))
        else:
            Pf = 0.5 * (lo + hi)
            Ks.append(mat.compute_conductivity(material, T=Tf, P=Pf, phase_ratios=pr))
    return tuple(Ks)


def _apply_constant_flux(q, axis_faces: Tuple[str, str], bc_flux: Faces, q_axis: int):
    """``q`` with its first/last face slice along ``q_axis`` set to the
    constant_flux values of the two faces, where active."""
    lo, hi = (getattr(bc_flux, f) for f in axis_faces)
    if not (Faces.active(lo) or Faces.active(hi)):
        return q
    q = q.clone()
    if Faces.active(lo):
        q.narrow(q_axis, 0, 1).fill_(lo)
    if Faces.active(hi):
        q.narrow(q_axis, q.shape[q_axis] - 1, 1).fill_(hi)
    return q


_FACE_NAMES_2D = (("left", "right"), ("bot", "top"))
_FACE_NAMES_3D = (("left", "right"), ("front", "back"), ("bot", "top"))


def compute_flux(
    q: Tuple[Tensor, ...],
    q2: Tuple[Tensor, ...],
    T: Tensor,
    inv_di: Tuple[float, ...],
    theta_r_dtau: Tensor,
    bc_flux: Faces,
    K: Optional[Tensor] = None,
    material=None,
    P: Optional[Tensor] = None,
    phase_ratios_faces=None,
):
    """One PT flux relaxation sweep; returns ``(q_new, q2_new)``, q2 being
    the un-relaxed physical flux. Either ``K`` (center conductivity) or
    ``material`` (with ``P`` and optional face phase ratios) is given."""
    ndim = T.ndim
    names = _FACE_NAMES_2D if ndim == 2 else _FACE_NAMES_3D
    grads = _grad_T(T, inv_di)
    if K is not None:
        Kf = tuple(_FACE_AVERAGE[a](K) for a in range(ndim))
    else:
        Kf = _face_conductivities(T, P, material, phase_ratios_faces)
    q_new, q2_new = [], []
    for a in range(ndim):
        theta = _FACE_AVERAGE[a](theta_r_dtau)
        qa_phys = -Kf[a] * grads[a]
        qa = (q[a] * theta + qa_phys) / (1.0 + theta)
        q_new.append(_apply_constant_flux(qa, names[a], bc_flux, a))
        q2_new.append(_apply_constant_flux(qa_phys, names[a], bc_flux, a))
    return tuple(q_new), tuple(q2_new)


def _div(q, inv_di):
    """∇·q at the cell centers, the axes summed in order."""
    out = None
    for a, qa in enumerate(q):
        n = qa.shape[a]
        term = (qa.narrow(a, 1, n - 1) - qa.narrow(a, 0, n - 1)) * inv_di[a]
        out = term if out is None else out + term
    return out


def _interior(T):
    return T[(slice(1, -1),) * T.ndim]


def _total_source(material, phase_ratios, H, shear_heating, adiabatic, T_in):
    src = H + shear_heating
    if material is not None:
        src = src + mat.compute_radioactive_heating(material, phase_ratios, like=H)
    if adiabatic is not None:
        src = src + adiabatic * T_in
    return src


def update_T(
    T: Tensor,
    Told: Tensor,
    q: Tuple[Tensor, ...],
    H: Tensor,
    shear_heating: Tensor,
    inv_dt: float,
    inv_di: Tuple[float, ...],
    dtau_rho: Tensor,
    rho_Cp: Optional[Tensor] = None,
    material=None,
    P: Optional[Tensor] = None,
    phase_ratios: Optional[Tensor] = None,
    adiabatic: Optional[Tensor] = None,
    dirichlet=None,
):
    """Damped PT temperature update; returns the new ghosted T (ghosts as
    they were). ``dirichlet = (mask, value)`` pins the cells where the bool
    mask is set."""
    T_in = _interior(T)
    Told_in = _interior(Told)
    if rho_Cp is None:
        rho_Cp = mat.compute_rhoCp(material, T=T_in, P=P, phase_ratios=phase_ratios)
    divq = _div(q, inv_di)
    src = _total_source(material, phase_ratios, H, shear_heating, adiabatic, T_in)
    num = dtau_rho * (-divq + Told_in * rho_Cp * inv_dt + src) + T_in
    den = 1.0 + dtau_rho * rho_Cp * inv_dt
    T_new_in = num / den
    if dirichlet is not None:
        mask, value = dirichlet
        T_new_in = torch.where(mask, value, T_new_in)
    return interior_set(T, T_new_in)


def check_res(
    T: Tensor,
    Told: Tensor,
    q2: Tuple[Tensor, ...],
    H: Tensor,
    shear_heating: Tensor,
    inv_dt: float,
    inv_di: Tuple[float, ...],
    rho_Cp: Optional[Tensor] = None,
    material=None,
    P: Optional[Tensor] = None,
    phase_ratios: Optional[Tensor] = None,
    adiabatic: Optional[Tensor] = None,
    dirichlet=None,
):
    """Physical residual of the heat equation at the cell centers (0 where
    the bool Dirichlet mask is set)."""
    T_in = _interior(T)
    Told_in = _interior(Told)
    if rho_Cp is None:
        rho_Cp = mat.compute_rhoCp(material, T=T_in, P=P, phase_ratios=phase_ratios)
    divq2 = _div(q2, inv_di)
    src = _total_source(material, phase_ratios, H, shear_heating, adiabatic, T_in)
    res = -rho_Cp * (T_in - Told_in) * inv_dt - divq2 + src
    if dirichlet is not None:
        mask, _ = dirichlet
        res = torch.where(mask, 0.0, res)
    return res
