"""The 2D pseudo-transient thermal diffusion chunk: Hopper CUDA kernel, its
plain PyTorch version, and the host-side precompute they share.

Counterpart of ``justrelax_tpu/ops/pallas_thermal.py`` (the TPU kernel
``thermal_chunk_vmem``). One call advances ``nout`` iterations of
``heatdiffusion_PT``'s array path for constant-coefficient (K, ρCp) fields:
flux relaxation on every face → damped implicit T update with the source
H_tot + adiabatic·T → ghost BCs (constant_value, no_flux).

- ``thermal_chunk`` is the wrapper. On CUDA tensors it launches the kernel
  of ``csrc/thermal.cu`` (built with ``nvcc`` at first use by
  ``ops/_cuda_build.py`` and loaded with ``ctypes``) or raises; on CPU
  tensors it runs the plain version. ``thermal_chunk.launches`` counts
  kernel launches (one per chunk).
- ``thermal_chunk_reference`` is the plain version: the array-path
  iteration ``compute_flux → update_T → thermal_bcs`` ``nout`` times.
- ``_thermal_prepare`` builds the chunk-invariant stacks once per chunk, on
  the device, in plain PyTorch: the face averages of θr_dτ and K, and the
  cell terms the array path derives from its inputs every iteration
  (Told·ρCp·inv_dt and 1 + dτ_ρ·ρCp·inv_dt). So the kernel keeps the array
  path's operation order rather than B5's coefficient form
  ``(T − cA·∇·q + cAd·T + cB)·inv_den``, which regroups the sums.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from justrelax_tpu_torch.ops._cuda_build import CSRC, load_library
from justrelax_tpu_torch.ops.bc import THERMAL_FACE_ORDER, Faces, thermal_bcs
from justrelax_tpu_torch.ops.thermal import compute_flux, face_average_x, face_average_y, update_T

__all__ = [
    "thermal_chunk_unsupported",
    "thermal_chunk_supported",
    "thermal_chunk",
    "thermal_chunk_reference",
]

# Invariant-stack slot orders; csrc/thermal.cu's CSlot/FSlot enums match.
CELL_SLOTS = ("dtau_rho", "Told_rhoCp_dt", "H_tot", "den")
FACE_SLOTS = ("theta", "K")
# BC recipe codes, one per (pass, face) in thermal_bcs order
_CONSTANT_VALUE, _NO_FLUX = 1, 2

SOURCE = CSRC / "thermal.cu"


def thermal_chunk_unsupported(bcs, geometry=None, K=None, rho_Cp=None, material=None,
                              dirichlet=None, halo_exchange=None):
    """Why the chunk kernel does not cover a ``heatdiffusion_PT``
    configuration, or ``None`` if it does. The kernel needs the K/ρCp tensor
    path (a material re-evaluates ρ(T)·Cp and k every iteration), no
    Dirichlet mask, a uniform serial grid, and constant_value / no_flux BCs
    only. An adiabatic term is covered."""
    if K is None or rho_Cp is None or material is not None:
        return "needs K and rho_Cp tensors, not a material"
    if dirichlet is not None:
        return "does not take a Dirichlet mask"
    if geometry is not None and hasattr(geometry, "inv_flux_di"):
        return "needs a uniform grid"
    if halo_exchange is not None:
        return "runs on one device (no halo exchange)"
    if not thermal_chunk_supported(bcs):
        return "supports constant_value and no_flux BCs only (no constant_flux or periodic)"
    return None


def thermal_chunk_supported(bcs) -> bool:
    """Whether the kernel takes the boundary conditions ``bcs``: no
    constant_flux and no periodic faces."""
    return not (bcs.constant_flux.any() or bcs.periodic.any())


def _bc_recipe(bcs):
    """(codes, values): one code per pass and face in ``thermal_bcs`` order
    (constant_value over bot, top, left, right, then no_flux over the same)
    and the four constant values (bot, top, left, right)."""
    codes, values = [], []
    for name, _, _ in THERMAL_FACE_ORDER:
        v = getattr(bcs.constant_value, name)
        codes.append(_CONSTANT_VALUE if Faces.active(v) else 0)
        values.append(float(v) if Faces.active(v) else 0.0)
    for name, _, _ in THERMAL_FACE_ORDER:
        codes.append(_NO_FLUX if Faces.on(getattr(bcs.no_flux, name)) else 0)
    return codes, values


def _thermal_prepare(Told, K, rho_Cp, H_tot, dtau_rho, theta_r_dtau, inv_dt, dtype):
    """Chunk-invariant stacks, contiguous, in ``dtype``: cells
    (len(CELL_SLOTS), nx, ny), x-faces (len(FACE_SLOTS), nx+1, ny) and
    y-faces (len(FACE_SLOTS), nx, ny+1). Each slot is computed as the array
    path computes it (``ops/thermal.py::compute_flux``, ``update_T``)."""
    nx, ny = Told.shape[0] - 2, Told.shape[1] - 2
    dev = Told.device
    cells = {
        "dtau_rho": dtau_rho,
        "Told_rhoCp_dt": Told[1:-1, 1:-1] * rho_Cp * inv_dt,
        "H_tot": H_tot,
        "den": 1.0 + dtau_rho * rho_Cp * inv_dt,
    }
    fx = {"theta": face_average_x(theta_r_dtau), "K": face_average_x(K)}
    fy = {"theta": face_average_y(theta_r_dtau), "K": face_average_y(K)}

    def stack(d, names, shape):
        return torch.stack([
            torch.as_tensor(d[k], dtype=dtype, device=dev).expand(shape) for k in names
        ]).contiguous()

    return (stack(cells, CELL_SLOTS, (nx, ny)), stack(fx, FACE_SLOTS, (nx + 1, ny)),
            stack(fy, FACE_SLOTS, (nx, ny + 1)))


def thermal_chunk_reference(
    T, qx, qy, Told, K, rho_Cp, H_tot, dtau_rho, theta_r_dtau,
    inv_dt, inv_dx, inv_dy, bcs, adiabatic=None, nout: int = 100,
):
    """Plain version of :func:`thermal_chunk`: ``nout`` iterations of
    ``heatdiffusion_PT``'s array path (``compute_flux`` → ``update_T`` →
    ``thermal_bcs``) with the source ``H_tot`` (+ ``adiabatic``·T)."""
    inv_di = (inv_dx, inv_dy)
    q = (qx, qy)
    for _ in range(int(nout)):
        q, _ = compute_flux(q, q, T, inv_di, theta_r_dtau, bcs.constant_flux, K=K)
        T = update_T(T, Told, q, H_tot, 0.0, inv_dt, inv_di, dtau_rho, rho_Cp=rho_Cp,
                     adiabatic=adiabatic)
        T = thermal_bcs(T, bcs)
    return T, q[0], q[1]


def thermal_chunk(
    T, qx, qy, Told, K, rho_Cp, H_tot, dtau_rho, theta_r_dtau,
    inv_dt, inv_dx, inv_dy, bcs, adiabatic=None, nout: int = 100,
):
    """Advance ``nout`` PT diffusion iterations; returns ``(T, qx, qy)`` in
    the solver's shapes: T and Told ghosted (nx+2, ny+2), qx (nx+1, ny), qy
    (nx, ny+1), the cell fields (nx, ny). ``H_tot`` is the full source
    (H + shear heating); ``adiabatic`` (or ``None``) adds adiabatic·T.
    ``nout=0`` returns the inputs unchanged."""
    if int(nout) == 0:
        return T, qx, qy
    args = (T, qx, qy, Told, K, rho_Cp, H_tot, dtau_rho, theta_r_dtau,
            inv_dt, inv_dx, inv_dy, bcs)
    if T.device.type == "cpu":
        return thermal_chunk_reference(*args, adiabatic=adiabatic, nout=nout)
    if T.device.type != "cuda":
        raise ValueError(f"thermal_chunk: unsupported device {T.device}")
    if not thermal_chunk_supported(bcs):
        raise ValueError("thermal_chunk: supports constant_value and no_flux BCs only")
    nx, ny = T.shape[0] - 2, T.shape[1] - 2
    dtype = T.dtype
    _check_inputs(T, qx, qy, Told, (K, rho_Cp, H_tot, dtau_rho, theta_r_dtau, adiabatic),
                  nx, ny)
    cinv, fxinv, fyinv = _thermal_prepare(Told, K, rho_Cp, H_tot, dtau_rho, theta_r_dtau,
                                          inv_dt, dtype)
    ad = None if adiabatic is None else adiabatic.contiguous()

    outs = [t.clone() for t in (T, qx, qy)]
    codes, values = _bc_recipe(bcs)
    scal = (ctypes.c_double * 6)(inv_dx, inv_dy, *(2.0 * v for v in values))
    lib = _library()
    fn = lib.jr_thermal_chunk_f32 if dtype == torch.float32 else lib.jr_thermal_chunk_f64
    with torch.cuda.device(T.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn((ctypes.c_void_p * 3)(*[t.data_ptr() for t in outs]),
                 cinv.data_ptr(), fxinv.data_ptr(), fyinv.data_ptr(),
                 None if ad is None else ad.data_ptr(), nx, ny, int(nout), scal,
                 (ctypes.c_int * 8)(*codes), stream)
    if err != 0:
        raise RuntimeError(
            f"thermal_chunk: CUDA error {err}: {lib.jr_cuda_error_string(err).decode()}")
    thermal_chunk.launches += 1
    return tuple(outs)


thermal_chunk.launches = 0


def _check_inputs(T, qx, qy, Told, cell_fields, nx, ny):
    dtype = T.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"thermal_chunk: dtype {dtype} is not float32/float64")
    if T.ndim != 2 or nx < 2 or ny < 2:
        raise ValueError(f"thermal_chunk: T {tuple(T.shape)} is not a ghosted 2D grid "
                         "of at least 2x2 cells")
    carry = (("T", T, (nx + 2, ny + 2)), ("qx", qx, (nx + 1, ny)), ("qy", qy, (nx, ny + 1)),
             ("Told", Told, (nx + 2, ny + 2)))
    cells = tuple((f"cell field {k}", t, (nx, ny)) for k, t in enumerate(cell_fields)
                  if t is not None)
    for name, t, shape in carry + cells:
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"thermal_chunk: {name} is not a tensor")
        if t.device != T.device or t.dtype != dtype:
            raise ValueError(f"thermal_chunk: {name} is {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"thermal_chunk: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    for name, t, _ in carry[:3]:
        if not t.is_contiguous():
            raise ValueError(f"thermal_chunk: {name} is not contiguous")


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library(SOURCE)
    vp, i = ctypes.c_void_p, ctypes.c_int
    for name in ("jr_thermal_chunk_f32", "jr_thermal_chunk_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(vp), vp, vp, vp, vp, i, i, i,
                       ctypes.POINTER(ctypes.c_double), ctypes.POINTER(i), vp]
        fn.restype = i
    return lib
