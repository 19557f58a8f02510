"""The 2D visco-elastic (VE) compressible pseudo-transient chunk: Hopper CUDA
kernel, its plain PyTorch version, and the host-side precompute they share.

Counterpart of ``justrelax_tpu/ops/pallas_stokes.py`` (the TPU kernels
``stokes_chunk_vmem`` and ``stokes_chunk_blocked``). One call advances
``nout`` iterations of ``solve_ve``'s array path: divergence → compressible
VE pressure → strain rate → VE stress (cells and interior vertices) → damped
velocity update → free-slip ghosts.

- ``stokes_chunk`` is the wrapper. On CUDA tensors it launches the kernel of
  ``csrc/stokes_ve.cu`` (built with ``nvcc`` at first use by
  ``ops/_cuda_build.py`` and loaded with ``ctypes``) or raises; on CPU
  tensors it runs the plain version. ``stokes_chunk.launches`` counts its
  calls that launch the kernel (one launch per PT iteration, ``nout`` per
  call; two alternating work sets, so the input carry is never written).
- ``stokes_chunk_reference`` is the plain version: the array-path iteration
  ``nout`` times.
- ``_ve_prepare`` builds the chunk-invariant cell and vertex stacks once per
  chunk, on the device, in plain PyTorch. They hold the quantities the array
  path computes every iteration from its inputs (1/(K dt), 1/(G dt), Q/dt and
  the vertex averages of η and G), so the kernel keeps the array path's
  operation order rather than B1's coefficient form (c1, c2, c3, a, b, d).
  The kernel gets them packed (``ops/slots.py``: uniform slots as scalars),
  and derives ``eta_v`` and ``eta_tau`` from ``eta`` where that gives the
  stack's own values. ``ve_chunk_words`` counts the words per cell an
  iteration must move on given inputs.

The TPU kernels' VMEM residency switch (``VMEM_BUDGET``,
``vmem_bytes_needed``, ``choose_blocking``) has no counterpart: on the card
``use_kernel=True`` and ``"blocked"`` reach this one kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from justrelax_tpu_torch.ops._cuda_build import CSRC, load_library
from justrelax_tpu_torch.ops.bc import Faces, VelocityBoundaryConditions
from justrelax_tpu_torch.ops.slots import derive_slots, pack_slots
from justrelax_tpu_torch.ops.stencil import av_a, maxloc
from justrelax_tpu_torch.ops.stokes import ve_iteration

__all__ = [
    "ve_chunk_unsupported",
    "ve_chunk_supported",
    "ve_chunk_words",
    "stokes_chunk",
    "stokes_chunk_reference",
]

# Invariant-stack slot order; csrc/stokes_ve.cu's CSlot/VSlot enums match.
CELL_SLOTS = ("eta", "eta_tau", "Gdt", "Kdt", "P0", "Qdt", "txx_o", "tyy_o",
              "rho_gx", "rho_gy")
VERTEX_SLOTS = ("eta_v", "Gdt_v", "txy_o")

SOURCE = CSRC / "stokes_ve.cu"

_FREE_SLIP = VelocityBoundaryConditions(
    free_slip=Faces(left=True, right=True, top=True, bot=True))


def ve_chunk_unsupported(geometry, flow_bc, free_surface=False,
                         halo_exchange=None, alpha_dT=None):
    """Why the chunk kernel does not cover a ``solve_ve`` configuration, or
    ``None`` if it does. The kernel needs a uniform serial grid, no free
    surface, no ``alpha_dT`` source and free-slip on all four faces."""
    fs, ns = flow_bc.free_slip, flow_bc.no_slip
    if hasattr(geometry, "di_center"):
        return "needs a uniform grid"
    if free_surface or halo_exchange is not None or alpha_dT is not None:
        return "supports the serial path without free surface or alpha_dT only"
    if not all(Faces.on(v) for v in (fs.left, fs.right, fs.top, fs.bot)) or any(
        v is not False and v is not None for v in (ns.left, ns.right, ns.top, ns.bot)
    ):
        return "supports all-free-slip BCs only"
    return None


def ve_chunk_supported(geometry, flow_bc, free_surface=False, halo_exchange=None,
                       alpha_dT=None) -> bool:
    """Whether the chunk kernel covers a ``solve_ve`` configuration (see
    :func:`ve_chunk_unsupported`)."""
    return ve_chunk_unsupported(geometry, flow_bc, free_surface, halo_exchange,
                                alpha_dT) is None


def _ve_inputs(P, txy, G, K, P0, Q, tau_o, dt):
    """B1's optional physics with its defaults: G = K = ∞, P0 = Q = τ_o = 0,
    dt = ∞ (the viscous incompressible limit)."""
    full = functools.partial(torch.full_like, P)
    G = full(math.inf) if G is None else G
    K = full(math.inf) if K is None else K
    P0 = torch.zeros_like(P) if P0 is None else P0
    Q = torch.zeros_like(P) if Q is None else Q
    if tau_o is None:
        tau_o = (torch.zeros_like(P), torch.zeros_like(P), torch.zeros_like(txy))
    dt = math.inf if dt is None else float(dt)
    return G, K, P0, Q, tuple(tau_o), dt


def _ve_prepare(eta, eta_tau, rho_gx, rho_gy, G, K, P0, Q, tau_o, dt, dtype):
    """Chunk-invariant cell stack (len(CELL_SLOTS), nx, ny) and vertex stack
    (len(VERTEX_SLOTS), nx+1, ny+1; η and 1/(G dt) are set on the interior
    vertices only), contiguous, in ``dtype``. Each slot is computed as the
    array path computes it (``ops/stokes.py::compute_P``,
    ``compute_tau_ve``)."""
    nx, ny = eta.shape
    dev = eta.device
    txx_o, tyy_o, txy_o = tau_o
    cells = {
        "eta": eta, "eta_tau": eta_tau, "Gdt": 1.0 / (G * dt),
        "Kdt": 1.0 / (K * dt), "P0": P0, "Qdt": Q * (1.0 / dt),
        "txx_o": txx_o, "tyy_o": tyy_o, "rho_gx": rho_gx, "rho_gy": rho_gy,
    }
    pad = functools.partial(torch.nn.functional.pad, pad=(1, 1, 1, 1))
    verts = {
        "eta_v": pad(av_a(eta)), "Gdt_v": pad(1.0 / (av_a(G) * dt)),
        "txy_o": txy_o,
    }

    def stack(d, names, shape):
        return torch.stack([
            torch.as_tensor(d[k], dtype=dtype, device=dev).expand(shape)
            for k in names
        ]).contiguous()

    return (stack(cells, CELL_SLOTS, (nx, ny)),
            stack(verts, VERTEX_SLOTS, (nx + 1, ny + 1)))


def _invariant_slots(P, txy, eta, eta_tau, rho_gx, rho_gy, G, K, P0, Q, tau_o, dt):
    """``_ve_prepare``'s stacks in the dtype of ``P``, packed (``ops/slots.py``:
    uniform slots as scalars), with ``eta_tau`` and ``eta_v`` marked
    ``DERIVED`` where the kernel computes them from ``eta`` bit for bit: the
    ``eta_v`` slot is always ``av_a(eta)`` on the interior vertices (the
    only ones read), and ``eta_tau`` is derived when it equals
    ``maxloc(eta, 1)``. Both are checked on the stacks with one host read."""
    G, K, P0, Q, tau_o, dt = _ve_inputs(P, txy, G, K, P0, Q, tau_o, dt)
    cinv, vinv = _ve_prepare(eta, eta_tau, rho_gx, rho_gy, G, K, P0, Q, tau_o, dt, P.dtype)
    e, et, ev = cinv[CELL_SLOTS.index("eta")], cinv[CELL_SLOTS.index("eta_tau")], vinv[0]
    same_et, same_ev = torch.stack([
        (et == maxloc(e, 1)).all(), (ev[1:-1, 1:-1] == av_a(e)).all()]).tolist()
    pc, pv = pack_slots(cinv), pack_slots(vinv)
    pc = derive_slots(pc, [CELL_SLOTS.index("eta_tau")] if same_et else [])
    pv = derive_slots(pv, [VERTEX_SLOTS.index("eta_v")] if same_ev else [])
    return pc, pv


def ve_chunk_words(
    Vx, Vy, P, txx, tyy, txy, eta, eta_tau, rho_gx, rho_gy,
    inv_dx, inv_dy, r, theta_dtau, etadtau, nout: int = 100,
    free_slip: bool = True, G=None, K=None, P0=None, Q=None, tau_o=None,
    dt=None,
):
    """Words per cell that one iteration of :func:`stokes_chunk` must move on
    these inputs (its arguments): the 6 unknowns read and written, and each
    invariant slot that varies and that the kernel does not derive from η
    (``eta_tau``, ``eta_v``). bench_kernels.py::ve2d counts 23."""
    pc, pv = _invariant_slots(P, txy, eta, eta_tau, rho_gx, rho_gy, G, K, P0, Q, tau_o, dt)
    return 12 + pc.stack.shape[0] + pv.stack.shape[0]


def stokes_chunk_reference(
    Vx, Vy, P, txx, tyy, txy, eta, eta_tau, rho_gx, rho_gy,
    inv_dx, inv_dy, r, theta_dtau, etadtau, nout: int = 100,
    free_slip: bool = True, G=None, K=None, P0=None, Q=None, tau_o=None,
    dt=None,
):
    """Plain version of :func:`stokes_chunk`: ``nout`` iterations of
    ``solve_ve``'s array path (``ops/stokes.py::ve_iteration``:
    compute_grad_V → compute_P → compute_strain_rate → compute_tau_ve →
    compute_V → flow_bcs)."""
    G, K, P0, Q, tau_o, dt = _ve_inputs(P, txy, G, K, P0, Q, tau_o, dt)
    c = (Vx, Vy, P, txx, tyy, txy)
    for _ in range(int(nout)):
        c = ve_iteration(*c, eta, eta_tau, rho_gx, rho_gy, G, K, P0, Q, tau_o, dt,
                         inv_dx, inv_dy, r, theta_dtau, etadtau,
                         flow_bc=_FREE_SLIP if free_slip else None)
    return c


def stokes_chunk(
    Vx, Vy, P, txx, tyy, txy, eta, eta_tau, rho_gx, rho_gy,
    inv_dx, inv_dy, r, theta_dtau, etadtau, nout: int = 100,
    free_slip: bool = True, G=None, K=None, P0=None, Q=None, tau_o=None,
    dt=None,
):
    """Advance ``nout`` VE PT iterations; returns the six carried fields
    (Vx, Vy, P, τxx, τyy, τxy) in the solver's shapes. ``nout=0`` returns the
    inputs unchanged.

    The arguments are B1's: ``G``/``K`` (cell moduli, ∞ allowed), ``P0``/``Q``
    (pressure sources), ``tau_o`` ((τxx_o, τyy_o, τxy_o), the elastic memory)
    and ``dt``; any of them may be ``None`` (the viscous incompressible
    limit). ``free_slip`` mirrors the tangential ghosts after each
    iteration."""
    carry = (Vx, Vy, P, txx, tyy, txy)
    if int(nout) == 0:
        return carry
    args = carry + (eta, eta_tau, rho_gx, rho_gy, inv_dx, inv_dy, r, theta_dtau, etadtau)
    if P.device.type == "cpu":
        return stokes_chunk_reference(*args, nout=nout, free_slip=free_slip, G=G, K=K,
                                      P0=P0, Q=Q, tau_o=tau_o, dt=dt)
    if P.device.type != "cuda":
        raise ValueError(f"stokes_chunk: unsupported device {P.device}")

    with torch.cuda.device(P.device):
        out = _launch(_library(), torch.cuda.current_stream().cuda_stream, args, nout,
                      free_slip, G, K, P0, Q, tau_o, dt)
    stokes_chunk.launches += 1
    return out


def _launch(lib, stream, args, nout, free_slip, G, K, P0, Q, tau_o, dt):
    """Check the chunk's arguments, pack its slots and run the C function of
    ``lib`` (bound by ``_bind``) on ``stream``; returns the six carried
    fields. Raises on what the kernel does not take and on a launch error."""
    (Vx, Vy, P, txx, tyy, txy, eta, eta_tau, rho_gx, rho_gy,
     inv_dx, inv_dy, r, theta_dtau, etadtau) = args
    carry = args[:6]
    nx, ny = P.shape
    dtype = P.dtype
    _check_carry(carry, nx, ny)
    pc, pv = _invariant_slots(P, txy, eta, eta_tau, rho_gx, rho_gy, G, K, P0, Q, tau_o, dt)

    work = [[torch.empty_like(t) for t in carry] for _ in range(2)]
    scal = (ctypes.c_double * 5)(inv_dx, inv_dy, r / theta_dtau, theta_dtau, etadtau)

    def ptrs(ts):
        return (ctypes.c_void_p * 6)(*[t.data_ptr() for t in ts])

    fn = lib.jr_stokes_ve_chunk_f32 if dtype == torch.float32 else lib.jr_stokes_ve_chunk_f64
    err = fn(ptrs(carry), ptrs(work[0]), ptrs(work[1]),
             pc.stack.data_ptr(), pv.stack.data_ptr(),
             (ctypes.c_int * len(CELL_SLOTS))(*pc.index),
             (ctypes.c_double * len(CELL_SLOTS))(*pc.values),
             (ctypes.c_int * len(VERTEX_SLOTS))(*pv.index),
             (ctypes.c_double * len(VERTEX_SLOTS))(*pv.values),
             nx, ny, int(nout), scal, int(bool(free_slip)), stream)
    if err != 0:
        raise RuntimeError(
            f"stokes_chunk: CUDA error {err}: {lib.jr_cuda_error_string(err).decode()}")
    return tuple(work[(int(nout) - 1) % 2])


stokes_chunk.launches = 0


def _check_carry(carry, nx, ny):
    dtype = carry[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"stokes_chunk: dtype {dtype} is not float32/float64")
    if nx < 2 or ny < 2:
        raise ValueError(f"stokes_chunk: grid {nx}x{ny} is smaller than 2x2")
    c = (nx, ny)
    shapes = ((nx + 1, ny + 2), (nx + 2, ny + 1), c, c, c, (nx + 1, ny + 1))
    for k, (t, shape) in enumerate(zip(carry, shapes)):
        if t.device != carry[2].device or t.dtype != dtype:
            raise ValueError(f"stokes_chunk: field {k} is {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"stokes_chunk: field {k} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"stokes_chunk: field {k} is not contiguous")


@functools.lru_cache(maxsize=None)
def _library():
    return _bind(load_library(SOURCE))


def _bind(lib):
    """``lib`` with the C functions of ``csrc/stokes_ve.cu`` typed."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    for name in ("jr_stokes_ve_chunk_f32", "jr_stokes_ve_chunk_f64"):
        fn = getattr(lib, name)
        ip, dp = ctypes.POINTER(i), ctypes.POINTER(ctypes.c_double)
        fn.argtypes = [ctypes.POINTER(vp)] * 3 + [vp, vp, ip, dp, ip, dp, i, i, i, dp,
                                                  i, vp]
        fn.restype = i
    return lib
