"""The fused 2D multi-phase VEP pseudo-transient chunk: Hopper CUDA kernel,
its plain PyTorch version, and the host-side precompute they share.

Counterpart of ``justrelax_tpu/ops/pallas_stokes_vep.py`` (the TPU kernels
``stokes_vep_chunk_vmem`` and ``stokes_vep_chunk_blocked``). One call
advances ``nout`` VEP PT iterations: maxloc preconditioner, compressible
pressure, Drucker-Prager return mapping at centers and vertices (relaxed λ,
optional tension cap), viscosity continuation (linear, or the collapsed power
law ``1/η = A + B·τII^m``), damped velocity update and per-side free-slip /
no-slip BCs.

- ``stokes_vep_chunk`` is the wrapper. On CUDA tensors it launches the
  kernel of ``csrc/stokes_vep.cu`` (built with ``nvcc`` at first use by
  ``ops/_cuda_build.py`` and loaded with ``ctypes``) or raises; on
  CPU tensors it runs the plain version. ``stokes_vep_chunk.launches``
  counts its calls that launch the kernel (one launch per PT iteration,
  ``nout`` per call).
- ``stokes_vep_chunk_reference`` is the plain version: the solver's
  array-path iteration (``ops/stokes_vep.py::vep_iteration``) ``nout``
  times.
- ``_vep_prepare`` builds the chunk-invariant cell and vertex stacks once per
  chunk, on the device, in plain PyTorch; the kernel gets them packed, the
  uniform slots as scalars (``ops/slots.py``). ``vep_chunk_words`` counts
  the words per cell an iteration must move on given inputs.

The arrays keep the solver's staggered shapes (Vx (nx+1, ny+2), Vy
(nx+2, ny+1), cells (nx, ny), vertices (nx+1, ny+1)); the kernel works on
them directly, with clamped indices in place of the TPU kernel's ghost
rings, and alternates two work sets of them, so the input carry is never
written.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from justrelax_tpu_torch.ops._cuda_build import CSRC, load_library
from justrelax_tpu_torch.ops.bc import Faces, VelocityBoundaryConditions
from justrelax_tpu_torch.ops.slots import pack_slots
from justrelax_tpu_torch.ops.stencil import av_a, expand_edges
from justrelax_tpu_torch.ops.stokes_vep import (
    VEPCarry,
    linear_viscosity_tables,
    rho_g_fields,
    vep_invariants,
    vep_iteration,
)
from justrelax_tpu_torch.rheology.materials import (
    _as_stack,
    get_bulk_modulus,
    get_shear_modulus,
)
from justrelax_tpu_torch.rheology.plasticity import plastic_params_phase
from justrelax_tpu_torch.rheology.viscosity import (
    _is_linear_creep,
    phase_viscosity,
    powerlaw_recip_coeffs,
    shared_powerlaw_exponent,
)

__all__ = [
    "vep_chunk_bc_modes",
    "vep_chunk_supported",
    "vep_chunk_words",
    "stokes_vep_chunk",
    "stokes_vep_chunk_reference",
]

# Invariant-stack slot order; csrc/stokes_vep.cu's CSlot/VSlot enums match.
# "visc_a"/"visc_b" hold the linear continuation target (visc_b unused) or
# the power-law coefficients A and B.
CINV_SLOTS = ("P0_Kdt", "Qdt", "txx_o", "tyy_o", "txy_c_o", "Gdt", "Kdt_inv",
              "Kdt0", "visc_a", "visc_b", "is_pl", "scale", "Ccos", "sinphi",
              "sinpsi", "etareg", "pT", "rho_gx", "rho_gy")
VINV_SLOTS = ("txx_ov", "tyy_ov", "txy_v_o", "Gdt", "Kdt0", "visc_a", "visc_b",
              "is_pl", "scale", "Ccos", "sinphi", "sinpsi", "etareg", "pT")
_BC_BITS = {"left": 1, "right": 2, "bot": 4, "top": 8}

SOURCE = CSRC / "stokes_vep.cu"


def vep_chunk_bc_modes(flow_bc):
    """Per-side BC modes (left, right, bot, top), or ``None`` if any face is
    not exactly one of free-slip / no-slip."""
    modes = []
    for face in ("left", "right", "bot", "top"):
        fs = getattr(flow_bc.free_slip, face) is True
        ns = getattr(flow_bc.no_slip, face) is True
        if fs == ns:
            return None
        modes.append("no_slip" if ns else "free_slip")
    return tuple(modes)


def vep_chunk_supported(material, geometry, flow_bc, free_surface, like=None) -> bool:
    """Whether the chunk kernel covers a configuration: linear creep or a
    collapsible tau-mode power law, solve-invariant density (beta == 0),
    the consistent ∂Q/∂τ convention (dqdtau_alt == 0), a uniform grid, each
    face free-slip or no-slip, no free-surface term. A bare material is
    stacked as ``like``."""
    material = _as_stack(material, like)
    m = material.params
    creep_ok = _is_linear_creep(material) or shared_powerlaw_exponent(material) is not None
    const_rho = not bool((m.beta != 0).any())
    consistent_dq = not bool((m.dqdtau_alt != 0).any())
    return (
        creep_ok and const_rho and consistent_dq and not free_surface
        and not hasattr(geometry, "di_center")
        and vep_chunk_bc_modes(flow_bc) is not None
    )


def _resolve_static(material, has_cap, visc_m, like=None):
    """Resolve the kernel's specialisations from the material table (a bare
    material is stacked as ``like``)."""
    material = _as_stack(material, like)
    if visc_m == "auto":
        linear = _is_linear_creep(material)
        visc_m = None if linear else shared_powerlaw_exponent(material)
        if not linear and visc_m is None:
            raise ValueError(
                "material creep table does not collapse to a shared-exponent "
                "power law (see shared_powerlaw_exponent)"
            )
    if has_cap is None:
        has_cap = bool((material.params.tension_pT != 0).any())
    return bool(has_cap), visc_m


def _vep_prepare(theta, P0, Q, txx_o, tyy_o, txy_c_o, txy_v_o, EII_pl,
                 material, phase_ratios_center, phase_ratios_vertex, T, T_v,
                 dt, visc_m, dtype):
    """Chunk-invariant cell stack (len(CINV_SLOTS), nx, ny) and vertex stack
    (len(VINV_SLOTS), nx+1, ny+1), contiguous, in ``dtype``. The buoyancy
    ρ(T)·g is solve-invariant: T is frozen during a solve and the supported
    materials have beta == 0, so the entry pressure ``theta`` fixes it."""
    nx, ny = P0.shape
    dev = P0.device
    material = _as_stack(material, P0).to(device=dev, dtype=dtype)
    dt = float(dt)
    pr_c, pr_v = phase_ratios_center, phase_ratios_vertex

    K_c = get_bulk_modulus(material, pr_c)
    G_c = get_shear_modulus(material, pr_c)
    K_v = get_bulk_modulus(material, pr_v)
    G_v = get_shear_modulus(material, pr_v)
    inv_dt = 0.0 if math.isinf(dt) else 1.0 / dt

    def finite_Kdt(K):
        return torch.where(torch.isinf(K), 0.0, K * dt)

    EII = EII_pl.expand(nx, ny)
    ppc = plastic_params_phase(material, EII, pr_c)
    ppv = plastic_params_phase(material, av_a(expand_edges(EII)), pr_v)

    ones_c = torch.ones((nx, ny), dtype=dtype, device=dev)
    ones_v = torch.ones((nx + 1, ny + 1), dtype=dtype, device=dev)
    if visc_m is None:
        visc_c = (phase_viscosity(material, ones_c, T, pr_c, "tau"), torch.zeros_like(ones_c))
        visc_v = (phase_viscosity(material, ones_v, T_v, pr_v, "tau"), torch.zeros_like(ones_v))
    else:
        visc_c = powerlaw_recip_coeffs(material, ones_c, T, pr_c)
        visc_v = powerlaw_recip_coeffs(material, ones_v, T_v, pr_v)
    rho_gx, rho_gy = rho_g_fields(material, T, theta, pr_c)

    def flag(b):
        return torch.where(b, 1.0, 0.0).to(dtype)

    cells = {
        "P0_Kdt": P0 * (1.0 / (K_c * dt)), "Qdt": Q * inv_dt,
        "txx_o": txx_o, "tyy_o": tyy_o, "txy_c_o": txy_c_o,
        "Gdt": 1.0 / (G_c * dt), "Kdt_inv": 1.0 / (K_c * dt),
        "Kdt0": finite_Kdt(K_c), "visc_a": visc_c[0], "visc_b": visc_c[1],
        "is_pl": flag(ppc.is_pl), "scale": ppc.pl_frac * 0.5,
        "Ccos": ppc.C_cosphi, "sinphi": ppc.sinphi, "sinpsi": ppc.sinpsi,
        "etareg": ppc.eta_reg, "pT": ppc.pT, "rho_gx": rho_gx, "rho_gy": rho_gy,
    }
    verts = {
        "txx_ov": av_a(expand_edges(txx_o)), "tyy_ov": av_a(expand_edges(tyy_o)),
        "txy_v_o": txy_v_o, "Gdt": 1.0 / (G_v * dt), "Kdt0": finite_Kdt(K_v),
        "visc_a": visc_v[0], "visc_b": visc_v[1],
        "is_pl": flag(ppv.is_pl), "scale": ppv.pl_frac * 0.5,
        "Ccos": ppv.C_cosphi, "sinphi": ppv.sinphi, "sinpsi": ppv.sinpsi,
        "etareg": ppv.eta_reg, "pT": ppv.pT,
    }

    def stack(d, names, shape):
        return torch.stack([
            torch.as_tensor(d[k], dtype=dtype, device=dev).expand(shape)
            for k in names
        ]).contiguous()

    return (stack(cells, CINV_SLOTS, (nx, ny)),
            stack(verts, VINV_SLOTS, (nx + 1, ny + 1)))


def _invariant_slots(theta, P0, Q, txx_o, tyy_o, txy_c_o, txy_v_o, EII_pl,
                     material, phase_ratios_center, phase_ratios_vertex, T, T_v,
                     dt, visc_m):
    """``_vep_prepare``'s cell and vertex stacks, packed: the uniform slots
    go in as scalars (``ops/slots.py``)."""
    cinv, vinv = _vep_prepare(theta, P0, Q, txx_o, tyy_o, txy_c_o, txy_v_o, EII_pl,
                              material, phase_ratios_center, phase_ratios_vertex,
                              T, T_v, dt, visc_m, theta.dtype)
    return pack_slots(cinv), pack_slots(vinv)


def vep_chunk_words(
    Vx, Vy, theta, P_c, txx, tyy, txy_c, txy_v, eta, eta_v, lam, lam_v,
    P0, Q, txx_o, tyy_o, txy_c_o, txy_v_o, EII_pl,
    material, phase_ratios_center, phase_ratios_vertex, T,
    dt, inv_dx, inv_dy, r, theta_dtau, etadtau,
    rel_lambda, viscosity_relaxation, viscosity_cutoff,
    nout: int = 100, has_cap=None, flow_bc=None, T_v=None, visc_m="auto",
):
    """Words per cell that one iteration of :func:`stokes_vep_chunk` must
    move on these inputs (its arguments): the 11 carried fields it reads
    (P is write-only), the 12 it writes, and each invariant slot that does
    not hold one value everywhere (the kernel takes the others as scalars).
    bench_kernels.py::vep2d counts 39, every slot a canvas."""
    _, visc_m = _resolve_static(material, has_cap, visc_m, like=theta)
    pc, pv = _invariant_slots(theta, P0, Q, txx_o, tyy_o, txy_c_o, txy_v_o, EII_pl,
                              material, phase_ratios_center, phase_ratios_vertex,
                              T, T_v, dt, visc_m)
    return 23 + pc.stack.shape[0] + pv.stack.shape[0]


def _default_bc():
    return VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True))


def stokes_vep_chunk_reference(
    Vx, Vy, theta, P_c, txx, tyy, txy_c, txy_v, eta, eta_v, lam, lam_v,
    P0, Q, txx_o, tyy_o, txy_c_o, txy_v_o, EII_pl,
    material, phase_ratios_center, phase_ratios_vertex, T,
    dt, inv_dx, inv_dy, r, theta_dtau, etadtau,
    rel_lambda, viscosity_relaxation, viscosity_cutoff,
    nout: int = 100, flow_bc=None, T_v=None,
):
    """Plain version of :func:`stokes_vep_chunk`: ``nout`` array-path
    iterations (the kernel's ``has_cap``/``visc_m`` specialisations do not
    change the result)."""
    flow_bc = _default_bc() if flow_bc is None else flow_bc
    c = VEPCarry(Vx, Vy, theta, P_c, txx, tyy, txy_c, txy_v, eta, eta_v, lam, lam_v)
    inv = vep_invariants(txx_o, tyy_o, txy_c_o, txy_v_o, EII_pl, material,
                         phase_ratios_center, phase_ratios_vertex)
    eta_tables = None
    if _is_linear_creep(material, eta):
        eta_tables = linear_viscosity_tables(
            material, phase_ratios_center, phase_ratios_vertex, T, T_v, eta, eta_v)
    for _ in range(int(nout)):
        c, _, _ = vep_iteration(
            c, inv, P0, Q, material, phase_ratios_center, phase_ratios_vertex,
            T, T_v, dt, inv_dx, inv_dy, r, theta_dtau, etadtau,
            rel_lambda, viscosity_relaxation, viscosity_cutoff, flow_bc,
            eta_tables=eta_tables,
        )
    return tuple(c)


def stokes_vep_chunk(
    Vx, Vy, theta, P_c, txx, tyy, txy_c, txy_v, eta, eta_v, lam, lam_v,
    P0, Q, txx_o, tyy_o, txy_c_o, txy_v_o, EII_pl,
    material, phase_ratios_center, phase_ratios_vertex, T,
    dt, inv_dx, inv_dy, r, theta_dtau, etadtau,
    rel_lambda, viscosity_relaxation, viscosity_cutoff,
    nout: int = 100, has_cap=None, flow_bc=None, T_v=None, visc_m="auto",
):
    """Advance ``nout`` fused VEP PT iterations; returns the 12 carried
    fields (Vx, Vy, θ, P, τxx, τyy, τxy_c, τxy_v, η, ηv, λ, λv) in the
    solver's shapes. ``nout=0`` returns the inputs unchanged.

    ``has_cap`` (tension cap) and ``visc_m`` (``None`` for linear creep, the
    shared exponent ``n − 1`` for the collapsed power law) specialise the
    kernel; ``None``/``"auto"`` derive them from the material. ``flow_bc``
    is per-side free-slip/no-slip (``None`` means all free-slip)."""
    carry = (Vx, Vy, theta, P_c, txx, tyy, txy_c, txy_v, eta, eta_v, lam, lam_v)
    args = carry + (P0, Q, txx_o, tyy_o, txy_c_o, txy_v_o, EII_pl,
                    material, phase_ratios_center, phase_ratios_vertex, T,
                    dt, inv_dx, inv_dy, r, theta_dtau, etadtau,
                    rel_lambda, viscosity_relaxation, viscosity_cutoff)
    if int(nout) == 0:
        return carry
    if theta.device.type == "cpu":
        return stokes_vep_chunk_reference(*args, nout=nout, flow_bc=flow_bc, T_v=T_v)
    if theta.device.type != "cuda":
        raise ValueError(f"stokes_vep_chunk: unsupported device {theta.device}")

    with torch.cuda.device(theta.device):
        out = _launch(_library(), torch.cuda.current_stream().cuda_stream, args, nout,
                      has_cap, flow_bc, T_v, visc_m)
    stokes_vep_chunk.launches += 1
    return out


def _launch(lib, stream, args, nout, has_cap, flow_bc, T_v, visc_m):
    """Check the chunk's arguments, pack its slots and run the C function of
    ``lib`` (bound by ``_bind``) on ``stream``; returns the 12 carried
    fields. Raises on what the kernel does not take and on a launch error."""
    (Vx, Vy, theta, P_c, txx, tyy, txy_c, txy_v, eta, eta_v, lam, lam_v,
     P0, Q, txx_o, tyy_o, txy_c_o, txy_v_o, EII_pl,
     material, phase_ratios_center, phase_ratios_vertex, T,
     dt, inv_dx, inv_dy, r, theta_dtau, etadtau,
     rel_lambda, viscosity_relaxation, viscosity_cutoff) = args
    carry = args[:12]
    nx, ny = theta.shape
    dtype = theta.dtype
    _check_carry(carry, nx, ny)
    bc_modes = ("free_slip",) * 4 if flow_bc is None else vep_chunk_bc_modes(flow_bc)
    if bc_modes is None:
        raise ValueError("each face must be exactly one of free-slip / no-slip")
    has_cap, visc_m = _resolve_static(material, has_cap, visc_m, like=theta)
    pc, pv = _invariant_slots(theta, P0, Q, txx_o, tyy_o, txy_c_o, txy_v_o, EII_pl,
                              material, phase_ratios_center, phase_ratios_vertex,
                              T, T_v, dt, visc_m)

    work = [[torch.empty_like(t) for t in carry] for _ in range(2)]
    lo, hi = viscosity_cutoff
    scal = (ctypes.c_double * 12)(
        inv_dx, inv_dy, etadtau, r / theta_dtau, theta_dtau,
        rel_lambda, 1.0 - rel_lambda,
        viscosity_relaxation, 1.0 - viscosity_relaxation,
        lo, hi, 0.0 if visc_m is None else visc_m,
    )
    bc_bits = sum(_BC_BITS[f] for f, m in zip(("left", "right", "bot", "top"), bc_modes)
                  if m == "no_slip")

    def ptrs(ts):
        return (ctypes.c_void_p * 12)(*[t.data_ptr() for t in ts])

    fn = lib.jr_stokes_vep_chunk_f32 if dtype == torch.float32 else lib.jr_stokes_vep_chunk_f64
    err = fn(
        ptrs(carry), ptrs(work[0]), ptrs(work[1]),
        pc.stack.data_ptr(), pv.stack.data_ptr(),
        (ctypes.c_int * len(CINV_SLOTS))(*pc.index),
        (ctypes.c_double * len(CINV_SLOTS))(*pc.values),
        (ctypes.c_int * len(VINV_SLOTS))(*pv.index),
        (ctypes.c_double * len(VINV_SLOTS))(*pv.values),
        nx, ny, int(nout), scal, 0 if visc_m is None else 1, int(has_cap),
        bc_bits, stream,
    )
    if err != 0:
        raise RuntimeError(
            f"stokes_vep_chunk: CUDA error {err}: "
            f"{lib.jr_cuda_error_string(err).decode()}")
    return tuple(work[(int(nout) - 1) % 2])


stokes_vep_chunk.launches = 0


def _check_carry(carry, nx, ny):
    dtype = carry[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"stokes_vep_chunk: dtype {dtype} is not float32/float64")
    if nx < 2 or ny < 2:
        raise ValueError(f"stokes_vep_chunk: grid {nx}x{ny} is smaller than 2x2")
    c, v = (nx, ny), (nx + 1, ny + 1)
    shapes = ((nx + 1, ny + 2), (nx + 2, ny + 1), c, c, c, c, c, v, c, v, c, v)
    for k, (t, shape) in enumerate(zip(carry, shapes)):
        if t.device != carry[2].device or t.dtype != dtype:
            raise ValueError(f"stokes_vep_chunk: field {k} is {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"stokes_vep_chunk: field {k} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"stokes_vep_chunk: field {k} is not contiguous")


@functools.lru_cache(maxsize=None)
def _library():
    return _bind(load_library(SOURCE))


def _bind(lib):
    """``lib`` with the C functions of ``csrc/stokes_vep.cu`` typed."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    for name in ("jr_stokes_vep_chunk_f32", "jr_stokes_vep_chunk_f64"):
        fn = getattr(lib, name)
        ip, dp = ctypes.POINTER(i), ctypes.POINTER(ctypes.c_double)
        fn.argtypes = [ctypes.POINTER(vp)] * 3 + [vp, vp, ip, dp, ip, dp, i, i, i, dp,
                                                  i, i, i, vp]
        fn.restype = i
    return lib
