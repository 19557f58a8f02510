"""The 3D visco-elastic (VE) compressible pseudo-transient chunk: Hopper CUDA
kernel, its plain PyTorch version, and the coefficient packing they share.

Counterpart of ``justrelax_tpu/ops/pallas_stokes3d_blocked.py`` (the TPU
kernel ``stokes3d_chunk_blocked``), with its contract: ``nout`` fused
iterations of ``ops/stokes3d_canvas.py::iteration3d_canvas`` on the 10
collocated canvases, the chunk-invariant coefficients given as a
``CanvasCoeffs3D`` or, on the ``viscous_consts`` route, derived from (η, ητ,
fx, fy, fz) and ``pt_scalars`` = (r/θ_dτ, θ_dτ, ηdτ).

- ``stokes3d_chunk`` is the wrapper. On CUDA tensors it launches the kernel
  of ``csrc/stokes3d_ve.cu`` (built with ``nvcc`` at first use by
  ``ops/_cuda_build.py`` and loaded with ``ctypes``) or raises; on CPU tensors
  it runs the plain version. ``stokes3d_chunk.launches`` counts kernel
  launches (one per chunk).
- ``stokes3d_chunk_reference`` is the plain version: ``iteration3d_canvas``
  ``nout`` times.
- ``pack_coeffs`` stacks the coefficient canvases once (a solve packs them
  once and passes the result to every chunk); a coefficient that is a scalar
  or absent, or a canvas that holds one value everywhere, takes no canvas.
- ``ve3d_chunk_unsupported`` is the guard of ``solve_ve_3d``'s kernel path.

On the ``viscous_consts`` route the coefficients are derived once per call in
PyTorch and the same kernel runs; deriving them inside the kernel is later
work. The TPU kernel's blocking knobs (``plane_block``, ``iters_per_pass``,
``pipeline``, ``y_block``, ``interpret``, the ``shift`` lowering) are not
ported: they chose VMEM windows that this card does not have.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from justrelax_tpu_torch.ops._cuda_build import CSRC, load_library
from justrelax_tpu_torch.ops.bc import Faces
from justrelax_tpu_torch.ops.stokes3d_canvas import (
    CanvasCoeffs3D,
    stokes3d_chunk_canvas,
    viscous_canvas_coefficients,
)

__all__ = [
    "COEF_NAMES",
    "PackedCoeffs3D",
    "pack_coeffs",
    "ve3d_chunk_unsupported",
    "stokes3d_chunk",
    "stokes3d_chunk_reference",
]

SOURCE = CSRC / "stokes3d_ve.cu"

# Coefficient order; csrc/stokes3d_ve.cu's Coef enum matches.
COEF_NAMES = ("c1", "c2", "c3", "a_c", "b_c", "d_c0", "d_c1", "d_c2",
              "a_e0", "a_e1", "a_e2", "b_e0", "b_e1", "b_e2", "d_e0", "d_e1", "d_e2",
              "inv_eta0", "inv_eta1", "inv_eta2", "f0", "f1", "f2")
_SCALAR, _ABSENT = -1, -2
# the value at which a term drops out of the iteration
_NEUTRAL = {"c1": 1.0, "c2": 0.0, **{f"d_{f}{i}": 0.0 for f in "ce" for i in range(3)}}
_N_CARRY = 10


class PackedCoeffs3D(NamedTuple):
    """A ``CanvasCoeffs3D`` ready for the kernel: its canvases stacked
    (n_canvas, X, Y, Z), and per coefficient of ``COEF_NAMES`` a slot (the
    canvas index, ``-1`` for a scalar, ``-2`` for absent) and a scalar
    value."""

    co: CanvasCoeffs3D
    stack: torch.Tensor
    slots: tuple
    values: tuple


def _named(co: CanvasCoeffs3D):
    def tup(v):
        return (None, None, None) if v is None else tuple(v)

    vals = [co.c1, co.c2, co.c3, co.a_c, co.b_c, *tup(co.d_c), *tup(co.a_e),
            *tup(co.b_e), *tup(co.d_e), *tup(co.inv_eta), *tup(co.f)]
    return zip(COEF_NAMES, vals)


def pack_coeffs(co: CanvasCoeffs3D, dtype=None) -> PackedCoeffs3D:
    """Stack the canvases of ``co`` (contiguous, in ``dtype``, by default
    that of ``co.c3``) and build the slot table. A canvas that holds one
    value everywhere goes in as that scalar, and as absent where the value
    changes nothing (``c1`` of 1; ``c2``, ``d_c`` and ``d_e`` of 0): the
    kernel computes the same values and reads fewer canvases. Where dt is ∞,
    12 of the general form's 23 canvases are such (c1 = 1, c2 = d = 0, and
    uniform decays a)."""
    if isinstance(co, PackedCoeffs3D):
        return co
    named = dict(_named(co))
    for name in ("c3", "b_c", "inv_eta0", "f0"):
        if not (isinstance(named[name], torch.Tensor) and named[name].ndim == 3):
            raise ValueError(f"pack_coeffs: {name} must be a canvas")
    dtype = co.c3.dtype if dtype is None else dtype
    grids = {k: v.to(dtype) for k, v in named.items()
             if isinstance(v, torch.Tensor) and v.ndim == 3}
    flat = [v.reshape(-1) for v in grids.values()]
    # one host read each: which canvases are uniform, and their values
    uniform = dict(zip(grids, torch.stack([(f == f[0]).all() for f in flat]).tolist()))
    first = dict(zip(grids, torch.stack([f[0] for f in flat]).tolist()))
    canvases, slots, values = [], [], []
    for name, v in named.items():
        if name in grids:
            if not uniform[name]:
                slots.append(len(canvases))
                canvases.append(grids[name])
                values.append(0.0)
                continue
            v = first[name]
        if v is None or float(v) == _NEUTRAL.get(name):
            slots.append(_ABSENT)
            values.append(0.0)
        else:
            slots.append(_SCALAR)
            values.append(float(v))
    shape = (0,) + tuple(co.c3.shape)
    stack = (torch.stack(canvases).contiguous() if canvases
             else torch.empty(shape, dtype=dtype, device=co.c3.device))
    return PackedCoeffs3D(co, stack, tuple(slots), tuple(values))


def ve3d_chunk_unsupported(geometry, flow_bc, mean_free_RP=False, boundary_shear=False,
                           alpha_dT=None):
    """Why the chunk kernel does not cover a ``solve_ve_3d`` configuration,
    or ``None`` if it does. The kernel needs a uniform grid, free slip on all
    six faces and no no-slip face, and none of ``mean_free_RP``,
    ``boundary_shear`` and ``alpha_dT``."""
    if hasattr(geometry, "di_center"):
        return "needs a uniform grid"
    if mean_free_RP or boundary_shear or alpha_dT is not None:
        return "supports the default residual/shear options only"
    fs = flow_bc.free_slip
    if not all(Faces.on(v) for v in (fs.left, fs.right, fs.top, fs.bot, fs.front, fs.back)) \
            or flow_bc.no_slip.any():
        return "supports all-free-slip BCs only"
    return None


def _coefficients(co, viscous_consts, pt_scalars):
    if viscous_consts is not None:
        if pt_scalars is None:
            raise ValueError("stokes3d_chunk: viscous_consts needs pt_scalars")
        return viscous_canvas_coefficients(viscous_consts, pt_scalars)
    if co is None:
        raise ValueError("stokes3d_chunk: give co or viscous_consts")
    return co


def stokes3d_chunk_reference(carry, co, inv_di, nout, free_slip=True,
                             viscous_consts=None, pt_scalars=None):
    """Plain version of :func:`stokes3d_chunk`: ``nout`` iterations of
    ``iteration3d_canvas``."""
    co = _coefficients(co, viscous_consts, pt_scalars)
    if isinstance(co, PackedCoeffs3D):
        co = co.co
    return stokes3d_chunk_canvas(tuple(carry), co, inv_di, nout, free_slip=free_slip)


def stokes3d_chunk(carry, co, inv_di, nout, free_slip=True, viscous_consts=None,
                   pt_scalars=None):
    """Advance ``nout`` fused 3D VE PT iterations; returns the 10 canvases.
    ``carry`` is the 10 canvases (``pack_carry`` unstacked, or its stacked
    tensor), ``co`` a ``CanvasCoeffs3D`` or its ``pack_coeffs`` result (or
    ``None`` on the ``viscous_consts`` route), ``inv_di`` the three inverse
    spacings. With ``free_slip`` the tangential ghosts mirror after each
    iteration. ``nout=0`` returns the inputs unchanged."""
    carry = tuple(carry)
    if len(carry) != _N_CARRY:
        raise ValueError(f"stokes3d_chunk: carry has {len(carry)} canvases, not 10")
    if int(nout) == 0:
        return carry
    co = _coefficients(co, viscous_consts, pt_scalars)
    P = carry[3]
    if P.device.type == "cpu":
        return stokes3d_chunk_reference(carry, co, inv_di, nout, free_slip=free_slip)
    if P.device.type != "cuda":
        raise ValueError(f"stokes3d_chunk: unsupported device {P.device}")

    _check_carry(carry)
    packed = pack_coeffs(co, P.dtype)
    _check_coeffs(packed, P)
    X, Y, Z = P.shape
    buf = torch.stack(carry)
    slots = (ctypes.c_int * len(COEF_NAMES))(*packed.slots)
    vals = (ctypes.c_double * len(COEF_NAMES))(*packed.values)
    inv = (ctypes.c_double * 3)(*(float(v) for v in inv_di))
    lib = _library()
    fn = lib.jr_stokes3d_ve_chunk_f32 if P.dtype == torch.float32 else lib.jr_stokes3d_ve_chunk_f64
    with torch.cuda.device(P.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(buf.data_ptr(), packed.stack.data_ptr(), slots, vals, X - 2, Y - 2, Z - 2,
                 int(nout), inv, int(bool(free_slip)), stream)
    if err != 0:
        raise RuntimeError(
            f"stokes3d_chunk: CUDA error {err}: {lib.jr_cuda_error_string(err).decode()}")
    stokes3d_chunk.launches += 1
    return tuple(buf.unbind(0))


stokes3d_chunk.launches = 0


def _check_carry(carry):
    P = carry[3]
    if P.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"stokes3d_chunk: dtype {P.dtype} is not float32/float64")
    if P.ndim != 3 or min(P.shape) < 3:
        raise ValueError(f"stokes3d_chunk: canvas shape {tuple(P.shape)} is not "
                         "(nx+2, ny+2, nz+2) with nx, ny, nz >= 1")
    for k, t in enumerate(carry):
        if t.device != P.device or t.dtype != P.dtype:
            raise ValueError(f"stokes3d_chunk: canvas {k} is {t.dtype} on {t.device}")
        if t.shape != P.shape:
            raise ValueError(f"stokes3d_chunk: canvas {k} has shape {tuple(t.shape)}, "
                             f"expected {tuple(P.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"stokes3d_chunk: canvas {k} is not contiguous")


def _check_coeffs(packed, P):
    s = packed.stack
    if s.device != P.device or s.dtype != P.dtype:
        raise ValueError(f"stokes3d_chunk: coefficients are {s.dtype} on {s.device}")
    if s.shape[1:] != P.shape or not s.is_contiguous():
        raise ValueError(f"stokes3d_chunk: coefficient stack {tuple(s.shape)} is not a "
                         f"contiguous stack of {tuple(P.shape)} canvases")
    if len(packed.slots) != len(COEF_NAMES) or max(packed.slots) >= s.shape[0]:
        raise ValueError("stokes3d_chunk: the coefficient slot table does not match "
                         "its stack")


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library(SOURCE)
    vp, i = ctypes.c_void_p, ctypes.c_int
    for name in ("jr_stokes3d_ve_chunk_f32", "jr_stokes3d_ve_chunk_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, ctypes.POINTER(i), ctypes.POINTER(ctypes.c_double),
                       i, i, i, i, ctypes.POINTER(ctypes.c_double), i, vp]
        fn.restype = i
    return lib
