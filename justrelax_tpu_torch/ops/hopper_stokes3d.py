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
  it runs the plain version. ``stokes3d_chunk.launches`` counts its calls that
  launch the kernel (one launch per PT iteration, ``nout`` per call; two
  alternating work sets, so the input carry is never written).
- ``stokes3d_chunk_reference`` is the plain version: ``iteration3d_canvas``
  ``nout`` times.
- ``pack_coeffs`` stacks the coefficient canvases once (a solve packs them
  once and passes the result to every chunk); a coefficient that is a scalar
  or absent, or a canvas that holds one value everywhere, takes no canvas.
  Given the cell fields η and ητ (``derive_from``), it also finds which
  canvases the kernel can derive from them bit for bit
  (``derive_coefficients``, in the kernel's operation order), and
  ``kernel_slots`` marks those ``DERIVED``: on SolVi (dt = ∞) all 8 varying
  canvases, so the kernel reads η and ητ in their place.
- ``ve3d_chunk_unsupported`` is the guard of ``solve_ve_3d``'s kernel path.

The TPU kernel's blocking knobs (``plane_block``, ``iters_per_pass``,
``pipeline``, ``y_block``, ``interpret``, the ``shift`` lowering) are not
ported: they chose VMEM windows that this card does not have.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from justrelax_tpu_torch.ops._cuda_build import CSRC, load_library
from justrelax_tpu_torch.ops.bc import Faces
from justrelax_tpu_torch.ops.stencil import expand_edges
from justrelax_tpu_torch.ops.stokes3d_canvas import (
    _EDGE_AXES,
    CanvasCoeffs3D,
    _edge_avg,
    _sm1,
    stokes3d_chunk_canvas,
    viscous_canvas_coefficients,
)

__all__ = [
    "COEF_NAMES",
    "DERIVABLE",
    "DerivedCoeffs3D",
    "PackedCoeffs3D",
    "derive_coefficients",
    "kernel_slots",
    "pack_coeffs",
    "streamed_words",
    "ve3d_chunk_unsupported",
    "stokes3d_chunk",
    "stokes3d_chunk_reference",
]

SOURCE = CSRC / "stokes3d_ve.cu"

# Coefficient order; csrc/stokes3d_ve.cu's Coef enum matches.
COEF_NAMES = ("c1", "c2", "c3", "a_c", "b_c", "d_c0", "d_c1", "d_c2",
              "a_e0", "a_e1", "a_e2", "b_e0", "b_e1", "b_e2", "d_e0", "d_e1", "d_e2",
              "inv_eta0", "inv_eta1", "inv_eta2", "f0", "f1", "f2")
# The coefficients the kernel can derive from η and ητ
DERIVABLE = ("c3", "b_c", "b_e0", "b_e1", "b_e2", "inv_eta0", "inv_eta1", "inv_eta2")
_SCALAR, _ABSENT, DERIVED = -1, -2, -3
# c3's derivation (csrc/stokes3d_ve.cu): from ητ (else η), through 1/(1/src)
C3_FROM_ETAT, C3_DOUBLE_RCP = 1, 2
# the value at which a term drops out of the iteration
_NEUTRAL = {"c1": 1.0, "c2": 0.0, **{f"d_{f}{i}": 0.0 for f in "ce" for i in range(3)}}
_N_CARRY = 10
# (y, z) tile of one block (csrc/stokes3d_ve.cu Tile): (TY, TZ) interior points
_TILE = {torch.float32: (4, 64), torch.float64: (4, 32)}


class DerivedCoeffs3D(NamedTuple):
    """What the kernel derives: ``base`` the edge-padded η and ητ canvases
    stacked (2, X, Y, Z), ``names`` the coefficients derived from them,
    ``c3_mode`` (``C3_FROM_ETAT`` | ``C3_DOUBLE_RCP``) and ``scalars`` =
    (r/θ_dτ, dτ_r, ηdτ), each a value of the canvases' dtype."""

    base: torch.Tensor
    names: tuple
    c3_mode: int
    scalars: tuple


class PackedCoeffs3D(NamedTuple):
    """A ``CanvasCoeffs3D`` ready for the kernel: its canvases stacked
    (n_canvas, X, Y, Z), and per coefficient of ``COEF_NAMES`` a slot (the
    canvas index, ``-1`` for a scalar, ``-2`` for absent) and a scalar
    value; ``derived`` says which canvases the kernel derives in place of
    reading them (``None``: none)."""

    co: CanvasCoeffs3D
    stack: torch.Tensor
    slots: tuple
    values: tuple
    derived: Optional[DerivedCoeffs3D] = None


def _named(co: CanvasCoeffs3D):
    def tup(v):
        return (None, None, None) if v is None else tuple(v)

    vals = [co.c1, co.c2, co.c3, co.a_c, co.b_c, *tup(co.d_c), *tup(co.a_e),
            *tup(co.b_e), *tup(co.d_e), *tup(co.inv_eta), *tup(co.f)]
    return zip(COEF_NAMES, vals)


def derive_coefficients(base, c3_mode, scalars):
    """The derivable coefficients as the kernel computes them from ``base``
    (the edge-padded η and ητ canvases), in its operation order, one
    rounding per operation: c3 = src·r/θ_dτ or (1/(1/src))·r/θ_dτ, b =
    (2η)·dτ_r at cells and (2·the 4-point edge average of η)·dτ_r on the
    edges, inv_eta = (1/(½(ητ + ητ')))·ηdτ on the faces. The same
    expressions as ``ops/stokes3d_canvas.py`` (``1.0 / x`` is a reciprocal
    there too), so where the inputs agree the values are the canvases' own.
    Returns ``{name: canvas}`` for ``DERIVABLE``."""
    eta, etat = base[0], base[1]
    r_theta, dtau_r, etadtau = scalars
    src = etat if c3_mode & C3_FROM_ETAT else eta
    if c3_mode & C3_DOUBLE_RCP:
        src = 1.0 / (1.0 / src)
    out = {"c3": src * r_theta, "b_c": (2.0 * eta) * dtau_r}
    for i, ax in enumerate(_EDGE_AXES):
        out[f"b_e{i}"] = (2.0 * _edge_avg(eta, *ax)) * dtau_r
    for ax in range(3):
        out[f"inv_eta{ax}"] = (1.0 / (0.5 * (etat + _sm1(etat, ax)))) * etadtau
    return out


def _same_bits(a, b):
    """Whether two tensors of one dtype hold the same bits everywhere (a
    0-dim bool tensor)."""
    ints = {4: torch.int32, 8: torch.int64}[a.element_size()]
    return (a.contiguous().view(ints) == b.contiguous().view(ints)).all()


def _derivation(grids, slots, dtype, derive_from):
    """Which of the varying derivable canvases in ``grids`` the kernel
    computes bit for bit from η and ητ: each candidate form (c3 from η or
    ητ, with or without 1/(1/·); dτ_r rounded as the viscous form or as the
    general form with dt = ∞ gives it) is checked against the canvas, with
    one host read; ``None`` where nothing is derived."""
    todo = [n for n in DERIVABLE if slots[COEF_NAMES.index(n)] >= 0]
    if not todo:
        return None
    eta, eta_tau, (r_theta, theta_dtau, etadtau) = derive_from
    dev = grids["c3"].device
    base = torch.stack([expand_edges(eta.to(device=dev, dtype=dtype)),
                        expand_edges(eta_tau.to(device=dev, dtype=dtype))]).contiguous()

    def as_t(v):
        return float(torch.tensor(v, dtype=dtype))

    # dτ_r: 1/(θ_dτ + 1) in Python floats (the viscous form), or in the
    # canvases' dtype (the general form: θ_dτ + η/(G dt) + 1 with 1/(G dt) = 0)
    dr_general = float(1.0 / (torch.zeros((), dtype=dtype) + theta_dtau + 1.0))
    drs = (as_t(1.0 / (theta_dtau + 1.0)), dr_general)
    trials = []   # (name, c3_mode or dtau_r, flag)
    for mode in (0, C3_FROM_ETAT, C3_DOUBLE_RCP, C3_FROM_ETAT | C3_DOUBLE_RCP):
        if "c3" in todo:
            cand = derive_coefficients(base, mode, (r_theta, 0.0, etadtau))["c3"]
            trials.append(("c3", mode, _same_bits(cand, grids["c3"])))
    b_names = [n for n in todo if n.startswith("b_")]
    for dr in drs:
        if b_names:
            cand = derive_coefficients(base, 0, (r_theta, dr, etadtau))
            trials += [(n, dr, _same_bits(cand[n], grids[n])) for n in b_names]
    ie_names = [n for n in todo if n.startswith("inv_eta")]
    if ie_names:
        cand = derive_coefficients(base, 0, (r_theta, 0.0, etadtau))
        trials += [(n, None, _same_bits(cand[n], grids[n])) for n in ie_names]
    ok = torch.stack([t[2] for t in trials]).tolist()
    hits = [(n, v) for (n, v, _), o in zip(trials, ok) if o]
    names, c3_mode, dtau_r = [], 0, drs[0]
    modes = [v for n, v in hits if n == "c3"]
    if modes:
        names.append("c3")
        c3_mode = modes[0]
    by_dr = [[n for n, v in hits if n.startswith("b_") and v == dr] for dr in drs]
    best = max(range(len(drs)), key=lambda i: len(by_dr[i]))
    if by_dr[best]:
        names += by_dr[best]
        dtau_r = drs[best]
    names += [n for n, _ in hits if n.startswith("inv_eta")]
    if not names:
        return None
    names = tuple(n for n in DERIVABLE if n in names)
    return DerivedCoeffs3D(base, names, c3_mode, (as_t(r_theta), dtau_r, as_t(etadtau)))


def pack_coeffs(co: CanvasCoeffs3D, dtype=None, derive_from=None) -> PackedCoeffs3D:
    """Stack the canvases of ``co`` (contiguous, in ``dtype``, by default
    that of ``co.c3``) and build the slot table. A canvas that holds one
    value everywhere goes in as that scalar, and as absent where the value
    changes nothing (``c1`` of 1; ``c2``, ``d_c`` and ``d_e`` of 0): the
    kernel computes the same values and reads fewer canvases. Where dt is ∞,
    12 of the general form's 23 canvases are such (c1 = 1, c2 = d = 0, and
    uniform decays a).

    ``derive_from`` = (η, ητ, (r/θ_dτ, θ_dτ, ηdτ)), the cell fields and PT
    scalars ``co`` was built from, lets the kernel derive the varying
    canvases of ``DERIVABLE`` that it computes bit for bit from η and ητ
    (``PackedCoeffs3D.derived``; the stack keeps every canvas, for the plain
    version)."""
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
    derived = None if derive_from is None else _derivation(grids, slots, dtype, derive_from)
    return PackedCoeffs3D(co, stack, tuple(slots), tuple(values), derived)


def kernel_slots(packed: PackedCoeffs3D) -> tuple:
    """The slot table the kernel reads: ``packed.slots`` with the derived
    coefficients marked ``DERIVED`` (-3)."""
    names = () if packed.derived is None else packed.derived.names
    return tuple(DERIVED if n in names else s for n, s in zip(COEF_NAMES, packed.slots))


def _base_reads(packed):
    """(η read, ητ read): which base canvases the derived coefficients
    need."""
    d = packed.derived
    if d is None:
        return False, False
    c3_src = "c3" in d.names and (d.c3_mode & C3_FROM_ETAT)
    eta = any(n.startswith("b_") for n in d.names) or ("c3" in d.names and not c3_src)
    etat = any(n.startswith("inv_eta") for n in d.names) or bool(c3_src)
    return eta, etat


def streamed_words(packed: PackedCoeffs3D) -> int:
    """Words per canvas point one kernel iteration reads and writes: the 10
    unknowns both ways, the streamed coefficient canvases, and the η / ητ
    canvases the derived ones come from."""
    streamed = sum(s >= 0 for s in kernel_slots(packed))
    return 20 + streamed + sum(_base_reads(packed))


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
    """The coefficients, and what the kernel may derive them from (the
    ``viscous_consts`` route's η and ητ)."""
    if viscous_consts is not None:
        if pt_scalars is None:
            raise ValueError("stokes3d_chunk: viscous_consts needs pt_scalars")
        eta, eta_tau = viscous_consts[:2]
        return (viscous_canvas_coefficients(viscous_consts, pt_scalars),
                (eta, eta_tau, tuple(pt_scalars)))
    if co is None:
        raise ValueError("stokes3d_chunk: give co or viscous_consts")
    return co, None


def stokes3d_chunk_reference(carry, co, inv_di, nout, free_slip=True,
                             viscous_consts=None, pt_scalars=None):
    """Plain version of :func:`stokes3d_chunk`: ``nout`` iterations of
    ``iteration3d_canvas``."""
    co, _ = _coefficients(co, viscous_consts, pt_scalars)
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
    co, derive_from = _coefficients(co, viscous_consts, pt_scalars)
    P = carry[3]
    if P.device.type == "cpu":
        return stokes3d_chunk_reference(carry, co, inv_di, nout, free_slip=free_slip)
    if P.device.type != "cuda":
        raise ValueError(f"stokes3d_chunk: unsupported device {P.device}")
    with torch.cuda.device(P.device):
        out = _launch(_library(), torch.cuda.current_stream().cuda_stream, carry, co,
                      inv_di, nout, free_slip, derive_from)
    stokes3d_chunk.launches += 1
    return out


stokes3d_chunk.launches = 0


def _x_planes(nx, ny, nz, dtype, device):
    """Interior x planes per block: the x extent split into as many ranges
    as fill one wave of two blocks per SM (a block marches along its
    range; more ranges re-read more x halo planes)."""
    ty, tz = _TILE[dtype]
    tiles = math.ceil(ny / ty) * math.ceil(nz / tz)
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" else 4)
    ranges = max(1, min(nx, 2 * sms // tiles))
    return math.ceil(nx / ranges)


def _launch(lib, stream, carry, co, inv_di, nout, free_slip, derive_from=None,
            x_planes=None):
    """Check the chunk's arguments, pack its coefficients and run the C
    function of ``lib`` (bound by ``_bind``) on ``stream``; returns the 10
    canvases (views of one stacked work set). ``x_planes`` sets the
    interior x planes per block (default :func:`_x_planes`). Raises on what
    the kernel does not take and on a launch error."""
    _check_carry(carry)
    P = carry[3]
    packed = pack_coeffs(co, P.dtype, derive_from)
    _check_coeffs(packed, P)
    X, Y, Z = P.shape
    nx, ny, nz = X - 2, Y - 2, Z - 2
    work = [torch.empty((_N_CARRY,) + tuple(P.shape), dtype=P.dtype, device=P.device)
            for _ in range(2)]
    d = packed.derived
    base = d.base if d is not None else packed.stack
    eta_read, etat_read = _base_reads(packed)
    slots = kernel_slots(packed)
    if x_planes is None:
        x_planes = _x_planes(nx, ny, nz, P.dtype, P.device)

    def ptrs(ts):
        return (ctypes.c_void_p * _N_CARRY)(*[t.data_ptr() for t in ts])

    fn = lib.jr_stokes3d_ve_chunk_f32 if P.dtype == torch.float32 else lib.jr_stokes3d_ve_chunk_f64
    err = fn(ptrs(carry), ptrs(work[0]), ptrs(work[1]), packed.stack.data_ptr(),
             (ctypes.c_int * len(COEF_NAMES))(*slots),
             (ctypes.c_double * len(COEF_NAMES))(*packed.values),
             base.data_ptr(),
             (ctypes.c_int * 3)(0 if d is None else d.c3_mode, int(eta_read), int(etat_read)),
             (ctypes.c_double * 3)(*(d.scalars if d is not None else (0.0, 0.0, 0.0))),
             nx, ny, nz, int(nout), (ctypes.c_double * 3)(*(float(v) for v in inv_di)),
             int(bool(free_slip)), int(x_planes), stream)
    if err != 0:
        raise RuntimeError(
            f"stokes3d_chunk: CUDA error {err}: {lib.jr_cuda_error_string(err).decode()}")
    return tuple(work[(int(nout) - 1) % 2].unbind(0))


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
    d = packed.derived
    if d is not None and (d.base.shape != (2,) + tuple(P.shape) or d.base.dtype != P.dtype
                          or d.base.device != P.device or not d.base.is_contiguous()):
        raise ValueError("stokes3d_chunk: the derivation's η/ητ canvases do not match "
                         "the carry")


@functools.lru_cache(maxsize=None)
def _library():
    return _bind(load_library(SOURCE))


def _bind(lib):
    """``lib`` with the C functions of ``csrc/stokes3d_ve.cu`` typed."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    ip, dp = ctypes.POINTER(i), ctypes.POINTER(ctypes.c_double)
    for name in ("jr_stokes3d_ve_chunk_f32", "jr_stokes3d_ve_chunk_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(vp)] * 3 + [vp, ip, dp, vp, ip, dp, i, i, i, i, dp,
                                                  i, i, vp]
        fn.restype = i
    return lib
