"""The fused 3D VEP pseudo-transient chunk: Hopper CUDA kernel, its plain
PyTorch version, and the const packing they share.

Counterpart of ``justrelax_tpu/ops/pallas_stokes3d_vep_blocked.py`` (the TPU
kernel ``stokes3d_vep_chunk_blocked``, B8), with its contract: ``nout``
fused iterations of ``ops/stokes3d_vep_canvas.py::iteration_vep3d_canvas`` on
the 19 carry canvases, the consts built with ``scalar_plastic=True,
scalar_K=True`` (the guard ``ops/hopper_vep3d_edges.py::
vep3d_blocked_supported`` and a phase-uniform Kb), the τ_o edge
interpolants re-derived in the kernel.

- ``stokes3d_vep_chunk`` is the wrapper. On CUDA tensors it launches
  ``k_cells``, ``k_stress`` (the stress pass, its strain rates computed once
  per point into shared memory) and ``k_velocity`` of
  ``csrc/stokes3d_vep.cu`` (the library the edge kernel's wrapper builds and
  loads): three launches per iteration, counted by
  ``stokes3d_vep_chunk.launches``. It raises on a launch error; on CPU
  tensors it runs the plain version. ``_launch`` does the work on a given
  library and stream (the tests run it on a CPU build of the source).
- ``stokes3d_vep_chunk_reference`` is the plain version: the canvas chunk
  ``vep3d_chunk_canvas`` with its edge passes in PyTorch.
- ``pack_chunk_consts`` turns the consts into what the kernel reads, once
  per solve: each canvas that holds one value over the slots the kernel
  reads it on goes in as that value, and an absent body force or creep
  coefficient as a flag.

The TPU kernel's blocking (``choose_blocking_vep3d``, the x/y windows, the
3k-plane halos, ``plane_block``, ``iters_per_pass``, ``y_block``, ``nvals``,
``interpret``) and ``_rebuild_vep_consts`` are not ported: they fitted the
iteration into VMEM windows that this card does not have.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from justrelax_tpu_torch.ops import hopper_vep3d_edges as he
from justrelax_tpu_torch.ops.stokes3d_vep_canvas import (
    VEP3DCanvasCarry,
    edge_masks,
    vep3d_chunk_canvas,
)

__all__ = [
    "CONST_NAMES",
    "PackedChunkConsts",
    "pack_chunk_consts",
    "stokes3d_vep_chunk",
    "stokes3d_vep_chunk_reference",
]

# Const order; csrc/stokes3d_vep.cu's ConstSlot enum matches.
CONST_NAMES = ("G_c", "G_e0", "G_e1", "G_e2",
               *(f"tau_o_c{j}" for j in range(6)), *(f"tau_o_e{j}" for j in range(3)),
               "P0", "Q", "fzA", "fzB", "visc_eta", "visc_A", "visc_B")


class PackedChunkConsts(NamedTuple):
    """Consts as the chunk kernel reads them (:func:`pack_chunk_consts`):
    per ``CONST_NAMES`` entry a canvas or ``None`` (``canvases``) and the
    value of one given as a scalar (``values``); ``scalars`` are the nine
    plastic scalars (``_PP_FIELDS`` order) and K."""

    co: object
    canvases: tuple
    values: tuple
    scalars: tuple
    visc_m: float
    has_fz: bool
    linear: bool


def _sources(co):
    p = co.params
    return (p.G_c, *p.G_e, *co.tau_o_c, *co.tau_o_e, co.P0, co.Q, co.fzA, co.fzB,
            co.visc_eta, co.visc_A, co.visc_B)


def pack_chunk_consts(co) -> PackedChunkConsts:
    """The chunk kernel's view of ``co`` (a ``VEP3DCanvasConsts`` built with
    ``scalar_plastic=True, scalar_K=True``). A canvas that holds one value on
    the slots the kernel reads it on (the cells, or the owned slots of the
    edge family it lives on) goes in as that value; an absent one (no body
    force, the coefficients of the other creep form) as 0. Reads the consts
    on the host: call it once per solve."""
    if isinstance(co, PackedChunkConsts):
        return co
    *_, pp_scalars = he._flatten_vep_consts(co)
    p = co.params
    if any(torch.as_tensor(k).ndim != 0 for k in (p.K_c, *p.K_e)):
        raise ValueError("the chunk kernel needs scalar_K consts")
    Mc, Me = edge_masks(tuple(co.tau_o_c[0].shape), co.tau_o_c[0].device)
    regions = (Mc, *Me, *(Mc,) * 6, *Me, *(Mc,) * 9)
    canvases, values = [], []
    for t, region in zip(_sources(co), regions):
        v = None if t is None else he._uniform_value(t, region)
        if t is None or v is not None:
            canvases.append(None)
            values.append(0.0 if t is None else v)
        else:
            canvases.append(t.contiguous())
            values.append(0.0)
    return PackedChunkConsts(
        co=co, canvases=tuple(canvases), values=tuple(values),
        scalars=tuple(float(v) for v in pp_scalars) + (float(p.K_c),),
        visc_m=0.0 if co.visc_m is None else float(co.visc_m),
        has_fz=co.fzA is not None, linear=co.visc_m is None)


def stokes3d_vep_chunk_reference(c, co, inv_di, nout, **kw):
    """Plain version of :func:`stokes3d_vep_chunk`: ``nout`` iterations of
    the canvas chunk, its edge passes in PyTorch."""
    if isinstance(co, PackedChunkConsts):
        co = co.co
    return vep3d_chunk_canvas(c, co, None, inv_di, nout, **kw)


def stokes3d_vep_chunk(c: VEP3DCanvasCarry, co, inv_di, nout, *, dt, r, theta_dtau,
                       etadtau, lambda_relaxation, viscosity_relaxation,
                       viscosity_cutoff=(-math.inf, math.inf)) -> VEP3DCanvasCarry:
    """Advance ``nout`` fused 3D VEP iterations of the canvas carry ``c``
    (all (nx+2, ny+2, nz+2), contiguous). ``co`` is a ``VEP3DCanvasConsts``
    built with ``scalar_plastic=True, scalar_K=True``, or its
    :func:`pack_chunk_consts`. Returns a new carry; ``c`` is not written."""
    kw = dict(dt=dt, r=r, theta_dtau=theta_dtau, etadtau=etadtau,
              lambda_relaxation=lambda_relaxation, viscosity_relaxation=viscosity_relaxation,
              viscosity_cutoff=viscosity_cutoff)
    P = c.P
    if P.device.type == "cpu":
        return stokes3d_vep_chunk_reference(c, co, inv_di, nout, **kw)
    if P.device.type != "cuda":
        raise ValueError(f"stokes3d_vep_chunk: unsupported device {P.device}")
    nit = int(nout)
    if nit <= 0:
        return c
    with torch.cuda.device(P.device):
        out = _launch(he._library(), torch.cuda.current_stream().cuda_stream, c, co, inv_di,
                      nit, kw)
    stokes3d_vep_chunk.launches += 3 * nit
    return out


def _launch(lib, stream, c, co, inv_di, nit, kw):
    """Check the carry ``c``, pack the consts and run ``nit`` iterations of
    the C function of ``lib`` (``hopper_vep3d_edges._bind``) on ``stream``;
    returns the new carry. Raises on a launch error."""
    P = c.P
    flat = (*c.V, c.P, c.theta, *c.tau_c, *c.tau_e, c.eta, c.lam, *c.lam_e)
    he._check(flat, "carry", who="stokes3d_vep_chunk")
    packed = pack_chunk_consts(co)
    consts = [t for t in packed.canvases if t is not None]
    if consts:
        he._check(consts, "const", like=P, who="stokes3d_vep_chunk")
    work = [[torch.empty_like(P) for _ in flat] for _ in range(2)]
    eta_tau = torch.zeros_like(P)
    ptrs = [t.data_ptr() for t in (*flat, *work[0], *work[1], eta_tau)] + \
        [None if t is None else t.data_ptr() for t in packed.canvases]
    vals = [*(float(v) for v in inv_di), float(kw["dt"]), float(kw["r"]),
            float(kw["theta_dtau"]), float(kw["etadtau"]), float(kw["lambda_relaxation"]),
            float(kw["viscosity_relaxation"]), float(kw["viscosity_cutoff"][0]),
            float(kw["viscosity_cutoff"][1]), *packed.scalars, *packed.values,
            packed.visc_m, float(packed.has_fz), float(packed.linear)]
    fn = lib.jr_vep3d_chunk_f32 if P.dtype == torch.float32 else lib.jr_vep3d_chunk_f64
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_vals = (ctypes.c_double * len(vals))(*vals)
    X, Y, Z = P.shape
    err = fn(c_ptrs, c_vals, X - 2, Y - 2, Z - 2, nit, stream)
    if err != 0:
        raise RuntimeError(f"stokes3d_vep_chunk: CUDA error {err}: "
                           f"{lib.jr_cuda_error_string(err).decode()}")
    o = work[(nit - 1) % 2]
    return VEP3DCanvasCarry(V=tuple(o[:3]), P=o[3], theta=o[4], tau_c=tuple(o[5:11]),
                            tau_e=tuple(o[11:14]), eta=o[14], lam=o[15], lam_e=tuple(o[16:19]))


stokes3d_vep_chunk.launches = 0   # kernel launches, three per iteration
