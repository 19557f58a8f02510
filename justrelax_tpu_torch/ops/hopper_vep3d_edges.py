"""The three edge return-mapping passes of the hybrid 3D VEP iteration:
Hopper CUDA kernel, its plain PyTorch version, and the const packing and
guard they share.

Counterpart of ``justrelax_tpu/ops/pallas_vep3d_edges.py`` (the TPU kernels
``vep3d_edges_blocked``, B6, and ``vep3d_edges_split``, B9) and of the guard
and const plumbing of ``justrelax_tpu/ops/pallas_stokes3d_vep_blocked.py``
(``_PP_FIELDS``, ``vep3d_blocked_supported``, ``_flatten_vep_consts``).
Given the pre-iteration canvases (V×3, the new θ, η, the three normal τ_c,
τ_e×3, λ_e×3) and the solve's consts, they return the new τ_e×3 and λ_e×3:
the edge passes of ``ops/stokes3d_vep.py::update_stresses_center_edges_3d``
on the slots each family owns, the other slots unchanged.

- ``vep3d_edges`` is the wrapper. On CUDA tensors it launches the kernel of
  ``csrc/stokes3d_vep.cu`` (``k_edges``, (y, z) tiles marching along x;
  built with ``nvcc`` at first use by ``ops/_cuda_build.py`` and loaded with
  ``ctypes``) or raises; on CPU tensors it runs the plain version.
  ``split=False`` is B6: one launch for the three families, the old-stress
  interpolants re-derived from the nine τ_o canvases
  (``vep3d_edges.launches`` counts these launches). ``split=True`` is B9:
  one launch for the three families on their six hoisted interpolants each
  (``vep3d_canvas_consts(hoist_tau_o=True)``; ``vep3d_edges.split_launches``
  counts these launches, one per call).
- ``vep3d_edges_reference`` is the plain version, the same two forms through
  ``update_stresses_center_edges_3d(probe_passes=("edges",),
  edge_families=…)``.
- ``pack_edge_consts`` turns the consts into what the kernel reads, once per
  chunk: each G_e and old-stress canvas that holds one value over the slots
  the kernel reads it on goes in as that value.
- ``vep3d_blocked_supported`` is the guard: plastic parameters and bulk
  modulus phase-uniform, softening off (the kernel takes them as scalars).

The TPU kernels' x-slab windows, double buffering, ``choose_blocking_edges``
and the 128-lane padding are not ported, nor B9's one launch per family: it
shrank the TPU kernel's VMEM live set, and the card's kernel runs the three
families of a slot in one pass over the same staged planes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from justrelax_tpu_torch.ops._cuda_build import CSRC, load_library
from justrelax_tpu_torch.ops.stokes3d_vep import update_stresses_center_edges_3d
from justrelax_tpu_torch.ops.stokes3d_vep_canvas import (
    VEP3DCanvasConsts,
    canvas_moves,
    canvas_strain_rates,
    edge_masks,
)
from justrelax_tpu_torch.rheology.materials import _as_stack

__all__ = [
    "PackedEdgeConsts",
    "pack_edge_consts",
    "vep3d_blocked_supported",
    "vep3d_edges",
    "vep3d_edges_reference",
]

SOURCE = CSRC / "stokes3d_vep.cu"

# plastic scalar order (PlasticParams fields); csrc/stokes3d_vep.cu reads it
_PP_FIELDS = ("is_pl", "pl_frac", "C_cosphi", "sinphi", "cosphi", "sinpsi",
              "eta_reg", "pT", "dq_shear")


def vep3d_blocked_supported(material) -> bool:
    """The edge kernel's guard on a material stack: plasticity phase-uniform
    (every PlasticParams field collapses to one scalar) and strain softening
    off (no EII dependence). ``solve_vep_3d`` also asks for a phase-uniform
    bulk modulus Kb."""
    p = _as_stack(material, None).params

    def uni(name):
        v = getattr(p, name)
        return bool((v == v.reshape(-1)[0]).all())

    uniform = all(uni(n) for n in ("is_plastic", "C", "friction_angle", "dilation_angle",
                                   "eta_reg", "tension_pT", "dqdtau_alt"))
    soft_off = not any(bool((getattr(p, n) != 0).any())
                       for n in ("soft_C_active", "soft_phi_active", "soft_C_nl"))
    return uniform and soft_off


def _flatten_vep_consts(co: VEP3DCanvasConsts):
    """(canvas list, canvas names, extra scalars, scalar names, plastic
    scalars) of scalar-plastic consts: the 3D canvases, and the 0-d values
    (e.g. the scalar-K collapse) apart."""
    arrays, names, scalars, snames = [], [], [], []

    def put(name, v):
        if v is None:
            return
        v = torch.as_tensor(v)
        if v.ndim == 0:
            scalars.append(v)
            snames.append(name)
        else:
            if v.ndim != 3:
                raise ValueError(f"_flatten_vep_consts: {name} has shape {tuple(v.shape)}")
            arrays.append(v)
            names.append(name)

    p = co.params
    put("G_c", p.G_c)
    put("K_c", p.K_c)
    for i in range(3):
        put(f"G_e{i}", p.G_e[i])
        put(f"K_e{i}", p.K_e[i])
    for i in range(6):
        put(f"tau_o_c{i}", co.tau_o_c[i])
    for i in range(3):
        put(f"tau_o_e{i}", co.tau_o_e[i])
    put("P0", co.P0)
    put("Q", co.Q)
    put("fzA", co.fzA)
    put("fzB", co.fzB)
    put("visc_eta", co.visc_eta)
    put("visc_A", co.visc_A)
    put("visc_B", co.visc_B)
    pp = co.params.ppc
    if torch.as_tensor(pp.C_cosphi).ndim != 0:
        raise ValueError("the edge kernel needs scalar_plastic consts")
    pp_scalars = [torch.as_tensor(getattr(pp, f)) for f in _PP_FIELDS]
    return arrays, tuple(names), scalars, tuple(snames), pp_scalars


class PackedEdgeConsts(NamedTuple):
    """Consts as the edge kernel reads them (:func:`pack_edge_consts`):
    ``G`` and ``tau_o`` hold per source a canvas or ``None``, ``G_val`` and
    ``tau_o_val`` the value of a source given as a scalar; ``tau_o`` has per
    family its six old-stress sources (B6: τ_o_c normals×3 and τ_o_e×3, the
    same for each family; B9: the family's hoisted interpolants);
    ``scalars`` are the nine plastic scalars (``_PP_FIELDS`` order) and K."""

    co: VEP3DCanvasConsts
    split: bool
    G: tuple
    G_val: tuple
    tau_o: tuple
    tau_o_val: tuple
    scalars: tuple


def _uniform_value(t, region):
    """The one value ``t`` holds on the slots of ``region`` (a boolean mask
    broadcastable to ``t``), or ``None``."""
    t = torch.as_tensor(t)
    if t.ndim == 0:
        return float(t)
    v = t[region.expand(t.shape)]
    return float(v[0]) if bool((v == v[0]).all()) else None


def pack_edge_consts(co, split=False) -> PackedEdgeConsts:
    """The edge kernel's view of ``co`` (a ``VEP3DCanvasConsts`` built with
    ``scalar_plastic=True, scalar_K=True``; with ``split`` also
    ``hoist_tau_o=True``). A G_e or old-stress canvas that holds one value on
    the slots the kernel reads it on (the owned slots of the family it lives
    on; the cells for τ_o_c) goes in as that value. Reads the consts on the
    host: call it once per chunk."""
    if isinstance(co, PackedEdgeConsts):
        if co.split != bool(split):
            return pack_edge_consts(co.co, split)
        return co
    p = co.params
    *_, pp_scalars = _flatten_vep_consts(co)
    K = torch.as_tensor(p.K_e[0])
    if K.ndim != 0 or any(torch.as_tensor(k).ndim != 0 for k in p.K_e):
        raise ValueError("the edge kernel needs scalar_K consts")
    shape = tuple(co.tau_o_c[0].shape)
    Mc, Me = edge_masks(shape, co.tau_o_c[0].device)

    def slot(t, region):
        v = _uniform_value(t, region)
        return (None, v) if v is not None else (t.contiguous(), 0.0)

    G = [slot(p.G_e[k], Me[k]) for k in range(3)]
    if split:
        if p.tau_o6_e is None:
            raise ValueError("vep3d_edges(split=True) needs hoist_tau_o=True consts")
        tau_o = [[slot(t, Me[k]) for t in p.tau_o6_e[k]] for k in range(3)]
    else:
        src = [slot(co.tau_o_c[i], Mc) for i in range(3)] + \
              [slot(co.tau_o_e[m], Me[m]) for m in range(3)]
        tau_o = [src] * 3
    return PackedEdgeConsts(
        co=co, split=bool(split),
        G=tuple(g[0] for g in G), G_val=tuple(g[1] for g in G),
        tau_o=tuple(tuple(s[0] for s in fam) for fam in tau_o),
        tau_o_val=tuple(tuple(s[1] for s in fam) for fam in tau_o),
        scalars=tuple(float(v) for v in pp_scalars) + (float(K),),
    )


def vep3d_edges_reference(V, theta, eta, tau_c_normals3, tau_e3, lam_e3, co, inv_di, *,
                          dt, theta_dtau, lambda_relaxation, split=False):
    """Plain version of :func:`vep3d_edges`: the edge passes of
    ``update_stresses_center_edges_3d`` on the canvases, in one call for the
    three families with the old-stress interpolants re-derived (B6) or one
    call per family on the hoisted ones (B9); the slots a family does not
    own keep their input values."""
    if isinstance(co, PackedEdgeConsts):
        co = co.co
    _, eps_c3, eps_e3 = canvas_strain_rates(V, inv_di)
    X, Y, Z = theta.shape
    moves = canvas_moves((X - 2, Y - 2, Z - 2))
    z = torch.zeros_like(theta)
    tau_c6 = tuple(tau_c_normals3) + (z, z, z)   # the edge passes read the normals only
    p = co.params
    if split:
        if p.tau_o6_e is None:
            raise ValueError("vep3d_edges(split=True) needs hoist_tau_o=True consts")
        calls = [((k,), p) for k in range(3)]
    else:
        calls = [(None, p._replace(tau_o6_e=None))]
    new_tau, new_lam = list(tau_e3), list(lam_e3)
    for families, params in calls:
        res = update_stresses_center_edges_3d(
            eps_c3, eps_e3, tau_c6, tuple(tau_e3), tuple(co.tau_o_c), tuple(co.tau_o_e),
            theta, eta, None, tuple(lam_e3), None, None, None, (None, None, None),
            lambda_relaxation, dt, theta_dtau,
            moves=moves, params=params, probe_passes=("edges",), edge_families=families)
        for k in (range(3) if families is None else families):
            new_tau[k], new_lam[k] = res.tau_e[k], res.lam_e[k]
    _, Me = edge_masks(tuple(theta.shape), theta.device)
    return (tuple(torch.where(m, t, old) for m, t, old in zip(Me, new_tau, tau_e3)),
            tuple(torch.where(m, t, old) for m, t, old in zip(Me, new_lam, lam_e3)))


def vep3d_edges(V, theta, eta, tau_c_normals3, tau_e3, lam_e3, co, inv_di, *,
                dt, theta_dtau, lambda_relaxation, split=False):
    """The three edge return-mapping passes of one hybrid 3D VEP iteration.
    All fields are (nx+2, ny+2, nz+2) canvases: ``V`` the three velocity
    canvases, ``theta`` the iteration's new pressure iterate, ``eta`` the
    viscosity, ``tau_c_normals3`` the normal stresses τxx, τyy, τzz,
    ``tau_e3``/``lam_e3`` the edge stresses and multipliers (yz, xz, xy).
    ``co`` is a ``VEP3DCanvasConsts`` built with ``scalar_plastic=True,
    scalar_K=True`` (``hoist_tau_o=True`` for ``split``) or its
    :func:`pack_edge_consts`. Returns (τ_e×3, λ_e×3), new tensors; the slots
    a family does not own keep the input's values. ``split=False`` runs B6,
    ``True`` B9."""
    if theta.device.type == "cpu":
        return vep3d_edges_reference(V, theta, eta, tau_c_normals3, tau_e3, lam_e3, co,
                                     inv_di, dt=dt, theta_dtau=theta_dtau,
                                     lambda_relaxation=lambda_relaxation, split=split)
    if theta.device.type != "cuda":
        raise ValueError(f"vep3d_edges: unsupported device {theta.device}")
    with torch.cuda.device(theta.device):
        out = _launch(_library(), torch.cuda.current_stream().cuda_stream,
                      (*V, theta, eta, *tau_c_normals3, *tau_e3, *lam_e3), co, inv_di, dt,
                      theta_dtau, lambda_relaxation, split)
    if split:
        vep3d_edges.split_launches += 1
    else:
        vep3d_edges.launches += 1
    return out


def _launch(lib, stream, dyn, co, inv_di, dt, theta_dtau, lambda_relaxation, split):
    """Check the edge passes' inputs ``dyn`` (V×3, θ, η, the normal τ_c×3,
    τ_e×3, λ_e×3), pack the consts and run the C function of ``lib`` (bound
    by ``_bind``) on ``stream``: one launch, B6 or (``split``) B9. Returns
    (τ_e×3, λ_e×3); raises on a launch error."""
    _check(dyn, "input")
    theta = dyn[3]
    packed = pack_edge_consts(co, split)
    consts = [c for c in (*packed.G, *(t for fam in packed.tau_o for t in fam))
              if c is not None]
    _check(consts, "const", like=theta)
    X, Y, Z = theta.shape
    out_tau = tuple(torch.empty_like(theta) for _ in range(3))
    out_lam = tuple(torch.empty_like(theta) for _ in range(3))

    def ptr(t):
        return None if t is None else t.data_ptr()

    tau_o_ptrs = [ptr(t) for fam in packed.tau_o for t in fam]
    vals = [*(float(v) for v in inv_di), float(dt), float(theta_dtau),
            float(lambda_relaxation), *packed.scalars, *packed.G_val,
            *(v for fam in packed.tau_o_val for v in fam)]
    fn = lib.jr_vep3d_edges_f32 if theta.dtype == torch.float32 else lib.jr_vep3d_edges_f64
    c_vals = (ctypes.c_double * len(vals))(*vals)
    outs = [t.data_ptr() for t in (*out_tau, *out_lam)]
    ptrs = [t.data_ptr() for t in dyn] + outs + [ptr(g) for g in packed.G] + tau_o_ptrs
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    # family 3: the three families on their hoisted interpolants (B9); -1: B6
    err = fn(c_ptrs, c_vals, X - 2, Y - 2, Z - 2, 3 if split else -1, stream)
    if err != 0:
        raise RuntimeError(f"vep3d_edges: CUDA error {err}: "
                           f"{lib.jr_cuda_error_string(err).decode()}")
    return out_tau, out_lam


vep3d_edges.launches = 0         # B6 launches (split=False)
vep3d_edges.split_launches = 0   # B9 launches (split=True), one per call


def _check(tensors, what, like=None, who="vep3d_edges"):
    ref = tensors[0] if like is None else like
    if ref.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{who}: dtype {ref.dtype} is not float32/float64")
    if ref.ndim != 3 or min(ref.shape) < 3:
        raise ValueError(f"{who}: canvas shape {tuple(ref.shape)} is not "
                         "(nx+2, ny+2, nz+2) with nx, ny, nz >= 1")
    for k, t in enumerate(tensors):
        if t.device != ref.device or t.dtype != ref.dtype:
            raise ValueError(f"{who}: {what} {k} is {t.dtype} on {t.device}")
        if t.shape != ref.shape:
            raise ValueError(f"{who}: {what} {k} has shape {tuple(t.shape)}, "
                             f"expected {tuple(ref.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {what} {k} is not contiguous")


@functools.lru_cache(maxsize=None)
def _library():
    return _bind(load_library(SOURCE))


def _bind(lib):
    """``lib`` with the C functions of ``csrc/stokes3d_vep.cu`` typed."""
    vp, i, dp = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_double)
    for name in ("jr_vep3d_edges_f32", "jr_vep3d_edges_f64", "jr_vep3d_chunk_f32",
                 "jr_vep3d_chunk_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(vp), dp, i, i, i, i, vp]
        fn.restype = i
    return lib
