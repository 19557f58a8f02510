"""Per-kernel-family benchmark chunks (the T_eff / GUPS harness).

Counterpart of ``justrelax_tpu/utils/bench_kernels.py``. The APT method is
memory-bandwidth bound (Räss et al. 2022 GMD), so the figure of merit of
every kernel family is T_eff = A_eff / t_iter, the *necessary* memory
traffic of one PT iteration over its time, beside grid updates per second.

Traffic accounting follows the Räss convention: arrays that change every
iteration (the unknowns) count read and written (2×N), arrays only read
count once (1×N); quantities recomputed on the fly (ητ maxloc,
interpolations, strain rates) are not counted. The word is 4 bytes in every
dtype, float64 included, as in the JAX package: ``bytes_per_iter`` is the
same integer JAX's factory returns.

Each factory ``FAMILIES[name](**kw)`` keeps the JAX factory's name, keyword
arguments and defaults (``dtype`` a torch dtype, ``torch.float32`` by
default), adds ``device=None`` (the card, ``core/device.py``; tests pass
``device="cpu"``) and returns ``(step, carry, consts, bytes_per_iter,
n_cells)``. ``step(n, carry, consts)`` advances ``n`` (a Python int)
iterations and returns a new carry: it never writes its input carry or
consts, so a two-point timing reuses them. A kernel family's step may
return a richer tuple than its carry (``pallas_vep2d``: the 12 VEP fields
from the ``(Vx, Vy)`` carry). The inputs are built from numpy with JAX's
seeds and formulas, so the same keyword arguments in float64 give JAX's
carry and consts.

``step`` is a :class:`FamilyStep`: the tensors it reads besides the carry
and the consts are named in ``step.closure`` (JAX finds them as the jaxpr's
closure constants; here they are explicit), ``step.kernel`` names the
kernel wrapper it launches on the card (its counter in ``dist_cases.
kernel_counts``) or is ``None`` for the plain families, ``step.reference``
runs the kernel's plain version on the same inputs, and ``step.setup``
holds set-up objects a caller may reuse (geometry, BCs, chunk keywords).

Routes on the card. The plain families (``ve2d``, ``vep2d``,
``vep2d_1024``, ``thermal2d``, ``thermal3d``, ``ve3d``, ``ve3d_254``,
``vep3d``, ``ve3d_canvas``, ``ve3d_canvas_254``, ``vep3d_canvas``) run the
port's plain ops as eager loops. The kernel families launch the Hopper
kernels through their usual wrappers: ``pallas_ve2d`` and
``pallas_ve2d_blocked`` B1/B4 (``ops/hopper_stokes.py::stokes_chunk``, the
viscous limit), ``pallas_vep2d`` and ``pallas_vep2d_blocked`` B2/B3
(``ops/hopper_stokes_vep.py::stokes_vep_chunk``), ``pallas_thermal2d`` B5
(``ops/hopper_thermal.py::thermal_chunk``), ``pallas_ve3d_blocked`` and
``pallas_ve3d_blocked_254`` B7 (``ops/hopper_stokes3d.py::stokes3d_chunk``),
``pallas_vep3d_blocked`` B8 (``ops/hopper_stokes3d_vep.py::
stokes3d_vep_chunk``), ``pallas_vep3d_edges`` B6 and ``pallas_vep3d_split``
B9 (``ops/stokes3d_vep_canvas.py::vep3d_chunk_canvas`` with
``ops/hopper_vep3d_edges.py::vep3d_edges`` as its ``edges_fn``). Each
wrapper packs its chunk-invariant inputs once per call, outside its
kernel's launches; a two-point timing cancels that fixed cost. On CPU
tensors the wrappers run their plain versions. There is no fallback: a
kernel that fails to build or launch raises.

The TPU factories' blocking and lowering arguments (``row_block``,
``iters_per_pass``, ``plane_block``, ``pipeline``, ``y_block``, ``nvals``,
``edges_nvals``, ``shift``, ``lean``) chose VMEM windows and Mosaic
lowerings that the card does not have: each is accepted at its JAX default
and any other value raises ``ValueError``. ``ve3d_canvas_254`` therefore
builds the full coefficient canvases where JAX's builds its lean consts
(bitwise identical results by JAX's own account, ``ve3d_canvas``'s
docstring there).

dtypes: every family evaluates its material in the family's dtype
(``MaterialStack.make(dtype=...)``). JAX casts the material to ``dtype`` in
``vep2d``, ``vep3d`` and ``vep3d_canvas`` (and the families built on it)
but not in ``pallas_vep2d`` and ``pallas_vep2d_blocked``, whose material
keeps JAX's default float dtype (float64 under x64): in float32 those two
may differ from JAX's x64 numbers by rounding. In float64 every family's
inputs are JAX's.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from justrelax_tpu_torch.core.device import resolve_device

Tensor = Any

__all__ = ["FAMILIES", "FamilyStep", "make_family", "stream_bytes_per_iter",
           "build_family_on_cpu"]

WORD_BYTES = 4  # JAX's convention: 4 bytes per word, in float64 too


class FamilyStep:
    """A family's ``step(n, carry, consts)``: ``fn(n, carry, consts,
    **closure)`` (and ``plain=True`` for the kernel's plain version, on a
    kernel family). ``closure`` names the tensors the step reads besides the
    carry and the consts; ``kernel`` the kernel wrapper it launches on the
    card, ``None`` on a plain family; ``setup`` set-up objects a caller may
    reuse, which the step does not read."""

    def __init__(self, fn, closure=None, kernel=None, setup=None):
        self.fn = fn
        self.closure = dict(closure or {})
        self.kernel = kernel
        self.setup = dict(setup or {})

    def __call__(self, n, carry, consts):
        return self.fn(int(n), carry, consts, **self.closure)

    def reference(self, n, carry, consts):
        """The same ``n`` iterations through the kernel's plain version (the
        step itself on a plain family)."""
        if self.kernel is None:
            return self(n, carry, consts)
        return self.fn(int(n), carry, consts, plain=True, **self.closure)

    def to(self, device, memo=None):
        """The step with its closure and set-up on ``device``."""
        memo = {} if memo is None else memo
        return FamilyStep(self.fn, _to(self.closure, device, memo), self.kernel,
                          _to(self.setup, device, memo))


def _to(tree, device, memo):
    """``tree`` with every tensor moved to ``device``; a tensor reached
    twice is moved once (``memo``: id → moved tensor)."""
    if isinstance(tree, torch.Tensor):
        key = id(tree)
        if key not in memo:
            memo[key] = (tree, tree.to(device))
        return memo[key][1]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to(v, device, memo) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, device, memo) for v in tree)
    if isinstance(tree, dict):
        return {k: _to(v, device, memo) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        changed = {}
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            w = _to(v, device, memo)
            if w is not v:
                changed[f.name] = w
        return dataclasses.replace(tree, **changed) if changed else tree
    return tree


def _leaves(tree):
    """The tensors of ``tree`` in order (each occurrence, as
    ``jax.tree.leaves``)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree) for x in _leaves(getattr(tree, f.name))]
    return []


def _array_bytes(tree):
    return sum(t.numel() * t.element_size() for t in _leaves(tree) if t.ndim > 0)


def _stream_bytes(step, carry, consts):
    """:func:`stream_bytes_per_iter` of a family already built."""
    return 2 * _array_bytes(carry) + _array_bytes(consts) + _array_bytes(step.closure)


def stream_bytes_per_iter(name, factory_kwargs=None):
    """Actual per-iteration stream of a plain family's eager loop, in bytes:
    every carried array read and written (2×), every chunk-invariant operand
    (the consts and the step's closure, ``FamilyStep.closure``) read once
    per iteration (1×), counting arrays only (``ndim > 0``). ``(stream
    bytes / t_iter) / HBM peak`` is the measured roofline fraction at actual
    traffic, independent of the Räss convention. Not meaningful for the
    kernel families (their traffic is per launch, not the carry's). Builds
    the family (``factory_kwargs``, ``device`` among them; the card by
    default) and runs nothing."""
    step, carry, consts, _, _ = FAMILIES[name](**(factory_kwargs or {}))
    return _stream_bytes(step, carry, consts)


def _tpu_only(**given):
    """Raise for a TPU blocking or lowering argument away from its JAX
    default: ``given`` maps each name to (value, default)."""
    for name, (value, default) in given.items():
        if value != default:
            raise ValueError(
                f"{name}={value!r} is a TPU blocking or lowering choice (VMEM windows, "
                f"Mosaic lowering) with no counterpart on the card; leave it at {default!r}")


def _kw(dtype, device):
    return dict(dtype=dtype, device=resolve_device(device))


def _t(a, kw):
    """A numpy array (or number) as a tensor of ``kw``'s dtype and device."""
    return torch.as_tensor(np.asarray(a), **kw)


def _free_slip(ndim):
    from justrelax_tpu_torch.ops.bc import Faces, VelocityBoundaryConditions

    faces = dict(left=True, right=True, top=True, bot=True)
    if ndim == 3:
        faces.update(front=True, back=True)
    return VelocityBoundaryConditions(free_slip=Faces(**faces))


# --------------------------------------------------------------------------
# 2D visco-elastic (SolCx), the flagship single-kernel iteration
# --------------------------------------------------------------------------
def _solcx_setup(nx, ny, kw):
    from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs
    from justrelax_tpu_torch.core.grid import Geometry
    from justrelax_tpu_torch.core.state import StokesState

    ni = (nx, ny)
    geometry = Geometry(ni, (1.0, 1.0))
    stokes = StokesState.make(ni, **kw)
    X, Y = geometry.cell_centers_mesh()
    eta = _t(np.where(X <= 0.5, 1.0, 1.0e3), kw)
    stokes = stokes.replace(viscosity=stokes.viscosity.replace(eta=eta))
    rho_g = (torch.zeros(ni, **kw), _t(-np.sin(np.pi * Y) * np.cos(np.pi * X), kw))
    pt = PTStokesCoeffs.make(geometry.li, geometry.di, CFL=1.0 / math.sqrt(2.1))
    G = torch.full(ni, math.inf, **kw)
    K = torch.full(ni, math.inf, **kw)
    return geometry, stokes, pt, _free_slip(2), rho_g, G, K


def ve2d(nx=1024, ny=1024, dtype=torch.float32, device=None):
    """One VE Stokes PT iteration, SolCx viscosity field.

    Traffic: unknowns (R+W) Vx, Vy, P, τxx, τyy, τxy → 12·N; read-only
    η, ητ, G, K, P0, Q, ρgx, ρgy, τ_o×3 → 11·N. A_eff = 23·N·4 B.
    """
    from justrelax_tpu_torch.ops import stokes as k
    from justrelax_tpu_torch.ops.bc import flow_bcs
    from justrelax_tpu_torch.ops.stencil import maxloc

    kw = _kw(dtype, device)
    geometry, stokes, pt, bc, rho_g, G, K = _solcx_setup(nx, ny, kw)
    inv_dx, inv_dy = 1.0 / geometry.di[0], 1.0 / geometry.di[1]
    r, theta, etadtau = pt.r, pt.theta_dtau, pt.etadtau

    def fn(n, carry, consts, dt):
        P0, Q, eta, G, K, rho_gx, rho_gy = consts
        eta_tau = maxloc(eta, window=1)
        zeros = torch.zeros_like(P0)
        zeros_v = torch.zeros((nx + 1, ny + 1), dtype=P0.dtype, device=P0.device)
        Vx, Vy, P, txx, tyy, txy = carry
        for _ in range(n):
            grad_V = k.compute_grad_V(Vx, Vy, inv_dx, inv_dy)
            _, P = k.compute_P(P, P0, grad_V, Q, eta_tau, K, G, dt, r, theta)
            exx, eyy, exy = k.compute_strain_rate(grad_V, Vx, Vy, inv_dx, inv_dy)
            txx, tyy, txy = k.compute_tau_ve(txx, tyy, txy, zeros, zeros, zeros_v,
                                             exx, eyy, exy, eta, G, theta, dt)
            Vx, Vy = k.compute_V(Vx, Vy, P, txx, tyy, txy, etadtau, rho_gx, rho_gy,
                                 eta_tau, inv_dx, inv_dy)
            Vx, Vy = flow_bcs((Vx, Vy), bc)
        return (Vx, Vy, P, txx, tyy, txy)

    carry = (stokes.V.Vx, stokes.V.Vy, stokes.P, stokes.tau.xx, stokes.tau.yy, stokes.tau.xy)
    consts = (stokes.P0, stokes.Q, stokes.viscosity.eta, G, K, rho_g[0], rho_g[1])
    n_cells = nx * ny
    step = FamilyStep(fn, closure=dict(dt=torch.tensor(0.1, **kw)))
    return step, carry, consts, 23 * n_cells * WORD_BYTES, n_cells


# --------------------------------------------------------------------------
# 2D multi-phase VEP (shearband config): fused center+vertex stress update
# --------------------------------------------------------------------------
class VEP2DCarry(NamedTuple):
    Vx: Tensor
    Vy: Tensor
    theta: Tensor
    txx: Tensor
    tyy: Tensor
    txy_c: Tensor
    txy_v: Tensor
    eta: Tensor
    eta_v: Tensor
    lam: Tensor
    lam_v: Tensor


def vep2d(n=512, dtype=torch.float32, device=None):
    """One PT iteration of the flagship multi-phase VEP solve
    (``solvers/stokes2d_vep.py``'s iteration): ∇V → compressible P → strain
    rate → fused center+vertex return mapping → τII viscosity → V update.

    Traffic (N = nx·ny; vertex arrays counted as N):
      unknowns (R+W): Vx, Vy, θ, τxx, τyy, τxy_c, τxy_v, η, λ, λv → 20·N
      write-only    : τII, η_vep, P, ε_pl×3, ε_vol_pl, RP       →  8·N
      read-only     : τ_o×4, EII, P0, Q, phase_c×2, phase_v×2   → 11·N
    A_eff = 39·N·4 B.
    """
    from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs
    from justrelax_tpu_torch.core.grid import Geometry
    from justrelax_tpu_torch.core.state import StokesState
    from justrelax_tpu_torch.ops import stokes as k
    from justrelax_tpu_torch.ops.bc import flow_bcs
    from justrelax_tpu_torch.ops.stencil import maxloc
    from justrelax_tpu_torch.ops.stokes_vep import update_stresses_center_vertex
    from justrelax_tpu_torch.rheology.materials import (
        Material,
        MaterialStack,
        get_bulk_modulus,
        get_shear_modulus,
    )
    from justrelax_tpu_torch.rheology.viscosity import compute_viscosity_fields

    kw = _kw(dtype, device)
    ni = (n, n)
    geometry = Geometry(ni, (1.0, 1.0))
    xci, xvi = geometry.xci, geometry.xvi
    C = 1.6 / math.cos(math.radians(30.0))
    common = dict(rho0=0.0, Kb=4.0, eta0=1.0, is_plastic=1.0, C=C,
                  friction_angle=30.0, dilation_angle=0.0, eta_reg=8.0e-3)
    material = MaterialStack.make([Material(G=1.0, **common), Material(G=0.5, **common)],
                                  **kw)

    def circle(xs, ys):
        X, Y = np.meshgrid(np.asarray(xs), np.asarray(ys), indexing="ij")
        inside = (X - 0.5) ** 2 + (Y - 0.5) ** 2 <= 0.01
        ratios = np.zeros(X.shape + (2,), np.float64)
        ratios[..., 0] = ~inside
        ratios[..., 1] = inside
        return _t(ratios, kw)

    pr_c = circle(xci[0], xci[1])
    pr_v = circle(xvi[0], xvi[1])
    stokes = StokesState.make(ni, **kw)
    pt = PTStokesCoeffs.make(geometry.li, geometry.di, CFL=0.75 / math.sqrt(2.1))
    bc = _free_slip(2)
    xv = _t(xvi[0], kw)
    yv = _t(xvi[1], kw)
    Vx = xv[:, None].expand(n + 1, n + 2).contiguous()
    Vy = (-yv)[None, :].expand(n + 2, n + 1).contiguous()
    inv_dx, inv_dy = 1.0 / geometry.di[0], 1.0 / geometry.di[1]
    r, theta_dtau, etadtau = pt.r, pt.theta_dtau, pt.etadtau

    def fn(n_iter, carry, consts, material, pr_c, pr_v, K_c, G_c, dt):
        P0, Q, txx_o, tyy_o, txy_c_o, txy_v_o, EII = consts
        c = carry
        for _ in range(n_iter):
            eta_tau = maxloc(c.eta, window=1)
            grad_V = k.compute_grad_V(c.Vx, c.Vy, inv_dx, inv_dy)
            _, theta = k.compute_P(c.theta, P0, grad_V, Q, eta_tau, K_c, G_c, dt, r,
                                   theta_dtau)
            exx, eyy, exy = k.compute_strain_rate(grad_V, c.Vx, c.Vy, inv_dx, inv_dy)
            res = update_stresses_center_vertex(
                exx, eyy, exy, c.txx, c.tyy, c.txy_c, c.txy_v,
                txx_o, tyy_o, txy_c_o, txy_v_o, theta, c.eta, c.lam, c.lam_v, EII,
                material, pr_c, pr_v, 0.2, dt, theta_dtau)
            eta, eta_v = compute_viscosity_fields(
                c.eta, c.eta_v, material, res.txx, res.tyy, res.txy_c,
                torch.zeros_like(c.eta_v), torch.zeros_like(c.eta_v), res.txy_v,
                pr_c, pr_v, mode="tau", relaxation=1.0e-2)
            Vx, Vy = k.compute_V(c.Vx, c.Vy, res.P_corrected, res.txx, res.tyy, res.txy_v,
                                 etadtau, torch.zeros_like(P0), torch.zeros_like(P0),
                                 eta_tau, inv_dx, inv_dy)
            Vx, Vy = flow_bcs((Vx, Vy), bc)
            c = VEP2DCarry(Vx=Vx, Vy=Vy, theta=theta, txx=res.txx, tyy=res.tyy,
                           txy_c=res.txy_c, txy_v=res.txy_v, eta=eta, eta_v=eta_v,
                           lam=res.lam, lam_v=res.lam_v)
        return c

    carry = VEP2DCarry(
        Vx=Vx, Vy=Vy, theta=stokes.P, txx=stokes.tau.xx, tyy=stokes.tau.yy,
        txy_c=stokes.tau.xy_c, txy_v=stokes.tau.xy,
        eta=torch.ones(ni, **kw), eta_v=torch.ones((n + 1, n + 1), **kw),
        lam=torch.zeros(ni, **kw), lam_v=torch.zeros((n + 1, n + 1), **kw),
    )
    consts = (stokes.P0, stokes.Q, stokes.tau_o.xx, stokes.tau_o.yy, stokes.tau_o.xy_c,
              stokes.tau_o.xy, stokes.EII_pl)
    closure = dict(material=material, pr_c=pr_c, pr_v=pr_v,
                   K_c=get_bulk_modulus(material, pr_c), G_c=get_shear_modulus(material, pr_c),
                   dt=torch.tensor(0.25, **kw))
    n_cells = n * n
    return FamilyStep(fn, closure), carry, consts, 39 * n_cells * WORD_BYTES, n_cells


# --------------------------------------------------------------------------
# 2D and 3D PT thermal diffusion
# --------------------------------------------------------------------------
def _thermal_family(ni, dtype, device):
    """thermal2d/thermal3d: the constant-coefficient PT diffusion iteration
    on ``ni`` cells over 100 km per axis."""
    from justrelax_tpu_torch.core.coeffs import PTThermalCoeffs
    from justrelax_tpu_torch.ops import thermal as k
    from justrelax_tpu_torch.ops.bc import Faces, TemperatureBoundaryConditions, thermal_bcs

    kw = _kw(dtype, device)
    ndim = len(ni)
    li = (100.0e3,) * ndim
    di = tuple(l / n for l, n in zip(li, ni))
    inv_di = tuple(1.0 / d for d in di)
    K = torch.full(ni, 3.0, **kw)
    rho_Cp = torch.full(ni, 3.3e6, **kw)
    dt = 1.5e11
    coeffs = PTThermalCoeffs.make(K, rho_Cp, dt, di, li)
    rng = np.random.default_rng(0)
    T = _t(1500.0 + 10.0 * rng.normal(size=tuple(x + 2 for x in ni)), kw)
    H = torch.zeros(ni, **kw)
    no_flux = dict(left=True, right=True)
    if ndim == 3:
        no_flux.update(front=True, back=True)
    bcs = TemperatureBoundaryConditions(no_flux=Faces(**no_flux),
                                        constant_value=Faces(top=True, bot=True))
    inv_dt = 1.0 / dt

    def fn(n_iter, carry, consts, theta_r_dtau, dtau_rho):
        Told, K, rho_Cp, H = consts
        T, q, q2 = carry
        for _ in range(n_iter):
            q, q2 = k.compute_flux(q, q2, T, inv_di, theta_r_dtau, bcs.constant_flux, K=K)
            T = k.update_T(T, Told, q, H, H, inv_dt, inv_di, dtau_rho, rho_Cp=rho_Cp)
            T = thermal_bcs(T, bcs)
        return (T, q, q2)

    q = tuple(torch.zeros(tuple(n + (a == b) for b, n in enumerate(ni)), **kw)
              for a in range(ndim))
    carry = (T, q, q)
    consts = (T, K, rho_Cp, H)
    closure = dict(theta_r_dtau=coeffs.theta_r_dtau.to(dtype),
                   dtau_rho=coeffs.dtau_rho.to(dtype))
    return FamilyStep(fn, closure), carry, consts, math.prod(ni)


def thermal2d(nx=1024, ny=1024, dtype=torch.float32, device=None):
    """One PT heat-diffusion iteration (flux relaxation + damped T update +
    ghost BCs), constant-coefficient variant.

    Traffic: unknowns (R+W) T, qx, qy, q2x, q2y → 10·N; read-only Told, K,
    θr_dτ, dτ_ρ, ρCp, H → 6·N. A_eff = 16·N·4 B.
    """
    step, carry, consts, n_cells = _thermal_family((nx, ny), dtype, device)
    return step, carry, consts, 16 * n_cells * WORD_BYTES, n_cells


def thermal3d(n=126, dtype=torch.float32, device=None):
    """One 3D PT heat-diffusion iteration: the same ops as ``thermal2d``
    (``ops/thermal.py`` is dimension-agnostic), 3D shapes.

    Traffic: unknowns (R+W) T, q×3, q2×3 → 14·N; read-only Told, K,
    θr_dτ, dτ_ρ, ρCp, H → 6·N. A_eff = 20·N·4 B.
    """
    step, carry, consts, n_cells = _thermal_family((n, n, n), dtype, device)
    return step, carry, consts, 20 * n_cells * WORD_BYTES, n_cells


# --------------------------------------------------------------------------
# 3D visco-elastic Stokes
# --------------------------------------------------------------------------
def _ve3d_fields(n, kw):
    """η = exp(0.3·N(0, 1)) and fz ~ N(0, 1) (seed 0) at n³, the 3D VE
    families' fields."""
    rng = np.random.default_rng(0)
    eta = _t(np.exp(0.3 * rng.normal(size=(n, n, n))), kw)
    fz = _t(rng.normal(size=(n, n, n)), kw)
    return eta, fz


def _edge_zeros(n, kw):
    return (torch.zeros((n, n + 1, n + 1), **kw), torch.zeros((n + 1, n, n + 1), **kw),
            torch.zeros((n + 1, n + 1, n), **kw))


def ve3d(n=126, dtype=torch.float32, device=None):
    """One 3D VE Stokes PT iteration (``solvers/stokes3d.py``'s iteration).

    Traffic: unknowns (R+W) V×3, P, τ×6 → 20·N; read-only η, ητ, G, K, P0,
    Q, f×3, τ_o×6 → 15·N. A_eff = 35·N·4 B.
    """
    from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs
    from justrelax_tpu_torch.core.grid import Geometry
    from justrelax_tpu_torch.ops import stokes3d as k3
    from justrelax_tpu_torch.ops.bc import flow_bcs
    from justrelax_tpu_torch.ops.stencil import maxloc
    from justrelax_tpu_torch.ops.stokes import compute_P

    kw = _kw(dtype, device)
    ni = (n, n, n)
    geometry = Geometry(ni, (1.0, 1.0, 1.0))
    inv_di = tuple(1.0 / d for d in geometry.di)
    pt = PTStokesCoeffs.make(geometry.li, geometry.di)
    r, theta_dtau, etadtau = pt.r, pt.theta_dtau, pt.etadtau
    bc = _free_slip(3)
    eta, fz = _ve3d_fields(n, kw)
    Z = torch.zeros(ni, **kw)
    G = torch.full(ni, math.inf, **kw)
    K = torch.full(ni, math.inf, **kw)

    def fn(n_iter, carry, consts, dt):
        P0, Q, eta, G, K, fx, fy, fz, tau_o = consts
        eta_tau = maxloc(eta, window=1)
        (Vx, Vy, Vz), P, tau = carry
        for _ in range(n_iter):
            grad_V = k3.compute_grad_V_3d(Vx, Vy, Vz, inv_di)
            _, P = compute_P(P, P0, grad_V, Q, eta_tau, K, G, dt, r, theta_dtau)
            eps = k3.compute_strain_rate_3d(grad_V, Vx, Vy, Vz, inv_di)
            tau = k3.compute_tau_ve_3d(tau, tau_o, eps, eta, G, theta_dtau, dt)
            Vx, Vy, Vz, _, _, _ = k3.compute_V_3d(Vx, Vy, Vz, P, tau, fx, fy, fz, eta_tau,
                                                  etadtau, inv_di)
            Vx, Vy, Vz = flow_bcs((Vx, Vy, Vz), bc)
        return ((Vx, Vy, Vz), P, tau)

    V = (torch.zeros((n + 1, n + 2, n + 2), **kw), torch.zeros((n + 2, n + 1, n + 2), **kw),
         torch.zeros((n + 2, n + 2, n + 1), **kw))
    tau = (Z, Z, Z) + _edge_zeros(n, kw)
    carry = (V, Z, tau)
    consts = (Z, Z, eta, G, K, Z, Z, fz, tau)
    n_cells = n * n * n
    step = FamilyStep(fn, closure=dict(dt=torch.tensor(math.inf, **kw)))
    return step, carry, consts, 35 * n_cells * WORD_BYTES, n_cells


def _vep3d_config(n, kw):
    """The 3D VEP families' set-up (ShearBand3D-like, at n³): geometry,
    material, phase ratios, the inclusion mask, PT coefficients and the
    free-slip pure-shear velocities."""
    from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs
    from justrelax_tpu_torch.core.grid import Geometry
    from justrelax_tpu_torch.ops.bc import flow_bcs
    from justrelax_tpu_torch.rheology.materials import Material, MaterialStack
    from justrelax_tpu_torch.rheology.phases import phase_ratios_from_field

    ni = (n, n, n)
    geometry = Geometry(ni, (1.0, 1.0, 1.0))
    C = 1.6 / math.cos(math.radians(30.0))
    common = dict(rho0=0.0, Kb=4.0, is_plastic=1.0, C=C,
                  friction_angle=30.0, dilation_angle=0.0, eta_reg=1.25e-2)
    material = MaterialStack.make([Material(G=1.0, eta0=1.0, **common),
                                   Material(G=0.5, eta0=0.1, **common)], **kw)
    X, Y, Zc = np.meshgrid(*[np.asarray(c) for c in geometry.xci], indexing="ij")
    inside = (X - 0.5) ** 2 + (Y - 0.5) ** 2 + (Zc - 0.5) ** 2 <= 0.01
    pr = phase_ratios_from_field(torch.as_tensor(inside.astype(np.int64), device=kw["device"]),
                                 2, dtype=kw["dtype"])
    pt = PTStokesCoeffs.make(geometry.li, geometry.di, CFL=0.75 / math.sqrt(3.1))
    xv = _t(geometry.xvi[0], kw)
    zv = _t(geometry.xvi[2], kw)
    V = flow_bcs((xv[:, None, None].expand(n + 1, n + 2, n + 2),
                  torch.zeros((n + 2, n + 1, n + 2), **kw),
                  (-zv)[None, None, :].expand(n + 2, n + 2, n + 1)), _free_slip(3))
    eta0 = _t(np.where(inside, 0.1, 1.0), kw)
    return geometry, material, pr, pt, V, eta0


class VEP3DCarry(NamedTuple):
    V: Any
    theta: Tensor
    P: Tensor
    tau_c: Any
    tau_e: Any
    eta: Tensor
    lam: Tensor
    lam_e: Any


def vep3d(n=126, dtype=torch.float32, probe_passes=None, hoist_params=True, device=None):
    """One PT iteration of the 3D multi-phase VEP solve
    (``solvers/stokes3d_vep.py``'s iteration, ShearBand3D config): maxloc →
    compressible θ → strain rate → fused center+edges return mapping (3
    shear-edge families) → τII viscosity continuation → damped V update +
    free slip. ``hoist_params`` builds ``make_vep_params_3d`` once per step
    call, as the solver does once per solve; ``probe_passes`` is passed to
    ``update_stresses_center_edges_3d``.

    Traffic (N = n³; staggered/edge arrays counted as N):
      unknowns (R+W): V×3, θ, P, τ_c×6, τ_e×3, η, λ, λ_e×3 → 36·N
      write-only    : τII, η_vep, ε_pl 6+3, ε_vol_pl, RP     → 13·N
      read-only     : τ_o 6+3, EII, P0, Q, K, G, phase ratios (c + 3
                      edges, 2 phases) 8·N                   → 22·N
    A_eff = 71·N·4 B.
    """
    from justrelax_tpu_torch.ops import stokes3d as k3
    from justrelax_tpu_torch.ops.bc import flow_bcs
    from justrelax_tpu_torch.ops.stencil import maxloc
    from justrelax_tpu_torch.ops.stokes import compute_P
    from justrelax_tpu_torch.ops.stokes3d_vep import (
        _inv_II,
        make_vep_params_3d,
        update_stresses_center_edges_3d,
    )
    from justrelax_tpu_torch.rheology.materials import get_bulk_modulus, get_shear_modulus
    from justrelax_tpu_torch.rheology.viscosity import continuation_linear, phase_viscosity

    kw = _kw(dtype, device)
    ni = (n, n, n)
    geometry, material, pr, pt, V, eta0 = _vep3d_config(n, kw)
    inv_di = tuple(1.0 / d for d in geometry.di)
    r, theta_dtau, etadtau = pt.r, pt.theta_dtau, pt.etadtau
    bc = _free_slip(3)

    def fn(n_iter, carry, consts, material, pr_c, pr_edges, K_c, G_c, dt):
        P0, Q, tau_o_c6, tau_o_e3, EII_pl = consts
        vp = make_vep_params_3d(material, EII_pl, pr_c, pr_edges, tau_o_c6,
                                tau_o_e3) if hoist_params else None
        c = carry
        for _ in range(n_iter):
            Vx, Vy, Vz = c.V
            eta_tau = maxloc(c.eta, window=1)
            grad_V = k3.compute_grad_V_3d(Vx, Vy, Vz, inv_di)
            _, theta = compute_P(c.theta, P0, grad_V, Q, eta_tau, K_c, G_c, dt, r, theta_dtau)
            eps = k3.compute_strain_rate_3d(grad_V, Vx, Vy, Vz, inv_di)
            res = update_stresses_center_edges_3d(
                eps[:3], eps[3:], c.tau_c, c.tau_e, tau_o_c6, tau_o_e3,
                theta, c.eta, c.lam, c.lam_e, EII_pl,
                material, pr_c, pr_edges, 0.2, dt, theta_dtau,
                probe_passes=probe_passes, params=vp)
            tII = _inv_II(res.tau_c)
            eta_n = phase_viscosity(material, tII, None, pr_c, "tau")
            eta = continuation_linear(eta_n, c.eta, 1.0e-2)
            tau6 = tuple(res.tau_c[:3]) + tuple(res.tau_e)
            z = torch.zeros_like(theta)
            Vx, Vy, Vz, _, _, _ = k3.compute_V_3d(Vx, Vy, Vz, res.P_corrected, tau6, z, z, z,
                                                  eta_tau, etadtau, inv_di)
            Vx, Vy, Vz = flow_bcs((Vx, Vy, Vz), bc)
            c = VEP3DCarry(V=(Vx, Vy, Vz), theta=theta, P=res.P_corrected,
                           tau_c=tuple(res.tau_c), tau_e=tuple(res.tau_e), eta=eta,
                           lam=res.lam, lam_e=tuple(res.lam_e))
        return c

    Z = torch.zeros(ni, **kw)
    edges = _edge_zeros(n, kw)
    # elastic memory near yield so that the plastic branch is active
    txx_o = torch.full(ni, 1.0, **kw)
    carry = VEP3DCarry(V=V, theta=Z, P=Z, tau_c=(Z,) * 6, tau_e=edges, eta=eta0, lam=Z,
                       lam_e=edges)
    consts = (Z, Z, (txx_o, -txx_o, Z, Z, Z, Z), edges, Z)
    pr_edges = (pr.edge_yz, pr.edge_xz, pr.edge_xy)
    closure = dict(material=material, pr_c=pr.center, pr_edges=pr_edges,
                   K_c=get_bulk_modulus(material, pr.center),
                   G_c=get_shear_modulus(material, pr.center), dt=torch.tensor(0.125, **kw))
    n_cells = n * n * n
    return FamilyStep(fn, closure), carry, consts, 71 * n_cells * WORD_BYTES, n_cells


# --------------------------------------------------------------------------
# kernel families
# --------------------------------------------------------------------------
def _viscous_2d_family(n, dtype, device):
    """pallas_ve2d/pallas_ve2d_blocked: B1/B4 in the viscous limit on the
    SolCx set-up."""
    from justrelax_tpu_torch.ops import hopper_stokes as hs
    from justrelax_tpu_torch.ops.stencil import maxloc

    kw = _kw(dtype, device)
    geometry, stokes, pt, _, rho_g, _, _ = _solcx_setup(n, n, kw)
    inv_dx, inv_dy = 1.0 / geometry.di[0], 1.0 / geometry.di[1]
    r, theta_dtau, etadtau = pt.r, pt.theta_dtau, pt.etadtau
    eta = stokes.viscosity.eta

    def fn(n_iter, carry, consts, plain=False):
        chunk = hs.stokes_chunk_reference if plain else hs.stokes_chunk
        eta, eta_tau, gx, gy = consts
        return chunk(*carry, eta, eta_tau, gx, gy, inv_dx, inv_dy, r, theta_dtau, etadtau,
                     nout=n_iter)

    Z = torch.zeros((n, n), **kw)
    carry = (torch.zeros((n + 1, n + 2), **kw), torch.zeros((n + 2, n + 1), **kw),
             Z, Z, Z, torch.zeros((n + 1, n + 1), **kw))
    consts = (eta, maxloc(eta, window=1), rho_g[0], rho_g[1])
    n_cells = n * n
    step = FamilyStep(fn, kernel="stokes_chunk")
    return step, carry, consts, 16 * n_cells * WORD_BYTES, n_cells


def pallas_ve2d(n=382, dtype=torch.float32, device=None):
    """B1 (``stokes_chunk``): the whole ``n``-iteration chunk in the tiled
    kernel, one launch per iteration (viscous SolCx config).

    Traffic convention: the viscous iteration's necessary traffic is
    A_eff = 16·N·4 B (unknowns Vx, Vy, P, τxx, τyy, τxy R+W → 12·N;
    read-only η, ητ, ρgx, ρgy → 4·N), smaller than ve2d's 23·N because the
    viscous limit reads no G/K/P0/Q/τ_o. GUPS is the convention-free
    comparison against ve2d. n = 382 is JAX's largest VMEM-resident size;
    the card's kernel has no residency limit."""
    return _viscous_2d_family(n, dtype, device)


def pallas_ve2d_blocked(n=1024, dtype=torch.float32, device=None):
    """B4 at the production grid: on the card the same kernel as
    ``pallas_ve2d`` (``stokes_chunk`` has one route), same 16·N·4 B
    convention."""
    return _viscous_2d_family(n, dtype, device)


def _vep2d_kernel_family(n, dtype, device):
    """pallas_vep2d/pallas_vep2d_blocked: B2/B3 on the shear band set-up
    with old stresses near yield."""
    from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs
    from justrelax_tpu_torch.core.grid import Geometry
    from justrelax_tpu_torch.models.shearband import _circle_phase_ratios
    from justrelax_tpu_torch.ops import hopper_stokes_vep as hv
    from justrelax_tpu_torch.ops.bc import flow_bcs
    from justrelax_tpu_torch.rheology.materials import Material, MaterialStack
    from justrelax_tpu_torch.rheology.viscosity import phase_viscosity

    kw = _kw(dtype, device)
    ni = (n, n)
    geometry = Geometry(ni, (1.0, 1.0))
    xci, xvi = geometry.xci, geometry.xvi
    C = 1.6 / math.cos(math.radians(30.0))
    common = dict(rho0=0.0, Kb=5.0, eta0=1.0, is_plastic=1.0, C=C,
                  friction_angle=30.0, dilation_angle=0.0, eta_reg=1e-2)
    material = MaterialStack.make([Material(G=1.0, **common), Material(G=0.5, **common)],
                                  **kw)
    pr_c = _t(_circle_phase_ratios(xci[0], xci[1], (0.5, 0.5), 0.1), kw)
    pr_v = _t(_circle_phase_ratios(xvi[0], xvi[1], (0.5, 0.5), 0.1), kw)
    xv = _t(xvi[0], kw)
    yv = _t(xvi[1], kw)
    Vx, Vy = flow_bcs((xv[:, None].expand(n + 1, n + 2), (-yv)[None, :].expand(n + 2, n + 1)),
                      _free_slip(2))
    pt = PTStokesCoeffs.make(geometry.li, geometry.di, CFL=0.75 / math.sqrt(2.1))
    inv_dx, inv_dy = 1.0 / geometry.di[0], 1.0 / geometry.di[1]
    Zv = torch.zeros((n + 1, n + 1), **kw)
    # elastic memory near yield so that the plastic branch is active
    txx_o = torch.full(ni, 1.6, **kw)
    tyy_o = -txx_o
    txy_c_o = torch.full(ni, 1.0, **kw)
    txy_v_o = torch.full((n + 1, n + 1), 1.0, **kw)
    eta = phase_viscosity(material, torch.ones(ni, **kw), None, pr_c, "tau").to(dtype)
    eta_v = phase_viscosity(material, torch.ones((n + 1, n + 1), **kw), None, pr_v,
                            "tau").to(dtype)
    scal = (0.25, inv_dx, inv_dy, pt.r, pt.theta_dtau, pt.etadtau, 0.2, 1.0,
            (-math.inf, math.inf))

    def fn(n_iter, carry, consts, material, pr_c, pr_v, Z, Zv, plain=False):
        chunk = hv.stokes_vep_chunk_reference if plain else hv.stokes_vep_chunk
        txx_o, tyy_o, txy_c_o, txy_v_o, eta, eta_v = consts
        return chunk(carry[0], carry[1], Z, Z, txx_o, tyy_o, txy_c_o, txy_v_o,
                     eta, eta_v, Z, Zv,
                     Z, Z, txx_o, tyy_o, txy_c_o, txy_v_o, Z,
                     material, pr_c, pr_v, None, *scal, nout=n_iter)

    carry = (Vx, Vy)
    consts = (txx_o, tyy_o, txy_c_o, txy_v_o, eta, eta_v)
    closure = dict(material=material, pr_c=pr_c, pr_v=pr_v, Z=torch.zeros(ni, **kw), Zv=Zv)
    n_cells = n * n
    step = FamilyStep(fn, closure, kernel="stokes_vep_chunk")
    return step, carry, consts, 39 * n_cells * WORD_BYTES, n_cells


def pallas_vep2d(n=382, dtype=torch.float32, device=None):
    """B2 (``stokes_vep_chunk``): the flagship multi-phase VEP iteration
    (maxloc, compressible P, fused center+vertex Drucker-Prager return
    mapping, viscosity continuation, damped V update, free slip) in the
    tiled kernel, one launch per iteration, shear band config with old
    stresses near yield. Same 39·N·4 B convention as ``vep2d``. The step
    returns the 12 VEP fields from its ``(Vx, Vy)`` carry."""
    return _vep2d_kernel_family(n, dtype, device)


def pallas_vep2d_blocked(n=1024, dtype=torch.float32, row_block=None, iters_per_pass=None,
                         device=None):
    """B3 at the production grid: on the card the same kernel as
    ``pallas_vep2d`` (``stokes_vep_chunk`` has one route). Same 39·N·4 B
    convention as ``vep2d``. ``row_block``/``iters_per_pass`` (the TPU
    kernel's VMEM row blocks) stay at their defaults."""
    _tpu_only(row_block=(row_block, None), iters_per_pass=(iters_per_pass, None))
    return _vep2d_kernel_family(n, dtype, device)


def pallas_thermal2d(n=766, dtype=torch.float32, device=None):
    """B5 (``thermal_chunk``): the PT diffusion iteration (flux relaxation +
    damped T update + ghost BCs) in the kernel, two launches per iteration;
    constant_value top 1500 / bottom 1600, no_flux left/right. Same 16·N·4 B
    convention as ``thermal2d``. ``step.setup`` holds the geometry, BCs, dt
    and ``PTThermalCoeffs`` for ``heatdiffusion_PT`` on the same set-up."""
    from justrelax_tpu_torch.core.coeffs import PTThermalCoeffs
    from justrelax_tpu_torch.core.grid import Geometry
    from justrelax_tpu_torch.ops import hopper_thermal as ht
    from justrelax_tpu_torch.ops.bc import Faces, TemperatureBoundaryConditions, thermal_bcs

    kw = _kw(dtype, device)
    ni = (n, n)
    geometry = Geometry(ni, (100.0e3, 100.0e3))
    inv_d = 1.0 / geometry.di[0]
    K = torch.full(ni, 3.0, **kw)
    rho_Cp = torch.full(ni, 3.3e6, **kw)
    dt = 1.5e11
    coeffs = PTThermalCoeffs.make(K, rho_Cp, dt, geometry.di, geometry.li)
    rng = np.random.default_rng(0)
    bcs = TemperatureBoundaryConditions(no_flux=Faces(left=True, right=True),
                                        constant_value=Faces(top=1500.0, bot=1600.0))
    T = thermal_bcs(_t(1500.0 + 10.0 * rng.normal(size=(n + 2, n + 2)), kw), bcs)

    def fn(n_iter, carry, consts, dtau_rho, theta_r_dtau, plain=False):
        chunk = ht.thermal_chunk_reference if plain else ht.thermal_chunk
        Told, K, rho_Cp, H = consts
        return chunk(*carry, Told, K, rho_Cp, H, dtau_rho, theta_r_dtau, 1.0 / dt,
                     inv_d, inv_d, bcs, nout=n_iter)

    carry = (T, torch.zeros((n + 1, n), **kw), torch.zeros((n, n + 1), **kw))
    consts = (T, K, rho_Cp, torch.zeros(ni, **kw))
    closure = dict(dtau_rho=coeffs.dtau_rho.to(dtype), theta_r_dtau=coeffs.theta_r_dtau.to(dtype))
    step = FamilyStep(fn, closure, kernel="thermal_chunk",
                      setup=dict(geometry=geometry, bcs=bcs, dt=dt, coeffs=coeffs))
    n_cells = n * n
    return step, carry, consts, 16 * n_cells * WORD_BYTES, n_cells


def _ve3d_canvas_inputs(n, kw):
    """The 3D VE canvas families' inputs at n³: (carry as 10 canvases,
    viscous coefficient canvases, η, ητ, inv_di, PT coefficients)."""
    from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs
    from justrelax_tpu_torch.core.grid import Geometry
    from justrelax_tpu_torch.ops.stencil import maxloc
    from justrelax_tpu_torch.ops.stokes3d_canvas import pack_carry, ve3d_canvas_coefficients

    ni = (n, n, n)
    geometry = Geometry(ni, (1.0, 1.0, 1.0))
    inv_di = tuple(1.0 / d for d in geometry.di)
    pt = PTStokesCoeffs.make(geometry.li, geometry.di)
    eta, fz = _ve3d_fields(n, kw)
    Z3 = torch.zeros(ni, **kw)
    eta_tau = maxloc(eta, window=1)
    co = ve3d_canvas_coefficients(eta, eta_tau, pt.r, pt.theta_dtau, pt.etadtau,
                                  fx=Z3, fy=Z3, fz=fz)
    fields = (torch.zeros((n + 1, n + 2, n + 2), **kw), torch.zeros((n + 2, n + 1, n + 2), **kw),
              torch.zeros((n + 2, n + 2, n + 1), **kw), Z3, Z3, Z3, Z3) + _edge_zeros(n, kw)
    carry = tuple(pack_carry(*fields))
    return carry, co, eta, eta_tau, inv_di, pt


def ve3d_canvas(n=126, dtype=torch.float32, lean=False, shift="slice", device=None):
    """Collocated-canvas 3D VE iteration (``ops/stokes3d_canvas.py``), same
    physics config and 35·N·4 B convention as ``ve3d``. ``lean`` (JAX's
    in-loop re-derivation of the coefficient canvases) and ``shift`` (its
    neighbor-shift lowering) are TPU choices and stay at their defaults."""
    from justrelax_tpu_torch.ops.stokes3d_canvas import stokes3d_chunk_canvas

    _tpu_only(lean=(lean, False), shift=(shift, "slice"))
    carry, co, _, _, inv_di, _ = _ve3d_canvas_inputs(n, _kw(dtype, device))

    def fn(n_iter, carry, consts):
        return stokes3d_chunk_canvas(carry, consts, inv_di, n_iter)

    n_cells = n * n * n
    return FamilyStep(fn), carry, co, 35 * n_cells * WORD_BYTES, n_cells


def pallas_ve3d_blocked(n=126, dtype=torch.float32, plane_block=None, iters_per_pass=None,
                        pipeline=False, y_block=None, device=None):
    """B7 (``stokes3d_chunk``): the 3D VE iteration in the kernel, one
    launch per iteration marching along x, same physics config and 35·N·4 B
    convention as ``ve3d``/``ve3d_canvas``. The step packs the coefficient
    canvases (``pack_coeffs``, the varying ones derived in the kernel from η
    and ητ, ``step.closure``) once per call. ``plane_block``,
    ``iters_per_pass``, ``pipeline`` and ``y_block`` (the TPU kernel's VMEM
    blocking) stay at their defaults."""
    from justrelax_tpu_torch.ops import hopper_stokes3d as h3

    _tpu_only(plane_block=(plane_block, None), iters_per_pass=(iters_per_pass, None),
              pipeline=(pipeline, False), y_block=(y_block, None))
    carry, co, eta, eta_tau, inv_di, pt = _ve3d_canvas_inputs(n, _kw(dtype, device))
    scalars = (pt.r / pt.theta_dtau, pt.theta_dtau, pt.etadtau)

    def fn(n_iter, carry, consts, eta, eta_tau, plain=False):
        if plain:
            return h3.stokes3d_chunk_reference(carry, consts, inv_di, n_iter)
        packed = h3.pack_coeffs(consts, derive_from=(eta, eta_tau, scalars))
        return h3.stokes3d_chunk(carry, packed, inv_di, n_iter)

    step = FamilyStep(fn, dict(eta=eta, eta_tau=eta_tau), kernel="stokes3d_chunk",
                      setup=dict(inv_di=inv_di, pt_scalars=scalars))
    n_cells = n * n * n
    return step, carry, co, 35 * n_cells * WORD_BYTES, n_cells


def vep2d_1024(dtype=torch.float32, device=None):
    """The flagship plain VEP iteration at the production grid, 1024²
    (``vep2d``'s config); beside ``pallas_vep2d_blocked`` at the same size."""
    return vep2d(n=1024, dtype=dtype, device=device)


def vep3d_canvas(n=126, dtype=torch.float32, blocked=False, edges=False,
                 plane_block=None, iters_per_pass=None, y_block=None,
                 nvals=None, edges_nvals=None, device=None):
    """Collocated-canvas 3D VEP iteration (``ops/stokes3d_vep_canvas.py``),
    same physics config and 71·N·4 B convention as ``vep3d``; the return
    mapping is the same ``update_stresses_center_edges_3d``.

    ``blocked=True`` (the ``pallas_vep3d_blocked`` family) runs B8
    (``stokes3d_vep_chunk``: three launches per iteration) on consts with
    scalar plastic parameters and bulk modulus. ``edges=True``
    (``pallas_vep3d_edges``) runs the hybrid iteration with B6 as its edge
    passes, ``edges="split"`` (``pallas_vep3d_split``) with B9 on the hoisted
    τ_o interpolants; the step packs the edge consts once per call.
    ``plane_block``, ``iters_per_pass``, ``y_block``, ``nvals`` and
    ``edges_nvals`` (the TPU kernels' VMEM blocking) stay at their
    defaults. The consts carry every material property the chunk reads, so
    the step passes no material; ``step.setup`` holds ``inv_di``, the chunk
    keywords (``kw``) and the ``material``."""
    from justrelax_tpu_torch.ops import hopper_stokes3d_vep as hc
    from justrelax_tpu_torch.ops import hopper_vep3d_edges as he
    from justrelax_tpu_torch.ops.stokes3d_vep_canvas import (
        pack_vep_carry,
        vep3d_canvas_consts,
        vep3d_chunk_canvas,
    )

    _tpu_only(plane_block=(plane_block, None), iters_per_pass=(iters_per_pass, None),
              y_block=(y_block, None), nvals=(nvals, None), edges_nvals=(edges_nvals, None))
    kw = _kw(dtype, device)
    ni = (n, n, n)
    geometry, material, pr, pt, V, eta0 = _vep3d_config(n, kw)
    inv_di = tuple(1.0 / d for d in geometry.di)
    Z = torch.zeros(ni, **kw)
    edges_z = _edge_zeros(n, kw)
    txx_o = torch.full(ni, 1.0, **kw)
    carry = pack_vep_carry(V, Z, Z, (Z,) * 6, edges_z, eta0, Z, edges_z)
    scalar_consts = bool(blocked or edges)
    co = vep3d_canvas_consts(
        material, (txx_o, -txx_o, Z, Z, Z, Z), edges_z, Z, Z, Z,
        pr.center, (pr.edge_yz, pr.edge_xz, pr.edge_xy),
        hoist_tau_o=(edges == "split") or not scalar_consts,
        scalar_plastic=scalar_consts, scalar_K=scalar_consts)
    ckw = dict(dt=0.125, r=pt.r, theta_dtau=pt.theta_dtau, etadtau=pt.etadtau,
               lambda_relaxation=0.2, viscosity_relaxation=1.0e-2)
    # the consts hold every material property the chunk reads
    setup = dict(inv_di=inv_di, kw=ckw, material=material)

    if blocked:
        def fn(n_iter, carry, consts, plain=False):
            chunk = hc.stokes3d_vep_chunk_reference if plain else hc.stokes3d_vep_chunk
            return chunk(carry, consts, inv_di, n_iter, **ckw)

        step = FamilyStep(fn, kernel="stokes3d_vep_chunk", setup=setup)
    elif edges:
        split = edges == "split"

        def fn(n_iter, carry, consts, plain=False):
            edge = he.vep3d_edges_reference if plain else he.vep3d_edges
            packed = he.pack_edge_consts(consts, split)
            return vep3d_chunk_canvas(carry, consts, None, inv_di, n_iter,
                                      edges_fn=functools.partial(edge, co=packed, split=split),
                                      **ckw)

        step = FamilyStep(fn, kernel="vep3d_edges_split" if split else "vep3d_edges",
                          setup=setup)
    else:
        def fn(n_iter, carry, consts):
            return vep3d_chunk_canvas(carry, consts, None, inv_di, n_iter, **ckw)

        step = FamilyStep(fn, setup=setup)
    n_cells = n * n * n
    return step, carry, co, 71 * n_cells * WORD_BYTES, n_cells


def pallas_vep3d_blocked(**kw):
    """B8: ``vep3d_canvas(blocked=True)``."""
    return vep3d_canvas(blocked=True, **kw)


def pallas_vep3d_edges(**kw):
    """The hybrid iteration: the three edge return-mapping passes in B6,
    center/θ/viscosity/velocity in plain PyTorch; ``vep3d_canvas(edges=True)``.
    Same 71-canvas convention as ``vep3d``."""
    return vep3d_canvas(edges=True, **kw)


def pallas_vep3d_split(**kw):
    """The hybrid iteration on B9 (the hoisted τ_o interpolants);
    ``vep3d_canvas(edges="split")``. Same 71-canvas convention."""
    return vep3d_canvas(edges="split", **kw)


def ve3d_254(dtype=torch.float32, device=None):
    """The plain 3D VE iteration at 254³ (16.4 M cells)."""
    return ve3d(n=254, dtype=dtype, device=device)


def ve3d_canvas_254(dtype=torch.float32, device=None):
    """The canvas 3D VE iteration at 254³, on the full coefficient canvases
    (JAX's family streams its lean consts; their results are bitwise
    identical by JAX's account)."""
    return ve3d_canvas(n=254, dtype=dtype, device=device)


def pallas_ve3d_blocked_254(dtype=torch.float32, device=None):
    """B7 at 254³."""
    return pallas_ve3d_blocked(n=254, dtype=dtype, device=device)


FAMILIES = {
    "ve2d": ve2d,
    "vep2d": vep2d,
    "vep2d_1024": vep2d_1024,
    "thermal2d": thermal2d,
    "thermal3d": thermal3d,
    "ve3d": ve3d,
    "ve3d_canvas": ve3d_canvas,
    "vep3d": vep3d,
    "vep3d_canvas": vep3d_canvas,
    "ve3d_254": ve3d_254,
    "ve3d_canvas_254": ve3d_canvas_254,
    "pallas_ve3d_blocked_254": pallas_ve3d_blocked_254,
    "pallas_ve2d": pallas_ve2d,
    "pallas_vep3d_blocked": pallas_vep3d_blocked,
    "pallas_vep3d_edges": pallas_vep3d_edges,
    "pallas_vep3d_split": pallas_vep3d_split,
    "pallas_ve2d_blocked": pallas_ve2d_blocked,
    "pallas_ve3d_blocked": pallas_ve3d_blocked,
    "pallas_vep2d": pallas_vep2d,
    "pallas_vep2d_blocked": pallas_vep2d_blocked,
    "pallas_thermal2d": pallas_thermal2d,
}


def make_family(name, **kwargs):
    return FAMILIES[name](**kwargs)


def build_family_on_cpu(name, factory_kwargs=None, device=None):
    """Build a family on the CPU, then move its carry, consts and step
    closure and set-up to ``device`` (the card by default) in one pass; a
    tensor the family holds in several places is moved once. Returns
    ``(step, carry, consts, bytes_per_iter, n_cells)``."""
    kw = dict(factory_kwargs or {})
    kw["device"] = "cpu"
    step, carry, consts, bpi, n_cells = FAMILIES[name](**kw)
    dev = resolve_device(device)
    if dev.type != "cpu":
        memo = {}
        carry, consts = _to(carry, dev, memo), _to(consts, dev, memo)
        step = step.to(dev, memo)
    return step, carry, consts, bpi, n_cells
