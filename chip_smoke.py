#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (justrelax_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printing JSON lines:

0. device   : the card's name and power limit (nvidia-smi).
1. build    : nvcc builds the four Hopper kernel libraries from
              justrelax_tpu_torch/csrc, one nvcc per source, side by side
              (lines "build" for stokes_vep.cu, "build_ve" for stokes_ve.cu,
              "build_thermal" for thermal.cu and "build_ve3d" for
              stokes3d_ve.cu).
2. parity   : the VEP chunk kernel against its plain PyTorch version on the
              card, f64, n=64, nout 1 and 50, in four configurations.
3. golden   : shearband.run(n=32, nt=10, f64) through the kernel against the
              frozen f64 values of the JAX package.
4. main path: one 1024^2 f32 shearband time step through the kernel (the
              production grid), with the launch count read around it; then
              200 iterations kernel vs plain from that step's initial state
              and from a state with old stresses near yield.
5. timing   : per-iteration time of kernel and plain version at 1024^2 f32
              from both states, by CUDA events.
6. parity_ve: the VE chunk kernel against its plain version, f64, n=64,
              nout 1 and 500, in three configurations (SolCx viscous limit,
              VE compressible, elastic build-up).
7. golden_ve: SolCx (Δη 1e6 and 1), SolKz and the elastic build-up at 32²,
              f64, through the default entry points, on the JAX package's
              oracles.
8. main_path_ve: SolCx at 1024^2 f32 through the default entry point (the
              production grid of the VE solve), 20 000 iterations, with the
              launch count read around it; then 200 iterations kernel vs
              plain from its initial state.
9. timing_ve: per-iteration time of the VE kernel and its plain version at
              1024^2 f32, by CUDA events.
10. parity_thermal: the thermal chunk kernel against its plain version, f64,
              n=64, nout 1 and 500, in three configurations (the set-up of
              tests/test_pallas_thermal.py with H and adiabatic; constant
              values on all four faces with shear heating; an insulated box).
11. golden_thermal: heatdiffusion_PT at 32^2 f64 through the default entry
              point against frozen f64 values of the JAX solve;
              diffusion2d.run at 32^2 f64 (plain path by contract) on its
              goldens; blankenbach.run at 32^2 f64, 10 steps, its Stokes
              solve through the VEP kernel, on its goldens.
12. main_path_thermal: heatdiffusion_PT at 1024^2 f32 through the default
              entry point (the production grid of bench_kernels.py's
              thermal2d), 20 000 iterations, with the launch count read around
              it; then 200 iterations kernel vs plain from its initial state.
13. timing_thermal: per-iteration time of the thermal kernel and its plain
              version at 1024^2 f32, by CUDA events.
14. parity_ve3d: the 3D VE chunk kernel against its plain version, f64, nout
              1 and 200: the general VE form at (22, 9, 7), the viscous form
              at 32^3 with and without the free-slip ghosts, the general form
              with dt = inf at 32^3 (its uniform canvases passed as scalars),
              and the viscous_consts route against the plain chunk on the
              viscous coefficients.
15. golden_ve3d: SolVi 3D at 16^3 f64 through the default entry point (B7;
              norm_Rx < 1e-8 within 5 000 iterations, the plain path's count
              beside it) and Burstedde at 16^3 f64 on the plain path (Vx
              within 5e-2, no B7 launch).
16. main_path_ve3d: SolVi 3D at 126^3 f32 (the production 3D grid of
              bench_kernels.py's ve3d) through the default entry point,
              10 000 iterations, with the launch count read around it; the
              kernel's and the plain version's time per iteration on the
              solve's own first-chunk inputs, by CUDA events, and the split
              of its wall time (set-up, kernel, the rest); then 200
              iterations kernel vs plain from those inputs in f32 and f64.
17. timing_ve3d: per-iteration time of the 3D kernel and its plain version
              at 126^3 and 254^3 f32 (bench_kernels.py's ve3d set-up), by
              CUDA events.

Bounds are the bytes an iteration must move over the HBM peak, counted from
the run's own inputs (ve3d_words for the 3D kernel).

Then the kernels line, and last {"ok": true, "device": {...}}. Any failure
raises and exits non-zero; with no CUDA device it exits non-zero before
printing any result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from justrelax_tpu_torch.core.grid import Geometry  # noqa: E402
from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs, PTThermalCoeffs  # noqa: E402
from justrelax_tpu_torch.core.state import ThermalState  # noqa: E402
from justrelax_tpu_torch.models import (  # noqa: E402
    blankenbach,
    burstedde,
    diffusion2d,
    elastic_buildup,
    shearband,
    solcx,
    solkz,
    solvi3d,
)
from justrelax_tpu_torch.models.shearband import _circle_phase_ratios  # noqa: E402
from justrelax_tpu_torch.ops import _cuda_build  # noqa: E402
from justrelax_tpu_torch.ops import hopper_stokes as hs  # noqa: E402
from justrelax_tpu_torch.ops import hopper_stokes3d as h3  # noqa: E402
from justrelax_tpu_torch.ops import hopper_stokes_vep as hv  # noqa: E402
from justrelax_tpu_torch.ops import hopper_thermal as ht  # noqa: E402
from justrelax_tpu_torch.ops.bc import (  # noqa: E402
    Faces,
    TemperatureBoundaryConditions,
    VelocityBoundaryConditions,
    flow_bcs,
    thermal_bcs,
)
from justrelax_tpu_torch.solvers.stokes3d import kernel_chunk_inputs  # noqa: E402
from justrelax_tpu_torch.solvers.thermal import heatdiffusion_PT  # noqa: E402
from justrelax_tpu_torch.ops.stencil import av_vertex_to_center, expand_edges, maxloc  # noqa: E402
from justrelax_tpu_torch.ops.stokes3d_canvas import pack_carry, ve3d_canvas_coefficients  # noqa: E402
from justrelax_tpu_torch.rheology.materials import Material, MaterialStack  # noqa: E402
from justrelax_tpu_torch.rheology.viscosity import phase_viscosity  # noqa: E402

FIELDS = ("Vx", "Vy", "theta", "P", "txx", "tyy", "txy_c", "txy_v", "eta",
          "eta_v", "lam", "lam_v")
TOL_NOUT1 = 1e-12  # rounding only (differences as rel_diffs defines them)
TOL_NOUT50 = 2e-6  # yield-branch flips of cells on the yield surface
# f32, 200 iterations: 1e-4, or twice the plain version's own f32 error
# against its f64 result where rounding grows larger than that (near yield)
TOL_F32_1024 = 1e-4
HBM_PEAK = {"PCIe": 2.0e12, "SXM": 3.35e12}  # B/s, NVIDIA data sheets
VE_FIELDS = ("Vx", "Vy", "P", "txx", "tyy", "txy")
VE_CASES = ("solcx", "ve_compressible", "elastic_buildup")
TOL_VE_NOUT1 = 1e-12  # rounding only (differences as rel_diffs_ve defines them)
TOL_VE_NOUT500 = 1e-10
# words per cell and PT iteration in the repo's accounting
# (justrelax_tpu/utils/bench_kernels.py: vep2d 39, ve2d 23)
WORDS_VEP, WORDS_VE = 39, 23
VE3D_FIELDS = ("Vx", "Vy", "Vz", "P", "txx", "tyy", "tzz", "tyz", "txz", "txy")
VE3D_CASES = ("ve_general", "viscous", "viscous_no_free_slip", "ve_dt_inf")
TOL_VE3D_NOUT1 = 1e-13  # rounding only (differences as rel_diffs_ve3d defines them)
TOL_VE3D_NOUT200 = 1e-10
TH_FIELDS = ("T", "qx", "qy")
TH_CASES = ("pallas_setup", "dirichlet_box", "insulated")
TOL_TH_NOUT1 = 1e-12  # rounding only (differences as rel_diffs_th defines them)
TOL_TH_NOUT500 = 1e-10
# Thermal: the compulsory traffic of one chunk iteration, 12 words per cell
# (T, qx, qy read and written; six chunk-invariant cell inputs read once);
# bench_kernels.py's thermal2d counts 16, q2x/q2y included, which the chunk
# does not carry
WORDS_TH, WORDS_TH_BENCH = 12, 16
# heatdiffusion_PT on the 32^2 set-up of tests/test_pallas_thermal.py, frozen
# from the JAX package in float64 on the CPU (x64): its heatdiffusion_PT on
# test_pallas_thermal._setup(32) with PTThermalCoeffs.make(K, rc, 0.3, di, li),
# K=K, rho_Cp=rc, iter_max=4000, nout=200, printing info.iters, info.err,
# T[17, 17], T[1, 1] and T[32, 32]. This command reruns that solve and holds
# these values to it:
#   python -m pytest tests/test_torch_thermal.py -k golden_thermal_constants
GOLDEN_THERMAL = {"iters": 400, "err": 1.1513363166971779e-09,
                  "T_centre": 0.4813572752812458, "T_corner_lo": 0.9840796475262239,
                  "T_corner_hi": 0.016517392162716873}
URMS0_F64 = 0.29207194481326537  # blankenbach 32^2 f64 after one step (bench.py)


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def rel_diffs(a, b):
    """max |a − b| per field relative to the field's max |b| (b the plain
    version), the max floored at 1: the configurations are non-dimensional
    with O(1) fields, and a field that is zero up to rounding (θ under pure
    shear) has no relative error."""
    return {name: float((x - y).abs().max()) / max(float(y.abs().max()), 1.0)
            for name, x, y in zip(FIELDS, a, b)}


def to_f64(x):
    """A chunk argument in float64 (tensors, tuples of them and the material
    stack)."""
    if isinstance(x, torch.Tensor):
        return x.double()
    if isinstance(x, MaterialStack):
        return x.to(dtype=torch.float64)
    if isinstance(x, tuple):
        return tuple(map(to_f64, x))
    return x


def _rel_no_floor(names, a, b):
    out = {}
    for name, x, y in zip(names, a, b):
        d, m = float((x - y).abs().max()), float(y.abs().max())
        out[name] = 0.0 if d == 0.0 else (d / m if m > 0.0 else math.inf)
    return out


def rel_diffs_ve(a, b):
    """max |a − b| per VE field relative to the field's max |b| (b the plain
    version), with no floor: SolCx velocities are far below 1. A field that
    is zero in both has no difference."""
    return _rel_no_floor(VE_FIELDS, a, b)


def rel_diffs_ve3d(a, b):
    """max |a − b| per 3D VE canvas relative to the canvas's max |b| (b the
    plain version), with no floor."""
    return _rel_no_floor(VE3D_FIELDS, a, b)


def rel_diffs_th(a, b):
    """max |a − b| of T, qx and qy relative to the field's max |b| (b the
    plain version), with no floor: the 1024^2 fluxes are far below 1."""
    return _rel_no_floor(TH_FIELDS, a, b)


def f32_gaps(kernel, reference, rel, args, kw, nout):
    """Kernel against plain in f32, and both against the plain version in
    f64 on the same inputs: how far the kernel is from the plain version,
    and how far f32 rounding alone takes the plain version. Returns (gap per
    field, max gap, kernel vs f64, plain vs f64, the plain f32 result)."""
    out = kernel(*args, nout=nout, **kw)
    ref = reference(*args, nout=nout, **kw)
    ref64 = reference(*map(to_f64, args), nout=nout, **{k: to_f64(v) for k, v in kw.items()})
    gap = rel(out, ref)
    return gap, max(gap.values()), max(rel(out, ref64).values()), \
        max(rel(ref, ref64).values()), ref


def abs_diff(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


# ---- the four configurations of the parity phase ---------------------------
def chunk_case(name, n, dtype, dev):
    """Inputs of one chunk call: (args, kwargs). Shear band class with old
    stresses near yield so that the return mapping is active."""
    kw = dict(dtype=dtype, device=dev)
    C = 1.6 / math.cos(math.radians(30.0))
    geometry = Geometry((n, n), (1.0, 1.0))
    xci, xvi = geometry.xci, geometry.xvi
    pr_c = torch.as_tensor(_circle_phase_ratios(xci[0], xci[1], (0.5, 0.5), 0.1), **kw)
    pr_v = torch.as_tensor(_circle_phase_ratios(xvi[0], xvi[1], (0.5, 0.5), 0.1), **kw)
    bc = VelocityBoundaryConditions(free_slip=Faces(left=True, right=True, top=True, bot=True))
    T = T_v = None
    P_init = 0.0
    dt, cutoff, relax = 0.25, (1e-3, 1e3), 0.5
    plastic = dict(rho0=0.0, Kb=4.0, eta0=1.0, is_plastic=1.0, C=C, friction_angle=30.0)
    if name == "shearband":
        mats = [Material(G=1.0, eta_reg=8e-3, **plastic), Material(G=0.5, eta_reg=8e-3, **plastic)]
    elif name == "dpcap":
        common = dict(plastic, dilation_angle=3.0, eta_reg=1e-3, tension_pT=-0.5)
        mats = [Material(G=1.0, **common), Material(G=0.5, **common)]
        P_init = -0.2  # tension side, where the cap is below the cone
    elif name == "powerlaw_noslip":
        common = dict(plastic, dilation_angle=10.0, eta_reg=1e-2)
        mats = [Material(G=1.0, disl_A=0.4, disl_n=3.0, disl_E=1.0e3, **common),
                Material(G=0.5, diff_A=0.3, diff_m=1.0, grain_size=0.5, diff_E=5.0e2, **common)]
        bc = VelocityBoundaryConditions(free_slip=Faces(left=True, right=True),
                                        no_slip=Faces(top=True, bot=True))
        xc = torch.as_tensor(xci[0], **kw)
        T = 300.0 + 50.0 * torch.sin(2.0 * math.pi * xc[:, None]) * torch.ones((1, n), **kw)
        T_v = av_vertex_to_center(expand_edges(T))
    elif name == "buoyancy":
        geometry = Geometry((n, n), (1.0, 1.0), origin=(0.0, -1.0))
        mats = [Material(rho0=1.0, T0=0.0, alpha=0.5, beta=0.0, G=1.0, eta0=1.0, gravity=1.0)]
        pr_c = pr_v = None
        xc = torch.as_tensor(geometry.xci[0], **kw)
        yc = torch.as_tensor(geometry.xci[1], **kw)
        T = torch.exp(-(((xc[:, None] - 0.5) ** 2 + (yc[None, :] + 0.6) ** 2) / 0.02))
        dt, cutoff, relax = math.inf, (-math.inf, math.inf), 1e-2
    else:
        raise ValueError(name)
    material = MaterialStack.make(mats, **kw)
    zc = torch.zeros((n, n), **kw)
    zv = torch.zeros((n + 1, n + 1), **kw)
    if name == "buoyancy":
        Vx = torch.zeros((n + 1, n + 2), **kw)
        Vy = torch.zeros((n + 2, n + 1), **kw)
        tau_o = (zc, zc, zc, zv)
        eta, eta_v = torch.ones_like(zc), torch.ones_like(zv)
        EII = zc
    else:
        xv = torch.as_tensor(xvi[0], **kw)
        yv = torch.as_tensor(xvi[1], **kw)
        Vx, Vy = flow_bcs((xv[:, None].expand(n + 1, n + 2),
                           (-yv)[None, :].expand(n + 2, n + 1)), bc)
        tau_o = (zc + 1.6, zc - 1.6, zc + 1.0, zv + 1.0)
        eta = phase_viscosity(material, torch.ones_like(zc), T, pr_c, "tau") * 1.1
        eta_v = phase_viscosity(material, torch.ones_like(zv), T_v, pr_v, "tau") * 1.1
        EII = zc + 0.001
    P = zc + P_init
    pt = PTStokesCoeffs.make(geometry.li, geometry.di, CFL=0.75 / math.sqrt(2.1))
    args = (Vx, Vy, P, P, *tau_o, eta, eta_v, zc, zv,
            P, zc, *tau_o, EII, material, pr_c, pr_v, T,
            dt, 1.0 / geometry.di[0], 1.0 / geometry.di[1], pt.r, pt.theta_dtau,
            pt.etadtau, 0.2, relax, cutoff)
    return args, dict(flow_bc=bc, T_v=T_v)


# ---- the three configurations of the VE parity phase ----------------------
def ve_case(name, n, dtype, dev):
    """Inputs of one ``stokes_chunk`` call: (args, kwargs), from a numpy
    seed. Every carried field is non-trivial after one iteration."""
    rng = np.random.default_rng(3)
    kw = dict(dtype=dtype, device=dev)
    c, v = (n, n), (n + 1, n + 1)

    def rand(shape, scale, offset=0.0):
        return torch.as_tensor(offset + scale * rng.standard_normal(shape), **kw)

    if name == "solcx":  # viscous limit, smoothed Δη = 1e6, from a random state
        geometry, st, pt, _, rho_g, G, K, _ = solcx._setup(n, n, 1e6, 1.0, 1.0, dtype, dev)
        eta = st.viscosity.eta
        carry = (rand((n + 1, n + 2), 1e-3), rand((n + 2, n + 1), 1e-3),
                 rand(c, 0.1), rand(c, 0.1), rand(c, 0.1), rand(v, 0.1))
        phys = dict(G=G, K=K, dt=0.1)
    elif name == "ve_compressible":  # the set-up of tests/test_pallas.py:104-140
        geometry = Geometry(c, (1.0, 1.0))
        pt = PTStokesCoeffs.make(geometry.li, geometry.di, CFL=1.0 / math.sqrt(2.1))
        eta = torch.as_tensor(np.exp(rng.uniform(0.0, 2.0, c)), **kw)
        rho_g = (rand(c, 0.3), rand(c, 0.2, 1.0))
        carry = (torch.zeros((n + 1, n + 2), **kw), torch.zeros((n + 2, n + 1), **kw),
                 *(torch.zeros(c, **kw) for _ in range(3)), torch.zeros(v, **kw))
        phys = dict(G=torch.full(c, 4.0, **kw), K=torch.full(c, 9.0, **kw),
                    P0=rand(c, 0.1), Q=rand(c, 0.05),
                    tau_o=(rand(c, 0.1), rand(c, 0.1), rand(v, 0.1)), dt=0.5)
    elif name == "elastic_buildup":  # pure-shear boundary velocities, G finite, K = ∞
        geometry, st, pt, _, rho_g, G, K = elastic_buildup._setup(
            n, n, 100.0e3, 100.0e3, 1.0e21, 1.0e-14, 10.0e9, dtype, dev)
        eta = st.viscosity.eta
        Vx, Vy = st.V.Vx.clone(), st.V.Vy.clone()
        Vx[1:-1, 1:-1] += rand((n - 1, n), 1e-12)  # interior only: the normal
        Vy[1:-1, 1:-1] += rand((n, n - 1), 1e-12)  # boundary faces keep pure shear
        tau_o = (rand(c, 1e6), rand(c, 1e6), rand(v, 1e6))
        carry = (Vx, Vy, torch.zeros(c, **kw), *tau_o)
        phys = dict(G=G, K=K, tau_o=tau_o, dt=0.05 * elastic_buildup.KYR)
    else:
        raise ValueError(name)
    args = carry + (eta, maxloc(eta, 1), *rho_g, 1.0 / geometry.di[0],
                    1.0 / geometry.di[1], pt.r, pt.theta_dtau, pt.etadtau)
    return args, phys


# ---- the three configurations of the 3D VE parity phase --------------------
def ve3d_numpy(name, ni):
    """numpy inputs of one 3D chunk call at ``ni`` cells, from a seed:
    (the 10 staggered fields, (η, fx, fy, fz), the VE physics, the lengths,
    free_slip). "ve_general" is the set-up of
    tests/test_pallas3d_blocked.py:52-73 (seeds 4 and 7: G, K, P0, Q, τ_o
    and dt = 0.5, the general coefficient form); "viscous" and
    "viscous_no_free_slip" draw the state from seeds 5 and 6 and take the
    viscous form (G = None), the second without the free-slip ghosts;
    "ve_dt_inf" draws the state from seed 8 and the physics of "ve_general"
    with dt = ∞, where 12 of the general form's canvases are uniform and
    the kernel takes them as scalars or leaves them out."""
    nx, ny, nz = ni
    seed = {"ve_general": 4, "viscous": 5, "viscous_no_free_slip": 6, "ve_dt_inf": 8}[name]
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape)

    fields = (r(nx + 1, ny + 2, nz + 2), r(nx + 2, ny + 1, nz + 2), r(nx + 2, ny + 2, nz + 1),
              r(*ni), r(*ni), r(*ni), r(*ni),
              r(nx, ny + 1, nz + 1), r(nx + 1, ny, nz + 1), r(nx + 1, ny + 1, nz))
    consts = (np.exp(0.5 * r(*ni)), r(*ni), r(*ni), r(*ni))
    phys = {}
    if name in ("ve_general", "ve_dt_inf"):
        rng2 = np.random.default_rng(7)

        def r2(*shape):
            return rng2.standard_normal(shape) * 0.1

        phys = dict(G=np.exp(r2(*ni) + 1.0), K=np.exp(r2(*ni) + 2.0), P0=r2(*ni), Q=r2(*ni),
                    tau_o=(r2(*ni), r2(*ni), r2(*ni), r2(nx, ny + 1, nz + 1),
                           r2(nx + 1, ny, nz + 1), r2(nx + 1, ny + 1, nz)),
                    dt=0.5 if name == "ve_general" else math.inf)
    return fields, consts, phys, (1.0, 1.3, 0.8), name != "viscous_no_free_slip"


def ve3d_case(name, ni, dtype, dev):
    """Inputs of one ``stokes3d_chunk`` call from :func:`ve3d_numpy`:
    (carry, co, inv_di, free_slip, (viscous_consts, pt_scalars)), the last
    the ``viscous_consts`` route's inputs for the same η and f."""
    fields, consts, phys, li, free_slip = ve3d_numpy(name, ni)

    def t(a):
        if isinstance(a, tuple):
            return tuple(map(t, a))
        return torch.as_tensor(a, dtype=dtype, device=dev) if isinstance(a, np.ndarray) else a

    geometry = Geometry(ni, li)
    pt = PTStokesCoeffs.make(li, geometry.di, CFL=0.9 / math.sqrt(3.1))
    eta, fx, fy, fz = t(consts)
    eta_tau = maxloc(eta, 1)
    co = ve3d_canvas_coefficients(eta, eta_tau, pt.r, pt.theta_dtau, pt.etadtau,
                                  fx=fx, fy=fy, fz=fz, **{k: t(v) for k, v in phys.items()})
    derive = ((eta, eta_tau, fx, fy, fz), (pt.r / pt.theta_dtau, pt.theta_dtau, pt.etadtau))
    return (tuple(pack_carry(*t(fields))), co, tuple(1.0 / d for d in geometry.di),
            free_slip, derive)


# ---- the three configurations of the thermal parity phase -----------------
def pallas_thermal_setup(n, dtype, dev):
    """The set-up of tests/test_pallas_thermal.py::_setup: lognormal K,
    variable ρCp, no_flux left/right, constant_value top 0 / bottom 1, a
    linear T profile. Returns (geometry, K, ρCp, BCs, ghosted T)."""
    kw = dict(dtype=dtype, device=dev)
    rng = np.random.default_rng(0)
    K = torch.as_tensor(np.exp(0.2 * rng.normal(size=(n, n))), **kw)
    rc = torch.as_tensor(1.0 + 0.1 * rng.random((n, n)), **kw)
    bc = TemperatureBoundaryConditions(no_flux=Faces(left=True, right=True),
                                       constant_value=Faces(top=0.0, bot=1.0))
    Tg = np.zeros((n + 2, n + 2))
    Tg[:, 1:-1] = np.linspace(1, 0, n)[None, :] * np.ones((n + 2, 1))
    return Geometry((n, n), (1.0, 1.0)), K, rc, bc, thermal_bcs(torch.as_tensor(Tg, **kw), bc)


def thermal_case(name, n, dtype, dev):
    """Inputs of one ``thermal_chunk`` call: (args, kwargs), from a numpy
    seed. T, qx and qy all move in the first iteration."""
    kw = dict(dtype=dtype, device=dev)
    c = (n, n)
    if name == "pallas_setup":  # tests/test_pallas_thermal.py, with H and adiabatic
        geometry, K, rc, bc, T = pallas_thermal_setup(n, dtype, dev)
        qx, qy = torch.zeros((n + 1, n), **kw), torch.zeros((n, n + 1), **kw)
        H_tot = torch.as_tensor(0.1 * np.random.default_rng(2).random(c), **kw)
        ad = torch.as_tensor(0.01 * np.random.default_rng(1).random(c), **kw)
        dt = 0.3
    else:
        rng = np.random.default_rng(5 if name == "dirichlet_box" else 7)
        geometry = Geometry(c, (1.0, 1.0))
        K = torch.as_tensor(np.exp(0.3 * rng.normal(size=c)), **kw)
        rc = torch.as_tensor(1.0 + 0.2 * rng.random(c), **kw)
        Tg = np.zeros((n + 2, n + 2))
        Tg[1:-1, 1:-1] = 0.5 + 0.2 * rng.normal(size=c)
        qx = torch.as_tensor(0.1 * rng.normal(size=(n + 1, n)), **kw)
        qy = torch.as_tensor(0.1 * rng.normal(size=(n, n + 1)), **kw)
        if name == "dirichlet_box":  # the BCs of models/thermal_stresses.py, per face
            bc = TemperatureBoundaryConditions(
                constant_value=Faces(left=0.2, right=0.4, bot=1.0, top=0.0))
            H, shear_heating = 0.05 * rng.random(c), 0.5 * rng.random(c)
            H_tot = torch.as_tensor(H, **kw) + torch.as_tensor(shear_heating, **kw)
            ad, dt = None, 0.1
        elif name == "insulated":  # no_flux on all four faces, a heat source
            bc = TemperatureBoundaryConditions(
                no_flux=Faces(left=True, right=True, bot=True, top=True))
            H_tot = torch.as_tensor(rng.random(c), **kw)
            ad = torch.as_tensor(-0.02 * rng.random(c), **kw)
            dt = 0.5
        else:
            raise ValueError(name)
        T = thermal_bcs(torch.as_tensor(Tg, **kw), bc)
    pt = PTThermalCoeffs.make(K, rc, dt, geometry.di, geometry.li)
    args = (T, qx, qy, T, K, rc, H_tot, pt.dtau_rho, pt.theta_r_dtau, 1.0 / dt,
            1.0 / geometry.di[0], 1.0 / geometry.di[1], bc)
    return args, dict(adiabatic=ad)


def thermal_1024_setup(n, dtype):
    """bench_kernels.py::pallas_thermal2d at n²: L = 100 km, K = 3,
    ρCp = 3.3e6, dt = 1.5e11, T = 1500 + 10·N(0, 1), no_flux left/right,
    constant_value top 1500 / bottom 1600, H = 0; the state on the default
    device. Returns (thermal, pt, bc, geometry, K, ρCp, dt)."""
    geometry = Geometry((n, n), (100.0e3, 100.0e3))
    thermal = ThermalState.make((n, n), dtype=dtype)
    kw = dict(dtype=dtype, device=thermal.T.device)
    K, rc, dt = torch.full((n, n), 3.0, **kw), torch.full((n, n), 3.3e6, **kw), 1.5e11
    bc = TemperatureBoundaryConditions(no_flux=Faces(left=True, right=True),
                                       constant_value=Faces(top=1500.0, bot=1600.0))
    T = thermal_bcs(torch.as_tensor(
        1500.0 + 10.0 * np.random.default_rng(0).normal(size=(n + 2, n + 2)), **kw), bc)
    pt = PTThermalCoeffs.make(K, rc, dt, geometry.di, geometry.li)
    return thermal.replace(T=T, Told=T), pt, bc, geometry, K, rc, dt


def bound_ms(words, n_cells, itemsize, kind):
    """Least time per PT iteration: the accounting's words per cell over
    the HBM peak (the operations, a few dozen per cell, take far less at
    the card's 67 TFLOP/s f32)."""
    return words * n_cells * itemsize / HBM_PEAK[kind] * 1e3


def cuda_time_ms(fn, repeats=5):
    """Median wall time of ``fn`` on the card, by CUDA events, after one
    warm-up call."""
    fn()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def chunk_inputs_from_state(st, material, pr_c, pr_v, geometry, pt, dt):
    """Chunk inputs at the start of a solve from ``st`` (solve_vep's entry)."""
    z = torch.zeros_like
    return (st.V.Vx, st.V.Vy, st.P, st.P, st.tau.xx, st.tau.yy, st.tau.xy_c,
            st.tau.xy, st.viscosity.eta, st.viscosity.eta_v, z(st.P), z(st.tau.xy),
            st.P, st.Q, st.tau_o.xx, st.tau_o.yy, st.tau_o.xy_c, st.tau_o.xy,
            st.EII_pl, material, pr_c, pr_v, None, dt,
            1.0 / geometry.di[0], 1.0 / geometry.di[1], pt.r, pt.theta_dtau,
            pt.etadtau, 0.2, 1e-2, (-math.inf, math.inf))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)

    # ---- 0. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", name=name, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())

    # ---- 1. build: one nvcc per source, started together
    def build(source):
        t0 = time.perf_counter()
        path = _cuda_build.build_library(source)
        return path, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=4) as pool:
        builds = list(pool.map(build, (hv.SOURCE, hs.SOURCE, ht.SOURCE, h3.SOURCE)))
    for mod in (hv, hs, ht, h3):
        mod._library()
    for phase, (lib_path, build_s) in zip(("build", "build_ve", "build_thermal", "build_ve3d"),
                                          builds):
        log = lib_path.with_suffix(".log")
        ptxas = [ln.strip() for ln in (log.read_text().splitlines() if log.exists() else [])
                 if "registers" in ln or "spill" in ln]
        emit(phase, seconds=build_s, library=os.path.relpath(lib_path, ROOT), ptxas=ptxas)

    # ---- 2. kernel against plain, f64, n=64
    worst_rel, worst_abs = 0.0, 0.0
    for case in ("shearband", "dpcap", "powerlaw_noslip", "buoyancy"):
        args, kw = chunk_case(case, 64, torch.float64, dev)
        for nout, tol in ((1, TOL_NOUT1), (50, TOL_NOUT50)):
            ref = hv.stokes_vep_chunk_reference(*args, nout=nout, **kw)
            out = hv.stokes_vep_chunk(*args, nout=nout, **kw)
            torch.cuda.synchronize()
            d = rel_diffs(out, ref)
            worst = max(d.values())
            worst_rel, worst_abs = max(worst_rel, worst), max(worst_abs, abs_diff(out, ref))
            lam_max = float(ref[10].max())
            emit("parity", case=case, nout=nout, max_rel_diff=worst, tol=tol,
                 lam_max=lam_max, per_field=d)
            check(worst <= tol, f"{case} nout={nout}: {worst} > {tol}")
            if case != "buoyancy":
                check(lam_max > 0.0, f"{case}: plasticity inactive")
            else:
                check(float(ref[1].abs().max()) > 0.0, "buoyancy: no flow")

    # ---- 3. golden through the kernel, f64
    hv.stokes_vep_chunk.launches = 0
    t0 = time.perf_counter()
    st, info, tau_max, _, tII = shearband.run(
        n=32, nt=10, dtype=torch.float64, use_kernel=True, device=dev)
    g = dict(err=float(info.err), tauII_min=float(tII.min()), tauII_max=float(tII.max()),
             txx_max_last=tau_max[-1], launches=hv.stokes_vep_chunk.launches,
             seconds=time.perf_counter() - t0)
    emit("golden", **g)
    check(g["err"] < 1e-6, "golden: err")
    check(abs(g["tauII_max"] - 1.641536) <= 1e-4, "golden: tauII max")
    check(abs(g["tauII_min"] - 1.512963) <= 1e-4, "golden: tauII min")
    check(abs(g["txx_max_last"] - 1.637653) <= 1e-4, "golden: txx max")
    check(g["launches"] > 0, "golden: the kernel was not launched")

    # ---- 4. main path: production grid, one time step through the kernel
    n = 1024
    hv.stokes_vep_chunk.launches = hs.stokes_chunk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, info, _, _, tII = shearband.run(
        n=n, nt=1, dtype=torch.float32, use_kernel=True, device=dev,
        iter_max=40_000, nout=1_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    main_launches = hv.stokes_vep_chunk.launches
    finite = all(bool(torch.isfinite(t).all()) for t in (
        st.V.Vx, st.V.Vy, st.P, st.tau.xx, st.tau.yy, st.tau.xy, st.tau.II,
        st.viscosity.eta, st.viscosity.eta_v, st.EII_pl))
    emit("main_path", n=n, dtype="float32", iters=int(info.iters), err=float(info.err),
         tauII_max=float(tII.max()), wall_s=wall, launches=main_launches, finite=finite)
    check(finite, "main path: non-finite fields")
    check(main_launches > 0, "main path: the kernel was not launched")

    # 200 iterations, kernel vs plain: from the main path's initial state
    # (elastic loading), and from the shear band case with old stresses near
    # yield (the return mapping active)
    geometry, material, pr_c, pr_v, st0, pt, _ = shearband._setup(
        n, dict(rho0=0.0, Kb=4.0, eta0=1.0, is_plastic=1.0,
                C=1.6 / math.cos(math.radians(30.0)), friction_angle=30.0,
                eta_reg=8.0e-3), 0.5, torch.float32, dev,
        eps_rel=1.0e-6, CFL=0.75 / math.sqrt(2.1))
    states = {
        "initial": (chunk_inputs_from_state(st0, material, pr_c, pr_v, geometry, pt, 0.25), {}),
        "near_yield": chunk_case("shearband", n, torch.float32, dev),
    }
    saved = hv.stokes_vep_chunk.launches
    worst32 = 0.0
    for label, (args, kw) in states.items():
        per_field, gap, k_vs_64, p_vs_64, ref = f32_gaps(
            hv.stokes_vep_chunk, hv.stokes_vep_chunk_reference, rel_diffs, args, kw, 200)
        lam_max = float(ref[10].max())
        tol = max(TOL_F32_1024, 2.0 * p_vs_64)
        worst32 = max(worst32, gap)
        emit("f32_1024_parity", state=label, nout=200, max_rel_diff=gap, tol=tol,
             kernel_vs_plain_f64=k_vs_64, plain_f32_vs_plain_f64=p_vs_64,
             lam_max=lam_max, per_field=per_field)
        check(gap <= tol, f"f32 1024^2 {label}: {gap} > {tol}")
    torch.cuda.synchronize()

    # ---- 5. timing at 1024^2 f32, in turns kernel, plain, plain, kernel
    nk, npl = 500, 20
    kind = "PCIe" if "PCIe" in name else "SXM"
    bytes_iter = WORDS_VEP * n * n * 4
    times = {}
    for label, (args, kw) in states.items():
        tk1 = cuda_time_ms(lambda: hv.stokes_vep_chunk(*args, nout=nk, **kw)) / nk
        tp1 = cuda_time_ms(lambda: hv.stokes_vep_chunk_reference(*args, nout=npl, **kw)) / npl
        tp2 = cuda_time_ms(lambda: hv.stokes_vep_chunk_reference(*args, nout=npl, **kw)) / npl
        tk2 = cuda_time_ms(lambda: hv.stokes_vep_chunk(*args, nout=nk, **kw)) / nk
        t_k, t_p = min(tk1, tk2), min(tp1, tp2)
        t_eff = bytes_iter / (t_k * 1e-3)
        times[label] = (t_k, t_p)
        emit("timing", state=label, n=n, dtype="float32", kernel_ms_per_iter=[tk1, tk2],
             plain_ms_per_iter=[tp1, tp2], T_eff_GBs=t_eff / 1e9,
             hbm_peak_GBs=HBM_PEAK[kind] / 1e9, hbm_share=t_eff / HBM_PEAK[kind],
             plain_over_kernel=t_p / t_k, nvidia_smi=smi)
    hv.stokes_vep_chunk.launches = saved  # comparison launches do not count
    t_k, t_p = times["initial"]
    vep_line = {
        "name": "stokes_vep_chunk",
        "route": "cuda",
        "source": "justrelax_tpu_torch/csrc/stokes_vep.cu",
        "replaces": ("justrelax_tpu/ops/pallas_stokes_vep.py:473 (B2 stokes_vep_chunk_vmem); "
                     "justrelax_tpu/ops/pallas_stokes_vep.py:864 (B3 stokes_vep_chunk_blocked)"),
        "launches": main_launches,
        "max_abs_err": worst_abs,
        "max_rel_diff_f64": worst_rel,
        "max_rel_diff_f32_1024": worst32,
        "ms": t_k,
        "plain_ms": t_p,
        "bound_ms": bound_ms(WORDS_VEP, n * n, 4, kind),
        "bound_by": "bytes",
        "library_ms": None,
    }

    ve_line = run_ve(dev, smi, kind)
    th_line = run_thermal(dev, smi, kind)
    ve3d_line = run_ve3d(dev, smi, kind)
    print(json.dumps({"kernels": [vep_line, ve_line, th_line, ve3d_line]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


def run_ve(dev, smi, kind):
    """Phases 6-9, the VE solve; returns the VE kernel's entry of the
    kernels line."""
    # ---- 6. VE kernel against plain, f64, n=64
    worst_rel, worst_abs = 0.0, 0.0
    for case in VE_CASES:
        args, kw = ve_case(case, 64, torch.float64, dev)
        for nout, tol in ((1, TOL_VE_NOUT1), (500, TOL_VE_NOUT500)):
            ref = hs.stokes_chunk_reference(*args, nout=nout, **kw)
            out = hs.stokes_chunk(*args, nout=nout, **kw)
            torch.cuda.synchronize()
            d = rel_diffs_ve(out, ref)
            worst = max(d.values())
            worst_rel, worst_abs = max(worst_rel, worst), max(worst_abs, abs_diff(out, ref))
            moved = min(float((o - a).abs().max()) for o, a in zip(out[:2], args[:2]))
            emit("parity_ve", case=case, nout=nout, max_rel_diff=worst, tol=tol,
                 V_moved=moved, per_field=d)
            check(worst <= tol, f"{case} nout={nout}: {worst} > {tol}")
            check(moved > 0.0, f"{case} nout={nout}: the kernel left V unchanged")

    # ---- 7. goldens through the default entry points, f64, 32^2
    def golden(label, fn, checks):
        hs.stokes_chunk.launches = 0
        t0 = time.perf_counter()
        g = fn()
        g.update(launches=hs.stokes_chunk.launches, seconds=time.perf_counter() - t0)
        emit("golden_ve", case=label, **g)
        for key, ok in checks(g):
            check(ok, f"golden_ve {label}: {key}")
        check(g["launches"] > 0, f"golden_ve {label}: the kernel was not launched")

    def run_solcx(d_eta):
        _, st, info, _ = solcx.run(nx=32, ny=32, d_eta=d_eta, dtype=torch.float64)
        vmax = max(float(st.V.Vx.abs().max()), float(st.V.Vy.abs().max()))
        return dict(iters=int(info.iters), err=float(info.err), vmax=vmax)

    def run_solkz():
        _, _, info = solkz.run(nx=32, ny=32, dtype=torch.float64)
        return dict(iters=int(info.iters), err=float(info.err))

    def run_buildup():
        _, av, sol, _, info = elastic_buildup.run(nx=32, ny=32, endtime_kyr=10.0,
                                                  dtype=torch.float64)
        err = statistics.mean(abs(abs(a) - s) / s for a, s in zip(av, sol))
        return dict(steps=len(av), iters_last=int(info.iters), mean_rel_err=err)

    analytic_vmax = 1.0 / (4.0 * math.pi ** 2)
    golden("solcx_deta1e6", lambda: run_solcx(1e6), lambda g: [("err", g["err"] < 1e-8)])
    golden("solcx_deta1", lambda: run_solcx(1.0), lambda g: [
        ("err", g["err"] < 1e-8),
        ("vmax", abs(g["vmax"] - analytic_vmax) <= 2e-3 * analytic_vmax)])
    golden("solkz", run_solkz, lambda g: [("err", g["err"] < 1e-8)])
    golden("elastic_buildup", run_buildup, lambda g: [("mean_rel_err", g["mean_rel_err"] <= 5e-3)])

    # ---- 8. main path: SolCx at the production grid, the default entry point
    n = 1024
    hs.stokes_chunk.launches = hv.stokes_vep_chunk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, st, info, _ = solcx.run(nx=n, ny=n, dtype=torch.float32, iter_max=20_000, nout=1_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    main_launches = hs.stokes_chunk.launches
    check(st.P.device.type == "cuda", "main path VE: the default device is not the card")
    finite = all(bool(torch.isfinite(t).all()) for t in (
        st.V.Vx, st.V.Vy, st.P, st.tau.xx, st.tau.yy, st.tau.xy, st.tau.II))
    emit("main_path_ve", n=n, dtype="float32", iters=int(info.iters), err=float(info.err),
         wall_s=wall, launches=main_launches, finite=finite)
    check(finite, "main path VE: non-finite fields")
    check(main_launches > 0, "main path VE: the kernel was not launched")

    # 200 iterations kernel vs plain from the main path's initial state
    geometry, st0, pt, _, rho_g, G, K, _ = solcx._setup(n, n, 1e6, 1.0, 1.0, torch.float32, dev)
    eta = st0.viscosity.eta
    args = (st0.V.Vx, st0.V.Vy, st0.P, st0.tau.xx, st0.tau.yy, st0.tau.xy,
            eta, maxloc(eta, 1), *rho_g, 1.0 / geometry.di[0], 1.0 / geometry.di[1],
            pt.r, pt.theta_dtau, pt.etadtau)
    kw = dict(G=G, K=K, P0=st0.P0, Q=st0.Q,
              tau_o=(st0.tau_o.xx, st0.tau_o.yy, st0.tau_o.xy), dt=0.1)
    per_field, worst32, k_vs_64, p_vs_64, _ = f32_gaps(
        hs.stokes_chunk, hs.stokes_chunk_reference, rel_diffs_ve, args, kw, 200)
    tol = max(TOL_F32_1024, 2.0 * p_vs_64)
    emit("f32_1024_parity_ve", nout=200, max_rel_diff=worst32, tol=tol,
         kernel_vs_plain_f64=k_vs_64, plain_f32_vs_plain_f64=p_vs_64, per_field=per_field)
    check(worst32 <= tol, f"f32 1024^2 VE: {worst32} > {tol}")

    # ---- 9. timing at 1024^2 f32, in turns kernel, plain, plain, kernel
    nk, npl = 1000, 20
    saved = hs.stokes_chunk.launches
    tk1 = cuda_time_ms(lambda: hs.stokes_chunk(*args, nout=nk, **kw)) / nk
    tp1 = cuda_time_ms(lambda: hs.stokes_chunk_reference(*args, nout=npl, **kw)) / npl
    tp2 = cuda_time_ms(lambda: hs.stokes_chunk_reference(*args, nout=npl, **kw)) / npl
    tk2 = cuda_time_ms(lambda: hs.stokes_chunk(*args, nout=nk, **kw)) / nk
    hs.stokes_chunk.launches = saved  # comparison launches do not count
    t_k, t_p = min(tk1, tk2), min(tp1, tp2)
    t_eff = WORDS_VE * n * n * 4 / (t_k * 1e-3)
    bound = bound_ms(WORDS_VE, n * n, 4, kind)
    emit("timing_ve", n=n, dtype="float32", kernel_ms_per_iter=[tk1, tk2],
         plain_ms_per_iter=[tp1, tp2], T_eff_GBs=t_eff / 1e9,
         hbm_peak_GBs=HBM_PEAK[kind] / 1e9, hbm_share=t_eff / HBM_PEAK[kind],
         bound_ms=bound, bound_share=bound / t_k, plain_over_kernel=t_p / t_k,
         nvidia_smi=smi)
    return {
        "name": "stokes_chunk",
        "route": "cuda",
        "source": "justrelax_tpu_torch/csrc/stokes_ve.cu",
        "replaces": ("justrelax_tpu/ops/pallas_stokes.py:264 (B1 stokes_chunk_vmem); "
                     "justrelax_tpu/ops/pallas_stokes.py:470 (B4 stokes_chunk_blocked)"),
        "launches": main_launches,
        "max_abs_err": worst_abs,
        "max_rel_diff_f64": worst_rel,
        "max_rel_diff_f32_1024": worst32,
        "ms": t_k,
        "plain_ms": t_p,
        "bound_ms": bound,
        "bound_by": "bytes",
        "library_ms": None,
    }


def run_thermal(dev, smi, kind):
    """Phases 10-13, the thermal solve; returns the thermal kernel's entry of
    the kernels line."""
    # ---- 10. thermal kernel against plain, f64, n=64
    worst_rel, worst_abs = 0.0, 0.0
    for case in TH_CASES:
        args, kw = thermal_case(case, 64, torch.float64, dev)
        for nout, tol in ((1, TOL_TH_NOUT1), (500, TOL_TH_NOUT500)):
            ref = ht.thermal_chunk_reference(*args, nout=nout, **kw)
            out = ht.thermal_chunk(*args, nout=nout, **kw)
            torch.cuda.synchronize()
            d = rel_diffs_th(out, ref)
            worst = max(d.values())
            worst_rel, worst_abs = max(worst_rel, worst), max(worst_abs, abs_diff(out, ref))
            moved = float((out[0] - args[0]).abs().max())
            emit("parity_thermal", case=case, nout=nout, max_rel_diff=worst, tol=tol,
                 T_moved=moved, per_field=d)
            check(worst <= tol, f"{case} nout={nout}: {worst} > {tol}")
            check(moved > 0.0, f"{case} nout={nout}: the kernel left T unchanged")

    # ---- 11. goldens through the default entry points, f64, 32^2
    n = 32
    geometry, K, rc, bc, Tg = pallas_thermal_setup(n, torch.float64, dev)
    th0 = ThermalState.make((n, n)).replace(T=Tg, Told=Tg)
    pt = PTThermalCoeffs.make(K, rc, 0.3, geometry.di, geometry.li)
    ht.thermal_chunk.launches = 0
    t0 = time.perf_counter()
    th, info = heatdiffusion_PT(th0, pt, bc, 0.3, geometry, K=K, rho_Cp=rc,
                                iter_max=4000, nout=200)
    T = th.T
    g = dict(iters=int(info.iters), err=float(info.err), T_centre=float(T[17, 17]),
             T_corner_lo=float(T[1, 1]), T_corner_hi=float(T[32, 32]))
    rel_T = max(abs(g[k] - GOLDEN_THERMAL[k]) / abs(GOLDEN_THERMAL[k])
                for k in ("T_centre", "T_corner_lo", "T_corner_hi"))
    rel_err = abs(g["err"] - GOLDEN_THERMAL["err"]) / GOLDEN_THERMAL["err"]
    emit("golden_thermal", case="heatdiffusion_PT_32", **g, rel_T=rel_T, rel_err=rel_err,
         launches=ht.thermal_chunk.launches, seconds=time.perf_counter() - t0)
    check(g["iters"] == GOLDEN_THERMAL["iters"], "golden_thermal: iterations")
    check(rel_T <= 1e-10, f"golden_thermal: T {rel_T}")
    # err is a residual of O(1) terms near 1e-9: rounding moves it by ~1e-7
    # relative, the FMA contraction of the kernel included
    check(rel_err <= 1e-4, f"golden_thermal: err {rel_err}")
    check(ht.thermal_chunk.launches > 0, "golden_thermal: the kernel was not launched")

    ht.thermal_chunk.launches = 0
    t0 = time.perf_counter()
    th, info = diffusion2d.run(nx=32, ny=32, dtype=torch.float64)
    T = th.T
    g = dict(T_17_17=float(T[17, 17]), T_16_16=float(T[16, 16]), err=float(info.err),
             iters_last=int(info.iters), launches=ht.thermal_chunk.launches,
             seconds=time.perf_counter() - t0)
    emit("golden_thermal", case="diffusion2d_32", **g)
    check(th.T.device.type == "cuda", "diffusion2d: the default device is not the card")
    check(abs(g["T_17_17"] - 1817.9448461176817) <= 0.1, "diffusion2d: T[17, 17]")
    check(abs(g["T_16_16"] - 1827.4674313638786) <= 0.1, "diffusion2d: T[16, 16]")
    check(g["err"] < 1e-8, "diffusion2d: err")
    check(g["launches"] == 0, "diffusion2d: the material path launched the thermal kernel")

    hv.stokes_vep_chunk.launches = ht.thermal_chunk.launches = 0
    t0 = time.perf_counter()
    urms, nu, info, _, _ = blankenbach.run(nx=32, ny=32, nit=10, dtype=torch.float64)
    g = dict(Urms_first=urms[0], Urms_last=urms[-1], Nu_last=nu[-1], err=float(info.err),
             iters_last=int(info.iters), launches=hv.stokes_vep_chunk.launches,
             thermal_launches=ht.thermal_chunk.launches, seconds=time.perf_counter() - t0)
    emit("golden_thermal", case="blankenbach_32", **g)
    check(abs(g["Urms_first"] - URMS0_F64) <= 1e-3 * URMS0_F64, "blankenbach: Urms[0]")
    check(abs(g["Urms_last"] - 0.40987052065118357) <= 1e-1 * 0.40987052065118357,
          "blankenbach: Urms[-1]")
    check(abs(g["Nu_last"] - 1.0026242251320245) <= 1e-2 * 1.0026242251320245,
          "blankenbach: Nu[-1]")
    check(g["err"] < 1e-4, "blankenbach: err")
    check(g["launches"] > 0, "blankenbach: the VEP kernel was not launched")

    # ---- 12. main path: the production grid, the default entry point
    n = 1024
    thermal, pt, bc, geometry, K, rc, dt = thermal_1024_setup(n, torch.float32)
    hv.stokes_vep_chunk.launches = hs.stokes_chunk.launches = ht.thermal_chunk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    th, info = heatdiffusion_PT(thermal, pt, bc, dt, geometry, K=K, rho_Cp=rc,
                                iter_max=20_000, nout=1_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    main_launches = ht.thermal_chunk.launches
    check(th.T.device.type == "cuda", "main path thermal: the default device is not the card")
    finite = all(bool(torch.isfinite(t).all()) for t in (
        th.T, th.qTx, th.qTy, th.qTx2, th.qTy2, th.ResT))
    emit("main_path_thermal", n=n, dtype="float32", iters=int(info.iters),
         err=float(info.err), wall_s=wall, wall_ms_per_iter=wall / int(info.iters) * 1e3,
         launches=main_launches, finite=finite)
    check(finite, "main path thermal: non-finite fields")
    check(main_launches > 0, "main path thermal: the kernel was not launched")

    # 200 iterations kernel vs plain from the main path's initial state
    args = (thermal.T, thermal.qTx, thermal.qTy, thermal.T, K, rc,
            thermal.H + thermal.shear_heating, pt.dtau_rho, pt.theta_r_dtau, 1.0 / dt,
            1.0 / geometry.di[0], 1.0 / geometry.di[1], bc)
    kw = dict(adiabatic=thermal.adiabatic)
    per_field, worst32, k_vs_64, p_vs_64, _ = f32_gaps(
        ht.thermal_chunk, ht.thermal_chunk_reference, rel_diffs_th, args, kw, 200)
    tol = max(TOL_F32_1024, 2.0 * p_vs_64)
    emit("f32_1024_parity_thermal", nout=200, max_rel_diff=worst32, tol=tol,
         kernel_vs_plain_f64=k_vs_64, plain_f32_vs_plain_f64=p_vs_64, per_field=per_field)
    check(worst32 <= tol, f"f32 1024^2 thermal: {worst32} > {tol}")

    # ---- 13. timing at 1024^2 f32, in turns kernel, plain, plain, kernel
    nk, npl = 1000, 20
    tk1 = cuda_time_ms(lambda: ht.thermal_chunk(*args, nout=nk, **kw)) / nk
    tp1 = cuda_time_ms(lambda: ht.thermal_chunk_reference(*args, nout=npl, **kw)) / npl
    tp2 = cuda_time_ms(lambda: ht.thermal_chunk_reference(*args, nout=npl, **kw)) / npl
    tk2 = cuda_time_ms(lambda: ht.thermal_chunk(*args, nout=nk, **kw)) / nk
    ht.thermal_chunk.launches = main_launches  # comparison launches do not count
    t_k, t_p = min(tk1, tk2), min(tp1, tp2)
    t_eff = WORDS_TH * n * n * 4 / (t_k * 1e-3)
    t_eff_bench = WORDS_TH_BENCH * n * n * 4 / (t_k * 1e-3)
    bound = bound_ms(WORDS_TH, n * n, 4, kind)
    emit("timing_thermal", n=n, dtype="float32", kernel_ms_per_iter=[tk1, tk2],
         plain_ms_per_iter=[tp1, tp2], T_eff_GBs=t_eff / 1e9,
         T_eff_16_word_convention_GBs=t_eff_bench / 1e9,
         hbm_peak_GBs=HBM_PEAK[kind] / 1e9, hbm_share=t_eff / HBM_PEAK[kind],
         bound_ms=bound, bound_share=bound / t_k, plain_over_kernel=t_p / t_k,
         nvidia_smi=smi)
    return {
        "name": "thermal_chunk",
        "route": "cuda",
        "source": "justrelax_tpu_torch/csrc/thermal.cu",
        "replaces": "justrelax_tpu/ops/pallas_thermal.py:113 (B5 thermal_chunk_vmem)",
        "launches": main_launches,
        "max_abs_err": worst_abs,
        "max_rel_diff_f64": worst_rel,
        "max_rel_diff_f32_1024": worst32,
        "ms": t_k,
        "plain_ms": t_p,
        "bound_ms": bound,
        "bound_by": "bytes",
        "library_ms": None,
    }


def ve3d_words(eta, eta_tau, f):
    """Words per cell that one 3D VE iteration with dt = ∞ must move: the 10
    unknowns read and written, and each read-only input its result depends
    on (η, ητ, fx, fy, fz) that does not hold one value everywhere (a kernel
    takes such an input as a scalar). bench_kernels.py::ve3d counts 35, with
    15 read-only inputs; the other ten (G, K, P0, Q, τ_o×6) drop out of
    every coefficient where dt = ∞."""
    return 20 + sum(not bool((t == t.reshape(-1)[0]).all()) for t in (eta, eta_tau, *f))


def solvi3d_inputs(n, dtype, dev):
    """The first chunk's inputs of solvi3d.run at n³, from the model's own
    set-up through the solver's kernel_chunk_inputs: ((carry, packed
    coefficients, inv_di), (η, ρg, dt))."""
    geometry, st, pt, _, rho_g, G, K, dt = solvi3d._setup(nx=n, ny=n, nz=n, dtype=dtype,
                                                          device=dev)
    return (kernel_chunk_inputs(st, pt, geometry, rho_g, G, K, dt),
            (st.viscosity.eta, rho_g, dt))


def ve3d_bench_inputs(n, dtype, dev):
    """bench_kernels.py::pallas_ve3d_blocked at n³: η = exp(0.3·N(0, 1)),
    fz ~ N(0, 1) (seed 0), the viscous coefficient form (G = K = dt = ∞),
    zero fields, all free slip. Returns (carry, packed coefficients,
    inv_di, words per cell)."""
    kw = dict(dtype=dtype, device=dev)
    ni = (n, n, n)
    geometry = Geometry(ni, (1.0, 1.0, 1.0))
    pt = PTStokesCoeffs.make(geometry.li, geometry.di)
    rng = np.random.default_rng(0)
    eta = torch.as_tensor(np.exp(0.3 * rng.normal(size=ni)), **kw)
    fz = torch.as_tensor(rng.normal(size=ni), **kw)
    z = torch.zeros(ni, **kw)
    eta_tau = maxloc(eta, 1)
    co = ve3d_canvas_coefficients(eta, eta_tau, pt.r, pt.theta_dtau, pt.etadtau,
                                  fx=z, fy=z, fz=fz)
    X = n + 2
    carry = tuple(torch.zeros((X, X, X), **kw) for _ in range(10))
    return (carry, h3.pack_coeffs(co), tuple(1.0 / d for d in geometry.di),
            ve3d_words(eta, eta_tau, (z, z, fz)))


def time_ve3d(carry, co, inv_di, nk, npl):
    """ms per iteration of the 3D VE kernel and its plain version on the
    same inputs, in turns kernel, plain, plain, kernel: ([k1, k2], [p1, p2])."""
    tk1 = cuda_time_ms(lambda: h3.stokes3d_chunk(carry, co, inv_di, nk)) / nk
    tp1 = cuda_time_ms(lambda: h3.stokes3d_chunk_reference(carry, co, inv_di, npl)) / npl
    tp2 = cuda_time_ms(lambda: h3.stokes3d_chunk_reference(carry, co, inv_di, npl)) / npl
    tk2 = cuda_time_ms(lambda: h3.stokes3d_chunk(carry, co, inv_di, nk)) / nk
    return [tk1, tk2], [tp1, tp2]


def run_ve3d(dev, smi, kind):
    """Phases 14-17, the 3D VE solve; returns the 3D VE kernel's entry of
    the kernels line."""
    # ---- 14. 3D VE kernel against plain, f64
    worst_rel, worst_abs = 0.0, 0.0
    routes = [(case, case) for case in VE3D_CASES] + [("viscous_consts", "viscous")]
    for label, case in routes:
        ni = (22, 9, 7) if case == "ve_general" else (32, 32, 32)
        carry, co, inv_di, free_slip, (consts, scalars) = ve3d_case(case, ni, torch.float64,
                                                                    dev)
        for nout, tol in ((1, TOL_VE3D_NOUT1), (200, TOL_VE3D_NOUT200)):
            # the viscous_consts route against the plain chunk on co (G = None)
            ref = h3.stokes3d_chunk_reference(carry, co, inv_di, nout, free_slip=free_slip)
            if label == "viscous_consts":
                out = h3.stokes3d_chunk(carry, None, inv_di, nout, viscous_consts=consts,
                                        pt_scalars=scalars)
            else:
                out = h3.stokes3d_chunk(carry, co, inv_di, nout, free_slip=free_slip)
            torch.cuda.synchronize()
            d = rel_diffs_ve3d(out, ref)
            worst = max(d.values())
            worst_rel, worst_abs = max(worst_rel, worst), max(worst_abs, abs_diff(out, ref))
            moved = min(float((o - a).abs().max()) for o, a in zip(out[:3], carry[:3]))
            emit("parity_ve3d", case=label, ni=list(ni), nout=nout, max_rel_diff=worst, tol=tol,
                 V_moved=moved, per_field=d)
            check(worst <= tol, f"{label} nout={nout}: {worst} > {tol}")
            check(moved > 0.0, f"{label} nout={nout}: the kernel left V unchanged")
            if not free_slip:
                check(torch.equal(out[0][:, 0], carry[0][:, 0]), f"{label}: ghosts moved")

    # ---- 15. goldens through the default entry points, f64, 16^3
    h3.stokes3d_chunk.launches = 0
    t0 = time.perf_counter()
    geom, st, info = solvi3d.run(dtype=torch.float64)
    nrx = info.norm_Rx.cpu().numpy()
    Vx = st.V.Vx.cpu().numpy()
    xv = np.asarray(geom.xvi[0])
    g = dict(iters=int(info.iters), err=float(info.err),
             norm_Rx_last=float(nrx[np.isfinite(nrx)][-1]),
             boundary_Vx_err=float(max(np.abs(Vx[0, 1:-1, 1:-1] - xv[0]).max(),
                                       np.abs(Vx[-1, 1:-1, 1:-1] - xv[-1]).max())),
             launches=h3.stokes3d_chunk.launches, seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    _, _, info_plain = solvi3d.run(dtype=torch.float64, use_kernel=False)
    g.update(iters_plain=int(info_plain.iters), seconds_plain=time.perf_counter() - t0)
    emit("golden_ve3d", case="solvi3d_16", **g)
    check(st.P.device.type == "cuda", "solvi3d: the default device is not the card")
    check(g["norm_Rx_last"] < 1e-8 and g["iters"] <= 5_000, "solvi3d: norm_Rx")
    check(g["boundary_Vx_err"] <= 1e-12, "solvi3d: boundary Vx")
    check(g["launches"] > 0, "solvi3d: the kernel was not launched")

    h3.stokes3d_chunk.launches = 0
    t0 = time.perf_counter()
    geom, st, info = burstedde.run(nx=16, ny=16, nz=16, iter_max=20_000, nout=1_000,
                                   dtype=torch.float64)
    vx_a, _ = burstedde.analytic_velocity(geom)
    vx = st.V.Vx[:, 1:-1, 8].cpu().numpy()
    rel = float(np.linalg.norm(vx - vx_a) / np.linalg.norm(vx_a))
    emit("golden_ve3d", case="burstedde_16", rel_err=rel, tol=5e-2, iters=int(info.iters),
         err=float(info.err), launches=h3.stokes3d_chunk.launches,
         seconds=time.perf_counter() - t0)
    check(rel < 5e-2, f"burstedde: Vx relative error {rel}")
    check(h3.stokes3d_chunk.launches == 0, "burstedde: the plain path launched B7")

    # ---- 16. main path: SolVi at the production 3D grid, the default entry
    n = 126
    hv.stokes_vep_chunk.launches = hs.stokes_chunk.launches = 0
    ht.thermal_chunk.launches = h3.stokes3d_chunk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, st, info = solvi3d.run(nx=n, ny=n, nz=n, dtype=torch.float32, iter_max=10_000,
                              nout=1_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    main_launches = h3.stokes3d_chunk.launches
    check(st.P.device.type == "cuda", "main path 3D: the default device is not the card")
    finite = all(bool(torch.isfinite(t).all()) for t in (
        st.V.Vx, st.V.Vy, st.V.Vz, st.P, st.tau.xx, st.tau.zz, st.tau.yz, st.tau.xy, st.tau.II))
    emit("main_path_ve3d", n=n, dtype="float32", iters=int(info.iters), err=float(info.err),
         wall_s=wall, wall_ms_per_iter=wall / int(info.iters) * 1e3, launches=main_launches,
         other_launches=hv.stokes_vep_chunk.launches + hs.stokes_chunk.launches
         + ht.thermal_chunk.launches, finite=finite)
    check(finite, "main path 3D: non-finite fields")
    check(main_launches > 0, "main path 3D: the kernel was not launched")

    # the main path's first-chunk inputs, built as the solve builds them;
    # their set-up is part of the solve's wall time
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (carry, co, inv_di), (eta, rho_g, dt) = solvi3d_inputs(n, torch.float32, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(math.isinf(dt), "main path 3D: ve3d_words counts dt = inf only")
    words = ve3d_words(eta, maxloc(eta, 1), rho_g)
    # the kernel and its plain version on those inputs, and the split of the
    # solve's wall time they give
    tk, tp = time_ve3d(carry, co, inv_di, 200, 10)
    t_main, tp_main = min(tk), min(tp)
    bound_main = bound_ms(words, n ** 3, 4, kind)
    kernel_s = t_main * 1e-3 * int(info.iters)
    emit("main_path_ve3d_split", n=n, n_canvas=int(co.stack.shape[0]), words=words,
         kernel_ms_per_iter=tk, plain_ms_per_iter=tp,
         T_eff_GBs=words * n ** 3 * 4 / (t_main * 1e-3) / 1e9, bound_ms=bound_main,
         bound_share=bound_main / t_main, setup_s=setup_s, kernel_s=kernel_s,
         rest_s=wall - setup_s - kernel_s, kernel_share=kernel_s / wall, nvidia_smi=smi)

    # 200 iterations kernel vs plain from the main path's initial state: the
    # kernel reads the packed (uniform canvases as scalars), the plain
    # version the full canvases
    (carry64, co64, _), _ = solvi3d_inputs(n, torch.float64, dev)
    out = h3.stokes3d_chunk(carry, co, inv_di, 200)
    ref = h3.stokes3d_chunk_reference(carry, co, inv_di, 200)
    ref64 = h3.stokes3d_chunk_reference(carry64, co64, inv_di, 200)
    per_field = rel_diffs_ve3d(out, ref)
    worst32, p_vs_64 = max(per_field.values()), max(rel_diffs_ve3d(ref, ref64).values())
    k_vs_64 = max(rel_diffs_ve3d(out, ref64).values())
    tol = max(TOL_F32_1024, 2.0 * p_vs_64)
    emit("f32_126_parity_ve3d", nout=200, max_rel_diff=worst32, tol=tol,
         kernel_vs_plain_f64=k_vs_64, plain_f32_vs_plain_f64=p_vs_64, per_field=per_field)
    check(worst32 <= tol, f"f32 126^3: {worst32} > {tol}")
    out64 = h3.stokes3d_chunk(carry64, co64, inv_di, 200)
    worst64 = max(rel_diffs_ve3d(out64, ref64).values())
    worst_abs = max(worst_abs, abs_diff(out64, ref64))
    emit("f64_126_parity_ve3d", nout=200, max_rel_diff=worst64, tol=TOL_VE3D_NOUT200)
    check(worst64 <= TOL_VE3D_NOUT200, f"f64 126^3: {worst64}")
    del carry, co, carry64, co64, out, ref, ref64, out64

    # ---- 17. timing, bench_kernels.py::ve3d at 126^3 and 254^3 f32
    timing = {}
    for n, nk, npl in ((126, 200, 10), (254, 100, 3)):
        carry, co, inv_di, words = ve3d_bench_inputs(n, torch.float32, dev)
        tk, tp = time_ve3d(carry, co, inv_di, nk, npl)
        t_k, t_p = min(tk), min(tp)
        t_eff = words * n ** 3 * 4 / (t_k * 1e-3)
        bound = bound_ms(words, n ** 3, 4, kind)
        timing[n] = (t_k, t_p, bound)
        emit("timing_ve3d", n=n, dtype="float32", n_canvas=int(co.stack.shape[0]), words=words,
             kernel_ms_per_iter=tk, plain_ms_per_iter=tp, T_eff_GBs=t_eff / 1e9,
             T_eff_35_word_convention_GBs=35 * n ** 3 * 4 / (t_k * 1e-3) / 1e9,
             hbm_peak_GBs=HBM_PEAK[kind] / 1e9, hbm_share=t_eff / HBM_PEAK[kind],
             bound_ms=bound, bound_share=bound / t_k, plain_over_kernel=t_p / t_k,
             nvidia_smi=smi)
        del carry, co
    h3.stokes3d_chunk.launches = main_launches  # comparison launches do not count
    return {
        "name": "stokes3d_chunk",
        "route": "cuda",
        "source": "justrelax_tpu_torch/csrc/stokes3d_ve.cu",
        "replaces": ("justrelax_tpu/ops/pallas_stokes3d_blocked.py:296 "
                     "(B7 stokes3d_chunk_blocked)"),
        "launches": main_launches,
        "max_abs_err": worst_abs,
        "max_rel_diff_f64": worst_rel,
        "max_rel_diff_f32_126": worst32,
        "ms": t_main,
        "plain_ms": tp_main,
        "bound_ms": bound_main,
        "bound_by": "bytes",
        "library_ms": None,
        "ve3d_ms_126": timing[126][0],
        "ve3d_plain_ms_126": timing[126][1],
        "ve3d_bound_ms_126": timing[126][2],
        "ve3d_ms_254": timing[254][0],
        "ve3d_plain_ms_254": timing[254][1],
        "ve3d_bound_ms_254": timing[254][2],
    }


if __name__ == "__main__":
    main()
