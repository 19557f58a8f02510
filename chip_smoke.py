#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (justrelax_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printing one JSON line:

0. device   : the card's name and power limit (nvidia-smi).
1. build    : nvcc builds the Hopper kernel library from justrelax_tpu_torch/csrc.
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

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from justrelax_tpu_torch.core.grid import Geometry  # noqa: E402
from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs  # noqa: E402
from justrelax_tpu_torch.models import shearband  # noqa: E402
from justrelax_tpu_torch.models.shearband import _circle_phase_ratios  # noqa: E402
from justrelax_tpu_torch.ops import hopper_stokes_vep as hv  # noqa: E402
from justrelax_tpu_torch.ops.bc import Faces, VelocityBoundaryConditions, flow_bcs  # noqa: E402
from justrelax_tpu_torch.ops.stencil import av_vertex_to_center, expand_edges  # noqa: E402
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
    """A chunk argument in float64 (tensors and the material stack)."""
    if isinstance(x, torch.Tensor):
        return x.double()
    if isinstance(x, MaterialStack):
        return x.to(dtype=torch.float64)
    return x


def f32_gaps(args, kw, nout):
    """Kernel against plain in f32, and both against the plain version in
    f64 on the same inputs: how far the kernel is from the plain version,
    and how far f32 rounding alone takes the plain version."""
    out = hv.stokes_vep_chunk(*args, nout=nout, **kw)
    ref = hv.stokes_vep_chunk_reference(*args, nout=nout, **kw)
    ref64 = hv.stokes_vep_chunk_reference(
        *map(to_f64, args), nout=nout, **{k: to_f64(v) for k, v in kw.items()})
    gap = rel_diffs(out, ref)
    return gap, max(gap.values()), max(rel_diffs(out, ref64).values()), \
        max(rel_diffs(ref, ref64).values()), float(ref[10].max())


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

    # ---- 1. build
    t0 = time.perf_counter()
    lib_path = hv.build_library()
    hv._library()
    build_s = time.perf_counter() - t0
    log = lib_path.with_suffix(".log")
    ptxas = [ln.strip() for ln in (log.read_text().splitlines() if log.exists() else [])
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=build_s, library=os.path.relpath(lib_path, ROOT), ptxas=ptxas)

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
    hv.stokes_vep_chunk.launches = 0
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
        per_field, gap, k_vs_64, p_vs_64, lam_max = f32_gaps(args, kw, 200)
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
    bytes_iter = 39 * n * n * 4
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

    print(json.dumps({"kernels": [{
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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
