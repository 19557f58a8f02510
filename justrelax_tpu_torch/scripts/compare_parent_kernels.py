"""Time the redesigned chunk kernels of a parent tree against this tree's, in
turns, on one card.

    python -m justrelax_tpu_torch.scripts.compare_parent_kernels PARENT_DIR
        [--kernels 2d,b7,b8,edges,step,r] [--n 1024] [--iters 200]

Run from the root of a checkout (it takes its inputs from ``chip_smoke.py``).
``PARENT_DIR`` holds the parent's ``justrelax_tpu_torch/ops/hopper_*.py``
wrappers and their ``justrelax_tpu_torch/csrc/*.cu`` sources, for example
unpacked from ``git archive <commit> justrelax_tpu_torch/ops
justrelax_tpu_torch/csrc``. Each parent wrapper is loaded from there with its
own kernel source (built like this tree's, into ``justrelax_tpu_torch/_build/``).
Both versions run on the main paths' first-chunk inputs, in turns parent,
this tree, this tree, parent, by CUDA events:

- ``2d``: B2/B3 at 1024² f32 on the shear band's first step and near yield,
  B1/B4 on SolCx (gap after 200 iterations);
- ``b7``: B7 on the SolVi 126³ f32 solve's first chunk (gap after 200);
- ``b8``: B8 on the ShearBand3D 126³ f32 step's first chunk on
  ``"blocked"`` and on its set-up near yield (gap after 50);
- ``edges``: B6 and B9 per call on the step's first-chunk inputs on
  ``"edges"`` and ``"edges_split"`` and on its set-up near yield (gap after
  one call);
- ``step``: the ShearBand3D 126³ f32 step through ``shearband3d.run`` on
  ``"edges"`` (B6) and 200 iterations of it on ``"edges_split"`` (B9), the
  solver's edge kernel swapped for the parent's and back, in turns, by the
  host clock: wall time, ms per hybrid iteration, iterations and τII max;
- ``r``: R (the 2D dynamic-window copy) at the repro script's shape in each
  mode, by the card's time per copy (``chip_smoke.device_time_ms``, which
  keeps the host's queueing out of the events) and the host's wall time per
  copy beside it, each version held bit-equal to the plain version.

Each line holds the bound from the words those inputs need and the largest
difference of each version from the plain version after the stated number
of iterations, relative to each field's max. Prints one JSON line per kernel
and state.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time
from pathlib import Path

import torch

import chip_smoke as cs
from justrelax_tpu_torch.models import shearband, shearband3d, solcx
from justrelax_tpu_torch.ops import hopper_stokes as hs
from justrelax_tpu_torch.ops import hopper_stokes3d as h3
from justrelax_tpu_torch.ops import hopper_stokes3d_vep as hc
from justrelax_tpu_torch.ops import hopper_stokes_vep as hv
from justrelax_tpu_torch.ops import hopper_vep3d_edges as he
from justrelax_tpu_torch.ops import hopper_window_copy as hw
from justrelax_tpu_torch.ops.stencil import maxloc
from justrelax_tpu_torch.scripts import repro_2d_dma as rp
from justrelax_tpu_torch.solvers.stokes3d_vep import canvas_chunk_inputs


def load_parent(parent: Path, name: str):
    """The parent's ``ops/<name>.py`` as a module of its own, its ``SOURCE``
    pointed at the parent's kernel source."""
    return cs.load_parent(name, parent)


def vep_states(n, dev):
    geometry, material, pr_c, pr_v, st0, pt, _ = shearband._setup(
        n, dict(rho0=0.0, Kb=4.0, eta0=1.0, is_plastic=1.0,
                C=1.6 / math.cos(math.radians(30.0)), friction_angle=30.0,
                eta_reg=8.0e-3), 0.5, torch.float32, dev,
        eps_rel=1.0e-6, CFL=0.75 / math.sqrt(2.1))
    return {"initial": (cs.chunk_inputs_from_state(st0, material, pr_c, pr_v, geometry, pt,
                                                   0.25), {}),
            "near_yield": cs.chunk_case("shearband", n, torch.float32, dev)}


def solcx_inputs(n, dev):
    geometry, st0, pt, _, rho_g, G, K, _ = solcx._setup(n, n, 1e6, 1.0, 1.0, torch.float32,
                                                        dev)
    eta = st0.viscosity.eta
    args = (st0.V.Vx, st0.V.Vy, st0.P, st0.tau.xx, st0.tau.yy, st0.tau.xy,
            eta, maxloc(eta, 1), *rho_g, 1.0 / geometry.di[0], 1.0 / geometry.di[1],
            pt.r, pt.theta_dtau, pt.etadtau)
    kw = dict(G=G, K=K, P0=st0.P0, Q=st0.Q,
              tau_o=(st0.tau_o.xx, st0.tau_o.yy, st0.tau_o.xy), dt=0.1)
    return args, kw


def in_turns(old, new, nk):
    """ms per iteration of ``old(nout)`` and ``new(nout)`` in turns old,
    new, new, old."""
    def t(fn):
        return cs.cuda_time_ms(lambda: fn(nk)) / nk

    o1, n1, n2, o2 = t(old), t(new), t(new), t(old)
    return [o1, o2], [n1, n2]


def runs_2d(parent, dev, n):
    """(kernel, state, parent(nout), new(nout), plain(nout), rel, words,
    cells, gap iterations, extra keys) of B2/B3 and B1/B4."""
    old_vep, old_ve = load_parent(parent, "hopper_stokes_vep"), load_parent(parent,
                                                                            "hopper_stokes")
    out = []
    for label, (args, kw) in vep_states(n, dev).items():
        out.append(("B2/B3 stokes_vep_chunk", label,
                    lambda k, a=args, w=kw: old_vep.stokes_vep_chunk(*a, nout=k, **w),
                    lambda k, a=args, w=kw: hv.stokes_vep_chunk(*a, nout=k, **w),
                    lambda k, a=args, w=kw: hv.stokes_vep_chunk_reference(*a, nout=k, **w),
                    cs.rel_diffs, hv.vep_chunk_words(*args, **kw), n * n, 200,
                    {"bench_words": cs.WORDS_VEP}))
    args, kw = solcx_inputs(n, dev)
    out.append(("B1/B4 stokes_chunk", "solcx",
                lambda k: old_ve.stokes_chunk(*args, nout=k, **kw),
                lambda k: hs.stokes_chunk(*args, nout=k, **kw),
                lambda k: hs.stokes_chunk_reference(*args, nout=k, **kw),
                cs.rel_diffs_ve, hs.ve_chunk_words(*args, **kw), n * n, 200,
                {"bench_words": cs.WORDS_VE}))
    return out


def runs_b7(parent, dev, n=126):
    """B7 on the SolVi n³ f32 solve's first-chunk inputs."""
    old = load_parent(parent, "hopper_stokes3d")
    (carry, packed, inv_di), (eta, rho_g, _) = cs.solvi3d_inputs(n, torch.float32, dev)
    old_packed = old.pack_coeffs(packed.co)
    words = cs.ve3d_words(eta, maxloc(eta, 1), rho_g)
    return [("B7 stokes3d_chunk", "solvi3d",
             lambda k: old.stokes3d_chunk(carry, old_packed, inv_di, k),
             lambda k: h3.stokes3d_chunk(carry, packed, inv_di, k),
             lambda k: h3.stokes3d_chunk_reference(carry, packed, inv_di, k),
             cs.rel_diffs_ve3d, words, n ** 3, 200,
             {"streamed_words": h3.streamed_words(packed)})]


def runs_b8(parent, dev, n=126):
    """B8 on the ShearBand3D n³ f32 step's first chunk on "blocked", and on
    its set-up near yield."""
    old = load_parent(parent, "hopper_stokes3d_vep")
    out = []
    for label, (carry, co, inv_di, kw) in cs.vep3d_chunk_states(n, torch.float32,
                                                                 dev).items():
        old_co = old.pack_chunk_consts(co.co)
        out.append(("B8 stokes3d_vep_chunk", label,
                    lambda k, c=carry, o=old_co, i=inv_di, w=kw: old.stokes3d_vep_chunk(
                        c, o, i, k, **w),
                    lambda k, c=carry, o=co, i=inv_di, w=kw: hc.stokes3d_vep_chunk(
                        c, o, i, k, **w),
                    lambda k, c=carry, o=co, i=inv_di, w=kw: hc.stokes3d_vep_chunk_reference(
                        c, o, i, k, **w),
                    cs.rel_diffs_vep3d, cs.vep3d_chunk_words(co), n ** 3, 50, {}))
    return out


def runs_edges(parent, dev, n=126):
    """B6 and B9 (which share B8's return mapping) per call, on the
    ShearBand3D n³ f32 step's first-chunk inputs on their routes and on its
    set-up near yield (λ_e > 0, the yield branch at full width); a timed
    call of ``nout`` runs that many calls."""
    old = load_parent(parent, "hopper_vep3d_edges")
    geometry, st0, material, (pr_c, pr_e), _, pt, dt = shearband3d._setup(n, torch.float32,
                                                                          dev)
    kw = dict(dt=dt, r=pt.r, theta_dtau=pt.theta_dtau, etadtau=pt.etadtau,
              lambda_relaxation=0.2, viscosity_relaxation=1.0)
    inv_di = tuple(1.0 / d for d in geometry.di)
    near, co6, co9, _, inv_near, kw_near = cs.vep3d_case("shearband3d_kb_inf", torch.float32,
                                                         dev, n=n)

    def rel(a, b):
        return cs.rel_diffs_edges((*a[0], *a[1]), (*b[0], *b[1]))

    def calls(fn, args, ekw, split):
        def run(k):
            for _ in range(k):
                out = fn(*args, split=split, **ekw)
            return out
        return run

    out = []
    for name, route, split in (("B6 vep3d_edges", "edges", False),
                               ("B9 vep3d_edges_split", "edges_split", True)):
        carry, _, packed = canvas_chunk_inputs(st0, material, pr_c, pr_e, route=route)
        near_packed = he.pack_edge_consts(co9 if split else co6, split)
        for label, (args, ekw) in (("first_chunk", cs.edge_args(carry, packed, inv_di, kw)),
                                   ("near_yield", cs.edge_args(near, near_packed, inv_near,
                                                               kw_near))):
            old_args = args[:6] + (old.pack_edge_consts(args[6].co, split),) + args[7:]
            out.append((name, label, calls(old.vep3d_edges, old_args, ekw, split),
                        calls(he.vep3d_edges, args, ekw, split),
                        calls(he.vep3d_edges_reference, args, ekw, split), rel,
                        cs.vep3d_edges_words(args[6]), n ** 3, 1, {"per": "call"}))
    return out


def steps(parent, dev, smi, n=126):
    """Print one line per route of the ShearBand3D n³ f32 step through the
    parent's edge kernel and this tree's, in turns parent, this, this,
    parent (the solver's ``vep3d_edges`` swapped; the parent packs its
    consts once per solve, as the solver does)."""
    from justrelax_tpu_torch.solvers import stokes3d_vep as solver

    old = load_parent(parent, "hopper_vep3d_edges")
    packs = {}

    def old_edges(*args, co, split=False, **kw):
        key = (id(co), split)
        if key not in packs:
            packs[key] = (co, old.pack_edge_consts(co.co, split))
        return old.vep3d_edges(*args, co=packs[key][1], split=split, **kw)

    for route, kw in (("edges", dict(iter_max=2_000, nout=200)),
                      ("edges_split", dict(iter_max=200, nout=100))):
        res = {"parent": [], "new": []}
        for who in ("parent", "new", "new", "parent"):
            solver.vep3d_edges = old_edges if who == "parent" else he.vep3d_edges
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, info, tau, _ = shearband3d.run(n=n, nt=1, dtype=torch.float32, use_kernel=route,
                                              **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            res[who].append((wall, int(info.iters), float(tau[-1])))
            packs.clear()
        solver.vep3d_edges = he.vep3d_edges
        iters = res["new"][0][1]
        print(json.dumps({
            "step": "shearband3d", "route": route, "n": n, "dtype": "float32", "iters": iters,
            "iters_parent": res["parent"][0][1],
            "parent_s": [r[0] for r in res["parent"]], "new_s": [r[0] for r in res["new"]],
            "parent_ms_per_iter": [r[0] / r[1] * 1e3 for r in res["parent"]],
            "new_ms_per_iter": [r[0] / r[1] * 1e3 for r in res["new"]],
            "tauII_max_parent": res["parent"][0][2], "tauII_max_new": res["new"][0][2],
            "tauII_max_gap": abs(res["new"][0][2] - res["parent"][0][2]),
            "nvidia_smi": smi}), flush=True)


def window_copy_turns(parent, dev, smi, kind):
    """Print one line per mode of R: the parent's and this tree's time per
    copy on the card and on the host's clock, in turns parent, this, this,
    parent."""
    old = load_parent(parent, "hopper_window_copy")
    shape = (rp.N, rp.X, rp.Y, rp.Z)
    geom = dict(W=rp.W, Wy=rp.Wy, R=rp.R, Ry=rp.Ry)
    src = torch.arange(math.prod(shape), dtype=torch.float32, device=dev).reshape(shape) / 1e6
    bound = 2 * rp.X * rp.Y * rp.Z * 4 / cs.HBM_PEAK[kind] * 1e3
    for mode in hw.MODES:
        ref = hw.window_copy_reference(src, mode, **geom)
        fns = {"parent": lambda: old.window_copy(src, mode, **geom),
               "new": lambda: hw.window_copy(src, mode, **geom)}
        for who, fn in fns.items():
            out = fn()
            torch.cuda.synchronize()
            cs.check(torch.equal(out, ref), f"window_copy {mode}: {who} differs from plain")
        res = {"parent": [], "new": []}
        for who in ("parent", "new", "new", "parent"):
            res[who].append(cs.device_time_ms(fns[who]))
        best = {who: min(r["ms"] for r in v) for who, v in res.items()}
        print(json.dumps({
            "kernel": "R window_copy", "mode": mode, "shape": list(shape), "dtype": "float32",
            "parent_ms": [r["ms"] for r in res["parent"]],
            "new_ms": [r["ms"] for r in res["new"]],
            "parent_wall_ms": [r["wall_ms"] for r in res["parent"]],
            "new_wall_ms": [r["wall_ms"] for r in res["new"]],
            "parent_wall_min_ms": min(r["wall_min_ms"] for r in res["parent"]),
            "new_wall_min_ms": min(r["wall_min_ms"] for r in res["new"]),
            "queued": all(r["queued"] for v in res.values() for r in v),
            "speedup": best["parent"] / best["new"], "bound_ms": bound,
            "parent_bound_share": bound / best["parent"],
            "new_bound_share": bound / best["new"], "nvidia_smi": smi}), flush=True)


RUNS = {"2d": runs_2d, "b7": runs_b7, "b8": runs_b8, "edges": runs_edges}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("parent", type=Path)
    p.add_argument("--kernels", default="2d,b7,b8,edges",
                   help="comma-separated: " + ", ".join(RUNS) + ", step, r")
    p.add_argument("--n", type=int, default=1024, help="the 2D grid")
    p.add_argument("--iters", type=int, default=200, help="iterations per timed call")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_parent_kernels: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = "PCIe" if "PCIe" in torch.cuda.get_device_name(0) else "SXM"
    for key in a.kernels.split(","):
        if key == "step":
            steps(a.parent, dev, smi)
            continue
        if key == "r":
            window_copy_turns(a.parent, dev, smi, kind)
            continue
        args = (a.parent, dev, a.n) if key == "2d" else (a.parent, dev)
        for name, label, old, new, plain, rel, words, cells, gap_it, extra in RUNS[key](*args):
            o, nw = in_turns(old, new, a.iters)
            ref = plain(gap_it)
            gap_new = max(rel(new(gap_it), ref).values())
            gap_old = max(rel(old(gap_it), ref).values())
            gap_pair = max(rel(new(gap_it), old(gap_it)).values())
            bound = cs.bound_ms(words, cells, 4, kind)
            line = {
                "kernel": name, "state": label, "cells": cells, "dtype": "float32",
                "parent_ms_per_iter": o, "new_ms_per_iter": nw,
                "speedup": min(o) / min(nw), "words": words, "bound_ms": bound,
                "parent_bound_share": bound / min(o), "new_bound_share": bound / min(nw),
                f"parent_vs_plain_{gap_it}": gap_old, f"new_vs_plain_{gap_it}": gap_new,
                f"new_vs_parent_{gap_it}": gap_pair, "nvidia_smi": smi}
            if "bench_words" in extra:
                extra = dict(extra, bound_ms_bench_words=cs.bound_ms(
                    extra["bench_words"], cells, 4, kind))
            print(json.dumps({**line, **extra}), flush=True)


if __name__ == "__main__":
    main()
