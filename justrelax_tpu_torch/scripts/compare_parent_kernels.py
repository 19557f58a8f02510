"""Time the 2D chunk kernels of a parent tree against this tree's, in turns,
on one card.

    python -m justrelax_tpu_torch.scripts.compare_parent_kernels PARENT_DIR

Run from the root of a checkout (it takes its inputs from ``chip_smoke.py``).
``PARENT_DIR`` holds the parent's ``justrelax_tpu_torch/ops/hopper_stokes.py``
and ``hopper_stokes_vep.py`` and their ``justrelax_tpu_torch/csrc/stokes_ve.cu``
and ``stokes_vep.cu``, for example unpacked from ``git archive <commit>``.
Each parent wrapper is loaded from there with its own kernel source (built
like this tree's, into ``justrelax_tpu_torch/_build/``). Both versions run
on the main paths' first-chunk inputs at 1024² f32 (the shear band's first
step, the shear band near yield, SolCx), in turns parent, this tree, this
tree, parent, by CUDA events; each line also holds the bound from the words
those inputs need and the two versions' largest difference after 200
iterations. Prints one JSON line per kernel and state.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import subprocess
from pathlib import Path

import torch

import chip_smoke as cs
from justrelax_tpu_torch.models import shearband, solcx
from justrelax_tpu_torch.ops import hopper_stokes as hs
from justrelax_tpu_torch.ops import hopper_stokes_vep as hv
from justrelax_tpu_torch.ops.stencil import maxloc


def load_parent(parent: Path, name: str):
    """The parent's ``ops/<name>.py`` as a module of its own, its ``SOURCE``
    pointed at the parent's kernel source."""
    path = parent / "justrelax_tpu_torch" / "ops" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"parent_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.SOURCE = parent / "justrelax_tpu_torch" / "csrc" / mod.SOURCE.name
    return mod


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


def in_turns(old, new, args, kw, nk):
    """ms per iteration of ``old`` and ``new`` in turns old, new, new, old."""
    def t(fn):
        return cs.cuda_time_ms(lambda: fn(*args, nout=nk, **kw)) / nk

    o1, n1, n2, o2 = t(old), t(new), t(new), t(old)
    return [o1, o2], [n1, n2]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("parent", type=Path)
    p.add_argument("--n", type=int, default=1024)
    p.add_argument("--iters", type=int, default=500)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_parent_kernels: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = "PCIe" if "PCIe" in torch.cuda.get_device_name(0) else "SXM"
    old_vep, old_ve = load_parent(a.parent, "hopper_stokes_vep"), load_parent(a.parent,
                                                                              "hopper_stokes")
    n = a.n
    runs = [("B2/B3 stokes_vep_chunk", label, old_vep.stokes_vep_chunk, hv.stokes_vep_chunk,
             hv.stokes_vep_chunk_reference, cs.rel_diffs, args, kw,
             hv.vep_chunk_words(*args, **kw), cs.WORDS_VEP)
            for label, (args, kw) in vep_states(n, dev).items()]
    args, kw = solcx_inputs(n, dev)
    runs.append(("B1/B4 stokes_chunk", "solcx", old_ve.stokes_chunk, hs.stokes_chunk,
                 hs.stokes_chunk_reference, cs.rel_diffs_ve, args, kw,
                 hs.ve_chunk_words(*args, **kw), cs.WORDS_VE))
    for name, label, old, new, plain, rel, args, kw, words, words_bench in runs:
        o, nw = in_turns(old, new, args, kw, a.iters)
        ref = plain(*args, nout=200, **kw)
        gap_new = max(rel(new(*args, nout=200, **kw), ref).values())
        gap_old = max(rel(old(*args, nout=200, **kw), ref).values())
        bound = cs.bound_ms(words, n * n, 4, kind)
        print(json.dumps({
            "kernel": name, "state": label, "n": n, "dtype": "float32",
            "parent_ms_per_iter": o, "new_ms_per_iter": nw,
            "speedup": min(o) / min(nw), "words": words, "bound_ms": bound,
            "parent_bound_share": bound / min(o), "new_bound_share": bound / min(nw),
            "bench_words": words_bench,
            "bound_ms_bench_words": cs.bound_ms(words_bench, n * n, 4, kind),
            "parent_vs_plain_200": gap_old, "new_vs_plain_200": gap_new,
            "nvidia_smi": smi}), flush=True)


if __name__ == "__main__":
    main()
