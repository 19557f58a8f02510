"""Two probes of phase 42 of ``chip_smoke.py`` on the card; one JSON line each.

    python -m justrelax_tpu_torch.scripts.probe_distributed

Run from the root of a checkout (it takes its inputs from ``chip_smoke.py``
and ``dist_cases.py``).

1. The wait mode of a rank's CUDA context: in a fresh process, the
   context's flags (``cuCtxGetFlags``) and the wall and CPU seconds of a
   0.75 s wait on the card (``torch.cuda._sleep``) by default, after
   ``dist_cases.wait_by_blocking(True)`` and after
   ``wait_by_blocking(False)``. A spinning wait takes about its wall time
   in CPU time, a blocking one none.
2. Phase 26's count after a process group: B2/B3 and B1/B4 profiled
   (``torch.profiler``, 4 iterations each, three times) before any group
   and after each of five NCCL worlds of one made and torn down, each of
   which runs the SolCx sharded solve and, the fifth, also phase 42's 1024²
   production on the world of one and the serial plain solve. Each line
   gives the ``k_`` kernel events, all events, and how far the wrapper's
   launch counter moved.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

WAIT_CODE = r"""
import ctypes, json, sys, time, torch
import dist_cases as dc
out = dict(mode=sys.argv[1])
torch.zeros(1, device="cuda"); torch.cuda.synchronize()
cu = ctypes.CDLL("libcuda.so.1")
def flags():
    f = ctypes.c_uint(0xFFFF)
    rc = cu.cuCtxGetFlags(ctypes.byref(f))
    return rc, f.value
def wait():
    torch.cuda._sleep(int(1.5e9)); t0, c0 = time.perf_counter(), time.process_time()
    torch.cuda.synchronize()
    return round(time.perf_counter() - t0, 4), round(time.process_time() - c0, 4)
out["flags0"] = flags(); out["wait0"] = wait()
if out["mode"] == "toggle":
    out["set_blocking"] = dc.wait_by_blocking(True)
    out["flags1"] = flags(); out["wait1"] = wait()
    out["set_default"] = dc.wait_by_blocking(False)
    out["flags2"] = flags(); out["wait2"] = wait()
print(json.dumps(out))
"""


def emit(**kw):
    print(json.dumps(kw), flush=True)


def main():
    for mode in ("default", "toggle"):
        r = subprocess.run([sys.executable, "-c", WAIT_CODE, mode], capture_output=True,
                           text=True, timeout=120)
        emit(wait_mode=mode, out=r.stdout.strip()[-2000:], err=r.stderr[-1500:])

    import chip_smoke as cs
    import dist_cases as dc
    from justrelax_tpu_torch.ops import _cuda_build
    from justrelax_tpu_torch.parallel import launch, multihost
    from justrelax_tpu_torch.parallel.mesh import make_grid_mesh
    from torch.profiler import ProfilerActivity, profile

    with ThreadPoolExecutor(2) as pool:
        list(pool.map(_cuda_build.build_library, [cs.hs.SOURCE, cs.hv.SOURCE]))
    cs.hs._library(), cs.hv._library()
    dev = torch.device("cuda:0")
    f32 = torch.float32
    vep_args, vep_kw = cs.chunk_case("shearband", 64, f32, dev)
    ve_args, ve_kw = cs.ve_case("solcx", 64, f32, dev)
    nit = 4
    runs = {
        "stokes_vep_chunk": (lambda: cs.hv.stokes_vep_chunk(*vep_args, nout=nit, **vep_kw),
                             cs.hv.stokes_vep_chunk),
        "stokes_chunk": (lambda: cs.hs.stokes_chunk(*ve_args, nout=nit, **ve_kw),
                         cs.hs.stokes_chunk),
    }

    def probe(tag, reps=3):
        for name, (fn, wrapper) in runs.items():
            for rep in range(reps):
                fn()
                torch.cuda.synchronize()
                c0 = wrapper.launches
                with profile(activities=[ProfilerActivity.CUDA]) as p:
                    out = fn()
                    torch.cuda.synchronize()
                c1 = wrapper.launches
                ev = {e.key[:90]: e.count for e in p.key_averages()}
                k = sum(c for key, c in ev.items() if "(anonymous namespace)::k_" in key)
                ok = all(bool(torch.isfinite(t).all()) for t in out)
                emit(tag=tag, kernel=name, rep=rep, k_events=k, all_events=sum(ev.values()),
                     wrapper_delta=c1 - c0, finite=ok, keys=None if k == nit else ev)

    probe("before_any_group")
    one = dataclasses.replace(dc.suite_cases("card")["ve_solcx"], mesh=(1, 1))
    for trial in range(5):
        t0 = time.perf_counter()
        multihost.initialize(f"127.0.0.1:{launch.free_port()}", 1, 0, backend="nccl",
                             device=dev, timeout=300)
        res = dc.sharded_solve(one, make_grid_mesh((1, 1), device=dev))
        if trial == 4:
            prod = dc.production_vep(make_grid_mesh((1, 1), device=dev), "card")
            emit(prod_ms=prod["ms_per_iter"])
        multihost.shutdown()
        if trial == 4:
            ser = dc.production_serial(dev, "card")
            emit(serial_ms=ser["ms_per_iter"])
        emit(trial=trial, seconds=time.perf_counter() - t0, iters=res["iters"])
        probe(f"after_group_{trial}")


if __name__ == "__main__":
    main()
