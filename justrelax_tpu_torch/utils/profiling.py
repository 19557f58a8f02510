"""Tracing, performance metrics and run observability.

Counterpart of ``justrelax_tpu/utils/profiling.py``. The reference's
observability layer is ``@elapsed`` wall-clock accumulation in the solvers
(Stokes2D.jl:66), residual histories, NaN aborts
(``isnan(err) && error("NaN(s)")``, Stokes2D.jl:144) and a
``versioninfo()`` report (JustRelax.jl:87-165). Here: a ``torch.profiler``
trace, a wall clock that waits for the card, the effective memory
bandwidth (T_eff) figure of merit of the APT method (Räss et al. 2022),
NaN/divergence guards for solves that live on the card, and an environment
report.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from justrelax_tpu_torch.core.device import host

__all__ = [
    "trace",
    "timed",
    "effective_bandwidth",
    "solve_report",
    "assert_finite",
    "report_env",
]


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block with ``torch.profiler`` (CPU and, where
    the card is there, CUDA activities) and write a Chrome trace,
    ``<logdir>/trace.json`` (chrome://tracing, Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def timed(out: Dict[str, float], key: str = "wall_s"):
    """Wall-clock a block into ``out[key]`` (the reference's ``@elapsed``
    around the solver loop), waiting at exit for the card's queued work
    where CUDA is in use. The JAX package's docstring promises that wait,
    but its body does not block, which on an asynchronous device times only
    the dispatch."""
    t0 = time.perf_counter()
    yield
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    out[key] = time.perf_counter() - t0


def effective_bandwidth(ni, t_iter: float, n_fields: int = 23, dtype_bytes: int = 8):
    """T_eff [GB/s]: the APT figure of merit, the necessary memory traffic
    of one fused PT iteration over its wall time (Räss et al. 2022
    convention: ``n_fields`` = reads+writes of unknowns + reads of fields;
    23 for the 2D VE Stokes iteration)."""
    n = 1
    for d in ni:
        n *= int(d)
    return n_fields * n * dtype_bytes / max(t_iter, 1e-300) / 1.0e9


def solve_report(
    info,
    ni,
    wall_s: float,
    n_fields: int = 23,
    dtype_bytes: int = 8,
    hbm_peak_gbs: Optional[float] = None,
) -> Dict[str, float]:
    """Summarize a solve: iterations, final residual, grid-updates/s, T_eff
    (and the fraction of the HBM peak if ``hbm_peak_gbs`` is given)."""
    iters = int(info.iters)
    n = 1
    for d in ni:
        n *= int(d)
    t_iter = wall_s / max(iters, 1)
    out = {
        "iters": float(iters),
        "err": float(info.err),
        "wall_s": float(wall_s),
        "gups": n * max(iters, 1) / max(wall_s, 1e-300) / 1.0e9,
        "T_eff_GBs": effective_bandwidth(ni, t_iter, n_fields, dtype_bytes),
    }
    if hbm_peak_gbs:
        out["frac_speed_of_light"] = out["T_eff_GBs"] / hbm_peak_gbs
    return out


def assert_finite(*arrays_or_info, context: str = "solve"):
    """Host-side NaN/Inf guard (the reference's ``isnan(err) &&
    error("NaN(s)")`` / DYREL ``err > 1e10 && error("Kaboom!")``). Accepts
    tensors, arrays and solver info objects (anything with ``.err``); each
    is read to the host once."""
    for a in arrays_or_info:
        v = host(getattr(a, "err", a))
        if not np.isfinite(v).all():
            raise FloatingPointError(
                f"NaN(s)/Inf in {context}: {type(a).__name__}"
            )
        if v.size == 1 and abs(float(v)) > 1.0e10:
            raise FloatingPointError(
                f"divergence in {context}: |err| = {float(v):.3e} > 1e10"
            )


def report_env() -> Dict[str, str]:
    """Runtime report (the reference's ``versioninfo()``,
    JustRelax.jl:87-165): torch and CUDA versions, the backend, the devices
    and torch's default dtype."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    info = {
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
        "backend": "cuda" if n else "cpu",
        "devices": ", ".join(torch.cuda.get_device_name(i) for i in range(n)) or "cpu",
        "n_devices": str(max(n, 1)),
        "default_dtype": str(torch.get_default_dtype()),
    }
    for k, v in info.items():
        print(f"{k:>13}: {v}")
    return info
