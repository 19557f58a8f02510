"""One run of one cell: everything found by name, set up, warmed up,
measured, checked, reported.

A cell ``<config>.<traffic>`` is ``perfbench/workloads/<cell>.json``; it
names its configuration (``perfbench/configs/<config>.json``, whose
``model`` names the driver ``perfbench/drivers/<model>.py``) and its
traffic (``perfbench/traffic/<traffic>.json``: the precision and what else
the run is given). Each metric of ``BENCHMARK.json`` is read by
``perfbench/metrics/<metric>.py``. A later cell, configuration or metric
comes as new files and entries."""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import math
import shutil
import sys
import tempfile
from pathlib import Path

import torch

from perfbench.core import peaks
from perfbench.core.trace import Trace
from perfbench.core.window import StepWindow, StopWindow

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "justrelax_tpu")
DTYPES = {"float32": torch.float32, "float64": torch.float64}
LOWER = {torch.float64: torch.float32, torch.float32: torch.bfloat16}


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark():
    return load_json(ROOT / "BENCHMARK.json")


def benchmark_cell(name):
    """The cell's entry in ``BENCHMARK.json`` (empty where it has none)."""
    return next((w for w in benchmark()["workloads"] if w["name"] == name), {})


def workload(name):
    return load_json(BENCH / "workloads" / f"{name}.json")


def config(name):
    return load_json(BENCH / "configs" / f"{name}.json")


def traffic(name):
    return load_json(BENCH / "traffic" / f"{name}.json")


def driver(model):
    return importlib.import_module(f"perfbench.drivers.{model}")


def reader(metric):
    return importlib.import_module(f"perfbench.metrics.{metric}")


def forbidden_modules():
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's (whole names: the port's name starts with the package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@contextlib.contextmanager
def patched(items):
    """Each (module, name, replacement) set for the duration."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in items]
    for m, n, v in items:
        setattr(m, n, v)
    try:
        yield
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


def run_model(fn, **kwargs):
    """Run a model's entry until the window closes at a step boundary."""
    try:
        fn(**kwargs)
    except StopWindow:
        return
    raise RuntimeError("the model's run ended before the window closed")


class Context:
    """What a driver is given and fills in."""

    def __init__(self, cell, cfg, traf, seed, seconds, trace, device, t_process, tmpdir):
        self.cell, self.cfg, self.traffic = cell, cfg, traf
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.dtype = DTYPES[traf["dtype"]]
        self.kernel_kw = {} if self.device.type == "cuda" else {"use_kernel": True}
        self.captures = {}
        self.counts = {}
        self.events = None
        self.hooks = None
        check_step = 1 + (self.seed % int(cell["check_steps"]))
        self.window = StepWindow(t_process, seconds, self.device, check_step, trace, tmpdir)


def metrics_for(bench, cell_name, section):
    """The metrics of ``section`` that this cell reports."""
    out = []
    for m in bench[section]:
        if "workloads" in m and cell_name not in m["workloads"]:
            continue
        out.append(m)
    return out


def within(values, limits):
    """``correct``: every number compared at or under its limit."""
    return all(name in values and values[name] <= limits[name] for name in limits)


def run_cell(cell_name, seed, seconds, trace, device, t_process, cfg_override=None,
             faults=(), control=False):
    """One run; returns the result's dict (the line the command prints) and
    the worst field of each number compared. ``cfg_override`` and
    ``faults`` (callables given the context before the run, as
    ``perfbench/faults.py`` makes them) serve the tests and the readings of
    planted faults; ``control`` adds, under ``"control"``, the numbers that
    the reference computed one precision lower gives in the program's place
    and, under ``"control_correct"``, what ``correct`` makes of them
    (``perfbench/control.py``; the benchmark's runs never compute it)."""
    bench = benchmark()
    cell = workload(cell_name)
    cfg = config(cell["config"])
    if cfg_override:
        cfg = {**cfg, **cfg_override}
    traf = traffic(cell["traffic"])
    drv = driver(cfg["model"])
    tmpdir = tempfile.mkdtemp(prefix="perfbench_")
    ctx = Context(cell, cfg, traf, seed, seconds, trace, device, t_process, tmpdir)
    for fault in faults:
        fault(ctx)
    dev = ctx.device
    if dev.type == "cuda":
        torch.cuda.init()
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        drv.run(ctx)
    finally:
        ctx.window.close()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    found = forbidden_modules()
    if found:
        raise SystemExit(f"perfbench: loaded {', '.join(found)} in the measured process")

    trace_path = ctx.window.export_trace()
    tr = Trace.load(trace_path, ctx.window.host_spans, ctx.window.traced_interval(),
                    ctx.window.anchors) if trace_path else None
    shutil.rmtree(tmpdir, ignore_errors=True)

    values, worst = drv.readings(ctx)
    limits = cell["limits"]

    rec = Record(ctx, peak, tr)
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_for(bench, cell_name, section):
        v = reader(m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    steps = ctx.window.window_steps()
    result = {
        "correct": within(values, limits),
        "attempted": len(steps),
        "failed": sum(1 for s in steps if s.get("failed")),
        "metrics": metrics,
        "device": rec.device_info(trace),
    }
    if tr is not None:
        result["breakdown"] = tr.breakdown()
    if control:
        low, _ = drv.readings(ctx, low=LOWER[ctx.dtype])
        result["control"] = low
        result["control_correct"] = within(low, limits)
    result["window"] = {"sampled_step": ctx.window.check_step,
                        "steps_s": [s["t1"] - s["t0"] for s in steps],
                        "iters": [s.get("iters") for s in steps],
                        "traced": [bool(s.get("traced")) for s in steps]}
    result["checks"] = {k: {"value": values.get(k, math.inf), "limit": limits[k]}
                        for k in limits}
    return result, worst


class Record:
    """What the metric readers read: the window's steps, the trace, the
    counts, the peaks."""

    def __init__(self, ctx, peak_bytes, trace):
        self.ctx = ctx
        self.cfg = ctx.cfg
        self.steps = ctx.window.window_steps()
        self.window = ctx.window
        self.peak_bytes = int(peak_bytes)
        self.trace = trace
        self.counts = ctx.counts
        self.itemsize = torch.tensor([], dtype=ctx.dtype).element_size()
        self.card = torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda" else None
        self.peak = peaks.for_card(self.card)

    def untraced(self):
        return [s for s in self.steps if not s.get("traced")]

    def device_info(self, trace):
        info = {"platform": "gpu" if self.card else "cpu", "kind": self.card or "cpu",
                "count": 1, "memory_peak_bytes": self.peak_bytes}
        if trace and self.trace is not None:
            info["busy_s"] = self.trace.busy_s()
            info["window_s"] = self.trace.window_s()
        return info
