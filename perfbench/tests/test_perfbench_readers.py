"""The metric arithmetic on synthetic steps, spans and traces, and the
frozen byte count on tiny inputs."""

import types

import pytest
import torch

from perfbench.core.trace import Trace, clock_offset
from perfbench.counts import vep2d as counts
from perfbench.metrics import _vep
from perfbench.metrics import (chunk_overhead_ms, device_idle_share, iters_per_step,
                               particles_ms_per_step, peak_mem_gib, setup_s, step_mfu,
                               step_s, vep_kernel_roofline)
from perfbench.reference import vep2d

H100 = {"hbm_bytes_per_s": 3.35e12}


def ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


VEP = "void (anonymous namespace)::k_iteration<float, false, 8, 32>(Carry<float>, Inv<float>)"
VE3D = "void (anonymous namespace)::k_iteration<float, 8, 4, true>(Params<float>)"


def synthetic_trace(anchors=None):
    """One step of 1000 µs on the trace's clock (opened by a synchronise
    that ends at 0; the host clock reads 5000 s there): a solve (0–800)
    with two chunk calls, each launching one VEP kernel of 100 µs; a copy;
    another kernel named k_iteration; host work in between."""
    host = lambda us: 5000.0 + us * 1e-6  # noqa: E731
    spans = [("solve_vep", host(0), host(800)), ("stokes_vep_chunk", host(10), host(60)),
             ("stokes_vep_chunk", host(300), host(350))]
    return Trace([
        ev("cuda_runtime", "cudaDeviceSynchronize", -3, 3),
        ev("cuda_runtime", "cudaDeviceSynchronize", 1200, 3),
        ev("cuda_runtime", "cudaLaunchKernel", 20, 5, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 310, 5, corr=2),
        ev("cuda_runtime", "cudaLaunchKernel", 900, 5, corr=3),
        ev("kernel", VEP, 100, 100, corr=1),
        ev("kernel", VEP, 400, 100, corr=2),
        ev("kernel", VE3D, 950, 40, corr=3),
        ev("gpu_memcpy", "Memcpy DtoH", 450, 100),
    ], spans, (host(0), host(1000)), anchors)


def record(**kw):
    base = dict(steps=[], trace=None, counts={}, cfg={"n": 4}, itemsize=4, peak=H100,
                card="NVIDIA H100 80GB HBM3", peak_bytes=3 * 2**30,
                window=types.SimpleNamespace(setup_s=12.5),
                ctx=types.SimpleNamespace(events=None))
    base.update(kw)
    rec = types.SimpleNamespace(**base)
    rec.untraced = lambda: [s for s in rec.steps if not s.get("traced")]
    return rec


def test_trace_busy_gaps_and_kernels():
    tr = synthetic_trace()
    assert tr.window_s() == pytest.approx(1000e-6)
    # kernels 100–200, 400–500 joined with the copy 450–550, the last 950–990
    assert tr.busy_s() == pytest.approx((100 + 150 + 40) * 1e-6)
    assert len(tr.kernels("k_iteration")) == 3
    assert len(tr.kernels(_vep.KERNEL)) == 2  # the third is another file's k_iteration
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["k_iteration<float, false, 8, 32>", pytest.approx(200e-6)]
    gaps = dict(bd["idle_gaps"])
    # each gap goes to the innermost span the host was in where it began:
    # 0–100, 200–400 and 550–950 in the solve, 990–1000 in the step
    assert gaps == {"solve_vep": pytest.approx(700e-6), "step": pytest.approx(10e-6)}
    assert sum(gaps.values()) == pytest.approx(tr.window_s() - tr.busy_s())


def test_trace_aligned_by_its_least_delayed_anchor():
    # the host read the opening synchronise 3 ms late (as it does just after
    # the profiler starts) and the closing one (trace 1203) 2 µs late: the
    # spans keep their places on the trace's clock
    host = lambda us: 5000.0 + us * 1e-6  # noqa: E731
    tr = synthetic_trace(anchors=[host(3000), host(1205)])
    assert tr.lo == pytest.approx(-2.0)
    assert tr.spans[0][:2] == (pytest.approx(-2.0), pytest.approx(798.0))
    assert dict(tr.breakdown()["idle_gaps"])["solve_vep"] == pytest.approx(700e-6, abs=3e-6)
    # a pair far from the others (a synchronise the harness did not make) is left out
    assert clock_offset([0.0, 1000.0, 2000.0], [0.0, 1e-3, 5.0]) == pytest.approx(0.0)


def test_trace_without_a_synchronise():
    # no synchronise to align the host spans: the step is the device's
    # extent, and the spans are left out
    tr = Trace([ev("kernel", VEP, 100, 100, corr=1),
                ev("cuda_runtime", "cudaLaunchKernel", 20, 5, corr=1),
                ev("gpu_memcpy", "Memcpy DtoH", 300, 50)],
               [("stokes_vep_chunk", 1.0, 2.0)], (1.0, 2.0))
    assert tr.window_s() == pytest.approx(250e-6)
    assert tr.busy_s() == pytest.approx(150e-6)
    assert len(tr.kernels(_vep.KERNEL)) == 1
    assert dict(tr.breakdown()["idle_gaps"]) == {"step": pytest.approx(100e-6)}


def test_trace_readers():
    tr = synthetic_trace()
    mat = types.SimpleNamespace()
    rec = record(trace=tr, counts={"vep2d": {"entry": None, "mat": mat}})
    orig = counts.bytes_per_iteration
    try:
        counts.bytes_per_iteration = lambda entry, m, n_cells, itemsize: 1000.0
        # 2 launches × 1000 B over 200 µs at 3.35 TB/s
        assert vep_kernel_roofline.read(rec) == pytest.approx(
            100 * 2000 / (200e-6 * 3.35e12))
    finally:
        counts.bytes_per_iteration = orig
    # untraced steps: 2 solves of 0.5 s with 10 chunk calls each; the trace's
    # kernel takes 100 µs a launch, 3 launches a chunk call (nout = 4)
    rec.cfg = {"n": 4, "solver": {"nout": 4}}
    rec.steps = [{"index": i, "traced": False, "solve_s": 0.5, "chunk_calls": 10}
                 for i in (1, 3)] + [{"index": 2, "traced": True, "solve_s": 9.0,
                                      "chunk_calls": 10}]
    assert chunk_overhead_ms.read(rec) == pytest.approx((1.0 - 100e-6 * 3 * 20) / 20 * 1e3)
    assert device_idle_share.read(rec) == pytest.approx(100 * (1 - 290 / 1000))


def test_step_readers():
    steps = [{"index": 1, "t0": 10.0, "t1": 13.0, "iters": 4000, "traced": False},
             {"index": 2, "t0": 13.0, "t1": 17.0, "iters": 4000, "traced": True},
             {"index": 3, "t0": 17.0, "t1": 20.0, "iters": 2000, "traced": False}]
    rec = record(steps=steps)
    assert step_s.read(rec) == pytest.approx(10.0 / 3)
    assert iters_per_step.read(rec) == pytest.approx(10000 / 3)
    assert setup_s.read(rec) == 12.5
    assert peak_mem_gib.read(rec) == 3.0
    assert peak_mem_gib.read(record(card=None)) is None
    assert vep_kernel_roofline.read(rec) is None  # no trace: nothing to read
    ev_pairs = types.SimpleNamespace(pairs=[1], seconds=lambda keep: sum(
        v for tag, v in ((1, 0.2), (2, 0.9), (3, 0.4)) if keep((tag, "x"))))
    rec.ctx = types.SimpleNamespace(events=ev_pairs)
    assert particles_ms_per_step.read(rec) == pytest.approx((0.2 + 0.4) / 2 * 1e3)


def test_step_mfu_over_untraced_steps():
    steps = [{"index": 1, "t0": 0.0, "t1": 2.0, "iters": 1000, "traced": False},
             {"index": 2, "t0": 2.0, "t1": 9.0, "iters": 1000, "traced": True}]
    rec = record(steps=steps, counts={"vep2d": {"entry": None, "mat": None}})
    orig = counts.bytes_per_iteration
    try:
        counts.bytes_per_iteration = lambda entry, m, n_cells, itemsize: 3.35e9
        assert step_mfu.read(rec) == pytest.approx(100 * 3.35e9 * 1000 / (2.0 * 3.35e12))
    finally:
        counts.bytes_per_iteration = orig


def _mat(phases, pr_c, pr_v):
    return vep2d.material_fields(phases, pr_c, pr_v)


def _shearband_like(n=4, stressed=True):
    pr_c = torch.zeros(n, n, 2, dtype=torch.float64)
    pr_c[..., 0] = 1
    pr_c[1, 1] = torch.tensor([0.0, 1.0])
    pr_v = torch.zeros(n + 1, n + 1, 2, dtype=torch.float64)
    pr_v[..., 0] = 1
    pr_v[1, 1] = torch.tensor([0.0, 1.0])
    phases = {"rho0": [0, 0], "gravity": [0, 0], "G": [1.0, 0.5], "Kb": [4, 4],
              "eta0": [1, 1], "is_plastic": [1, 1], "C": [1.8, 1.8],
              "friction_angle": [30, 30], "dilation_angle": [0, 0], "eta_reg": [8e-3] * 2}
    f = (lambda *s: torch.rand(*s, dtype=torch.float64)) if stressed else \
        (lambda *s: torch.zeros(*s, dtype=torch.float64))
    entry = {"P0": f(n, n), "Q": torch.zeros(n, n, dtype=torch.float64),
             "txx_o": f(n, n), "tyy_o": f(n, n), "txy_c_o": f(n, n),
             "txy_v_o": f(n + 1, n + 1)}
    return entry, _mat(phases, pr_c, pr_v)


def test_count_shear_band_inputs():
    # the carried 23; P0; four old stresses; G at centres and vertices
    entry, mat = _shearband_like()
    assert counts.words_per_cell(entry, mat) == 30
    # the first step: P0 and the old stresses zero, as the port's own count (25)
    entry, mat = _shearband_like(stressed=False)
    assert counts.words_per_cell(entry, mat) == 25
    assert counts.bytes_per_iteration(entry, mat, 16, 4) == 25 * 16 * 4


def test_count_van_keken_inputs():
    n = 4
    pr = torch.zeros(n, n, 2, dtype=torch.float64)
    pr[:, :2, 0] = 1
    pr[:, 2:, 1] = 1
    prv = torch.zeros(n + 1, n + 1, 2, dtype=torch.float64)
    prv[..., 0] = 1
    phases = {"rho0": [1, 2], "gravity": [1, 1], "G": [float("inf")] * 2,
              "Kb": [float("inf")] * 2, "eta0": [1, 1], "is_plastic": [0, 0], "C": [0, 0],
              "friction_angle": [0, 0], "dilation_angle": [0, 0], "eta_reg": [0, 0]}
    r = lambda *s: torch.rand(*s, dtype=torch.float64)  # noqa: E731
    entry = {"P0": r(n, n), "Q": torch.zeros(n, n, dtype=torch.float64), "txx_o": r(n, n),
             "tyy_o": r(n, n), "txy_c_o": r(n, n), "txy_v_o": r(n + 1, n + 1)}
    # moduli infinite: neither P0 nor the old stresses change the result; ρg varies
    assert counts.words_per_cell(entry, _mat(phases, pr, prv)) == 24
