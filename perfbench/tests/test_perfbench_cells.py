"""Each cell driven on the CPU at a tiny size, past the harness's look for
a card: the plain reference agrees with the port's plain path, and
``correct`` comes out false with the timed path broken underneath and with
the control (the reference one precision lower) in the program's place."""

import time

import pytest

from perfbench import faults
from perfbench.core import harness

SOLVER = {"eps_rel": 1e-6, "Re": 9.42477796076938, "lambda_relaxation": 0.2,
          "viscosity_relaxation": 0.01}
TINY = {
    "shearband2d-1024": {"n": 16, "solver": dict(SOLVER, iter_max=100, nout=20, eps_abs=1e-12,
                                                 CFL=0.5175491695067657, r=0.7)},
    "vankeken-1024": {"n": 16, "particles": {"per_cell": 6, "slots": 12, "min_per_cell": 3},
                      "solver": dict(SOLVER, iter_max=200, nout=20, eps_abs=1e-8,
                                     CFL=0.6900655593423541, r=1.0)},
}
CELLS = sorted(p.stem for p in (harness.BENCH / "workloads").glob("*.json"))
SEED = 2**31 + 12345


def run(cell, faults=(), control=False, seed=SEED):
    cfg = harness.workload(cell)["config"]
    return harness.run_cell(cell, seed, 0.0, 0, "cpu", time.perf_counter(),
                            cfg_override=TINY[cfg], faults=faults, control=control)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_plain_path(cell):
    res, worst = run(cell)
    assert res["correct"], (res["checks"], worst)
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert {"step_s", "setup_s"} <= set(res["metrics"])
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    res, _ = run(cell, control=True)
    limits = {k: v["limit"] for k, v in res["checks"].items()}
    assert any(res["control"][k] > limits[k] for k in limits), res["control"]
    assert res["control_correct"] is False


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_chunk_is_not_correct(cell, kind):
    fault = faults.fault(kind)
    try:
        res, _ = run(cell, faults=[fault])
    finally:
        fault.undo()
    assert not res["correct"], res["checks"]


def test_altered_particle_is_not_correct():
    fault = faults.fault("particle")
    try:
        res, _ = run("vankeken-1024.f32", faults=[fault])
    finally:
        fault.undo()
    assert not res["correct"], res["checks"]
    assert res["checks"]["particle_position_gap"]["value"] > 0.2
