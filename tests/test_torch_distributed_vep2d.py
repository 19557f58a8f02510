"""PyTorch port, the distributed 2D VEP Stokes solve
(``parallel/stokes2d_vep.py``, the flagship under domain decomposition)
against the JAX package's and against the port's serial ``solve_vep``, in
float64 on the CPU: a world of four rank processes over gloo (one for the
file) runs tests/test_distributed_vep2d.py's two-phase Drucker-Prager band
at 16² on 2×2 and 4×1 meshes, two loading steps of 200 fixed iterations
each, its weak inclusion straddling the tiles. Fields within 1e-12 of their
max, equal iterations, ``err`` within rel 1e-6, step by step; plasticity
engages."""

import numpy as np
import pytest
import torch

from dist_parity import assert_matches, jax_sharded
import dist_cases as dc

torch.set_num_threads(1)

CASES = {k: v for k, v in dc.suite_cases("test").items() if v.kind == "vep"}


@pytest.fixture(scope="module")
def running():
    w = dc.world("vep", device="cpu", timeout=300)
    yield w
    w.stop()


@pytest.fixture(scope="module")
def jax_results(running):
    return {k: jax_sharded(c) for k, c in CASES.items()}


@pytest.fixture(scope="module")
def world(running, jax_results):
    return running.result()


@pytest.mark.parametrize("label", sorted(CASES))
def test_sharded_vep_matches_serial(world, label):
    case = CASES[label]
    assert_matches(case, world[label], dc.serial_solve(case, "cpu"), "serial")


@pytest.mark.parametrize("label", sorted(CASES))
def test_sharded_vep_matches_jax(world, jax_results, label):
    case = CASES[label]
    assert_matches(case, world[label], jax_results[label], "jax")


@pytest.mark.parametrize("label", sorted(CASES))
def test_sharded_vep_yields(world, label):
    """The last step has plastic cells, some of them beside a tile edge."""
    case = CASES[label]
    last = dc.steps_of(world[label])[-1]
    assert len(dc.steps_of(world[label])) == case.nt
    lam = dc.unblock(case, "lam", last["lam"])
    assert lam.max() > 0.0
    cuts = [(0, c * case.n // p) for c in range(1, case.mesh[0]) for p in [case.mesh[0]]]
    cuts += [(1, c * case.n // case.mesh[1]) for c in range(1, case.mesh[1])]
    assert any((lam.take(range(c - 1, c + 1), axis=a) > 0).any() for a, c in cuts)
    assert np.isfinite(last["err"])
