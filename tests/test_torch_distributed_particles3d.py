"""PyTorch port, the distributed 3D particle transport
(``parallel/particles3d.py``) against the port's serial ``advect_rk2_3d`` +
``move_particles_3d`` and the JAX package's sharded steps, in float64 on
the CPU: a world of four rank processes over gloo (one for the file) runs
tests/test_distributed_particles3d.py's random velocity field (CFL 0.45) at
8³, four particles per cell, a random phase per slot, three steps, on
(2, 2, 1) and (1, 2, 2) meshes, so that every axis is cut. As JAX's test
asserts: the active (x, y, z, phase) rows sorted equal within 1e-13 and the
per-cell occupancy equal. The (2, 2, 1) case also runs through a staged
mesh (every batch packed as bytes) and gives the same bits."""

import numpy as np
import pytest
import torch

from dist_parity import assert_matches, jax_sharded
import dist_cases as dc

torch.set_num_threads(1)

KIND = "particles3d"
CASES = {k: v for k, v in dc.suite_cases("test").items() if v.kind == KIND}


@pytest.fixture(scope="module")
def running():
    w = dc.world(KIND, device="cpu", timeout=300)
    yield w
    w.stop()


@pytest.fixture(scope="module")
def jax_results(running):
    return {k: jax_sharded(c) for k, c in CASES.items()}


@pytest.fixture(scope="module")
def world(running, jax_results):
    return running.result()


@pytest.mark.parametrize("label", sorted(CASES))
def test_sharded_particles3d_match_serial(world, label):
    case = CASES[label]
    ref = dc.serial_solve(case, "cpu")
    assert_matches(case, world[label], ref, "serial")
    assert len(ref["rows"]) > 0 and ref["count"].sum() == len(ref["rows"])


@pytest.mark.parametrize("label", sorted(CASES))
def test_sharded_particles3d_match_jax(world, jax_results, label):
    assert_matches(CASES[label], world[label], jax_results[label], "jax")


@pytest.mark.parametrize("label", [k for k in dc.STAGED_CASES if k in CASES])
def test_staged_mesh_gives_the_same_bits(world, label):
    a, b = world[label], world[label + "@staged"]
    np.testing.assert_array_equal(a["rows"], b["rows"])
    np.testing.assert_array_equal(a["count"], b["count"])
