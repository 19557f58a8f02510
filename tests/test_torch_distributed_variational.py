"""PyTorch port, the distributed 2D variational (sticky-air) Stokes solve
(``parallel/stokes2d_variational.py``) against the JAX package's and
against the port's serial ``solve_variational``, in float64 on the CPU: a
world of four rank processes over gloo runs
tests/test_distributed_variational.py's dense blob under an air layer at
16² on a 2×2 mesh, 200 fixed iterations, its RockRatio masks computed from
the global ϕ and blocked. Fields within 1e-12 of their max, equal
iterations, ``err`` within rel 1e-6."""

import numpy as np
import pytest
import torch

from dist_parity import assert_matches, jax_sharded
import dist_cases as dc

torch.set_num_threads(1)

CASE = dc.suite_cases("test")["variational"]


@pytest.fixture(scope="module")
def running():
    w = dc.world("variational", device="cpu", timeout=300)
    yield w
    w.stop()


@pytest.fixture(scope="module")
def jax_result(running):
    return jax_sharded(CASE)


@pytest.fixture(scope="module")
def world(running, jax_result):
    return running.result()


def test_sharded_variational_matches_serial(world):
    assert_matches(CASE, world["variational"], dc.serial_solve(CASE, "cpu"), "serial")


def test_sharded_variational_matches_jax(world, jax_result):
    assert_matches(CASE, world["variational"], jax_result, "jax")


@pytest.mark.parametrize("field", ["Vx", "Vy", "P"])
def test_sharded_variational_masks(world, field):
    """The air is still and pressure-free where the masks say so: the
    invalid faces and cells hold 0 in the gathered fields."""
    d = dc.inputs(CASE)
    got = dc.unblock(CASE, field, world["variational"][field])
    mask = {"Vx": d["vm_vx"], "Vy": d["vm_vy"], "P": d["vm_c"]}[field]
    inner = got[:, 1:-1] if field == "Vx" else got[1:-1, :] if field == "Vy" else got
    assert not mask.all() and np.all(inner[~mask] == 0.0)
    assert np.abs(inner[mask]).max() > 0.0
