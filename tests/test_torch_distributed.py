"""PyTorch port, the distributed VE Stokes solve (``parallel/stokes2d.py``)
against the JAX package's and against the port's serial ``solve_ve``, in
float64 on the CPU: a world of four rank processes over gloo (one world for
the file, started by a module fixture) runs SolCx on a 2×2 mesh and the
solve with every term (finite G and K, a source Q, old stresses, gravity
along both axes) on a 4×1 mesh, at 16² and 300 fixed iterations, each with
``overlap`` on and off. Fields within 1e-12 of their max, equal iterations,
``err`` within rel 1e-6; ``overlap=True`` bit-equal to ``overlap=False``.
Also: a world of one without a process group, and no ``jax`` import under
``justrelax_tpu_torch/parallel/``."""

import pathlib
import re

import numpy as np
import pytest
import torch

from dist_parity import assert_matches, jax_sharded
from justrelax_tpu_torch.parallel.mesh import make_grid_mesh
import dist_cases as dc

torch.set_num_threads(1)

CASES = {k: v for k, v in dc.suite_cases("test").items() if v.kind == "ve"}
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def running():
    w = dc.world("ve", device="cpu", timeout=300)
    yield w
    w.stop()


@pytest.fixture(scope="module")
def jax_results(running):
    """JAX's sharded solves (``overlap=True``; JAX holds both forms
    bit-identical), computed while the ranks run."""
    return {k: jax_sharded(CASES[k]) for k in ("ve_solcx", "ve_full_terms")}


@pytest.fixture(scope="module")
def world(running, jax_results):
    return running.result()


@pytest.mark.parametrize("label", sorted(CASES))
def test_sharded_ve_matches_serial(world, label):
    case = CASES[label]
    assert_matches(case, world[label], dc.serial_solve(case, "cpu"), "serial")


@pytest.mark.parametrize("label", sorted(CASES))
def test_sharded_ve_matches_jax(world, jax_results, label):
    case = CASES[label]
    assert_matches(case, world[label], jax_results[label.replace("_no_overlap", "")], "jax")


@pytest.mark.parametrize("setup", ["ve_solcx", "ve_full_terms"])
def test_overlap_bit_equal(world, setup):
    a, b = world[setup], world[setup + "_no_overlap"]
    assert a["iters"] == b["iters"] and a["err"] == b["err"]
    for k in dc.VE_FIELDS:
        np.testing.assert_array_equal(a[k], b[k])


def test_world_of_one_without_a_group():
    """No process group: the mesh is a world of one, every exchange is
    local and the solve is the serial one bit for bit."""
    case = dc.Case("one", "ve", 8, (1, 1), 100, 50, "full_terms")
    mesh = make_grid_mesh((1, 1), device="cpu")
    assert (mesh.shape, mesh.coords, mesh.rank, mesh.distributed) == ((1, 1), (0, 0), 0, False)
    got = dc.sharded_solve(case, mesh)
    ref = dc.serial_solve(case, "cpu")
    assert got["iters"] == ref["iters"] == 100
    for k in dc.VE_FIELDS:
        np.testing.assert_array_equal(dc.unblock(case, k, got[k]), ref[k])


def test_parallel_imports_no_jax():
    """The port's distributed layer imports neither jax nor the JAX
    package."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|justrelax_tpu)\b(?!_torch)", re.M)
    files = sorted((ROOT / "justrelax_tpu_torch" / "parallel").glob("*.py"))
    files.append(ROOT / "dist_cases.py")
    assert len(files) >= 9
    for f in files:
        assert not pat.search(f.read_text()), f
