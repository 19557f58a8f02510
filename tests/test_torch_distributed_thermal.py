"""PyTorch port, the distributed PT thermal diffusion
(``parallel/thermal.py``: ``heatdiffusion_PT_sharded`` and
``heatdiffusion_PT_sharded_3d``) against the JAX package's and against the
port's serial ``heatdiffusion_PT``, in float64 on the CPU: a world of four
rank processes over gloo (one for the file) runs the 2D solve of
tests/test_distributed_thermal.py at 16² on a 2×2 mesh, and the 3D solve of
tests/test_distributed_thermal3d.py at 8³ on (2, 2, 1) and (1, 2, 2) meshes,
so that each of the three axes is split, at fixed iterations (ϵ = 1e-30).
T within 1e-12 of its max, equal iterations, ``err`` within rel 1e-6."""

import dataclasses

import numpy as np
import pytest
import torch

from dist_parity import assert_matches, jax_sharded
from justrelax_tpu_torch.parallel import multihost
from justrelax_tpu_torch.parallel.decomp import Decomp2D, block_staggered
from justrelax_tpu_torch.parallel.mesh import make_grid_mesh
from justrelax_tpu_torch.parallel.thermal import heatdiffusion_PT_sharded
import dist_cases as dc

torch.set_num_threads(1)

CASES = {k: v for k, v in dc.suite_cases("test").items() if v.kind.startswith("thermal")}


@pytest.fixture(scope="module")
def running():
    w = dc.world("thermal", device="cpu", timeout=300)
    yield w
    w.stop()


@pytest.fixture(scope="module")
def jax_results(running):
    return {k: jax_sharded(c) for k, c in CASES.items()}


@pytest.fixture(scope="module")
def world(running, jax_results):
    return running.result()


@pytest.mark.parametrize("label", sorted(CASES))
def test_sharded_thermal_matches_serial(world, label):
    case = CASES[label]
    assert_matches(case, world[label], dc.serial_solve(case, "cpu"), "serial")


@pytest.mark.parametrize("label", sorted(CASES))
def test_sharded_thermal_matches_jax(world, jax_results, label):
    case = CASES[label]
    assert_matches(case, world[label], jax_results[label], "jax")
    assert world[label]["iters"] == case.iters


def test_sharded_thermal_stops_on_eps():
    """With a finite ϵ the loop stops at the first chunk whose err is below
    it, as the serial solver does (a world of one, no process group)."""
    case = CASES["thermal2d"]
    d = dc.inputs(case)
    g, bc, T, K, rc, H, pt = dc.thermal_objects(d, 2, "cpu", torch.float64)
    pt = dataclasses.replace(pt, eps=1e-10)
    mesh = make_grid_mesh((1, 1), device="cpu")
    dec = Decomp2D.make(g.ni, (1, 1))
    Tb = multihost.blocks_from_global(mesh, block_staggered(T.numpy(), dec, (2, 2)))
    Tl, err, iters = heatdiffusion_PT_sharded(mesh, dec, Tb, K, rc, H, pt, bc, d["dt"], g.di,
                                              iter_max=20_000, nout=100)
    from justrelax_tpu_torch.core.state import ThermalState
    from justrelax_tpu_torch.solvers.thermal import heatdiffusion_PT

    th = ThermalState.make(g.ni, device="cpu").replace(T=T, Told=T, H=H)
    ref, info = heatdiffusion_PT(th, pt, bc, d["dt"], g, K=K, rho_Cp=rc, iter_max=20_000,
                                 nout=100, use_kernel=False)
    assert iters == int(info.iters) < 20_000 and float(err) <= 1e-10
    np.testing.assert_array_equal(Tl.numpy(), ref.T.numpy())
