"""PyTorch port, the distributed 3D VE Stokes solve (``parallel/stokes3d.py``)
against the port's serial ``solve_ve_3d`` and the JAX package's sharded
solve, in float64 on the CPU: a world of four rank processes over gloo (one
for the file) runs tests/test_distributed3d.py's buoyancy problem (random η
and ρ, G = 1, K = dt = ∞) at 8³, free slip and no slip on all six faces, on
(2, 2, 1) and (1, 2, 2) meshes, so that every axis is cut, for 200 fixed
iterations. Fields within 1e-12 of their max, equal iterations, ``err``
within rel 1e-6 (every case comes out bit-equal to the serial solve). The
JAX package's sharded solve compiles for ~27 s per case on one thread: one
case is held against it here, the other three under ``-m slow``. Also the
halo's axis passes and its byte staging."""

import dataclasses

import numpy as np
import pytest
import torch

from dist_parity import assert_matches, jax_sharded
from justrelax_tpu_torch.parallel import halo
from justrelax_tpu_torch.parallel.mesh import make_grid_mesh
import dist_cases as dc

torch.set_num_threads(1)

CASES = {k: v for k, v in dc.suite_cases("test").items() if v.kind == "ve3d"}
JAX_TIER1 = ("ve3d_free_slip_xy",)


@pytest.fixture(scope="module")
def running():
    w = dc.world("ve3d", device="cpu", timeout=300)
    yield w
    w.stop()


@pytest.fixture(scope="module")
def jax_results(running):
    return {k: jax_sharded(CASES[k]) for k in JAX_TIER1}


@pytest.fixture(scope="module")
def world(running, jax_results):
    return running.result()


@pytest.fixture(scope="module")
def serial():
    return {dc.setup_key(c): dc.serial_solve(c, "cpu") for c in dc.setups(CASES).values()}


@pytest.mark.parametrize("label", sorted(CASES))
def test_sharded_ve3d_matches_serial(world, serial, label):
    case = CASES[label]
    ref = serial[dc.setup_key(case)]
    assert_matches(case, world[label], ref, "serial")
    assert world[label]["iters"] == case.iters
    for k in dc.VE3D_FIELDS:  # bit-equal: the same operations on the same inputs
        np.testing.assert_array_equal(dc.unblock(case, k, world[label][k]), ref[k])


@pytest.mark.parametrize("label", JAX_TIER1)
def test_sharded_ve3d_matches_jax(world, jax_results, label):
    assert_matches(CASES[label], world[label], jax_results[label], "jax")


@pytest.mark.slow
@pytest.mark.parametrize("label", sorted(set(CASES) - set(JAX_TIER1)))
def test_sharded_ve3d_matches_jax_slow(world, label):
    assert_matches(CASES[label], world[label], jax_sharded(CASES[label]), "jax")


def test_free_slip_and_no_slip_differ(world):
    """The two set-ups are different problems (the BCs reach the fields)."""
    a, b = world["ve3d_free_slip_xy"], world["ve3d_no_slip_xy"]
    assert not np.array_equal(a["Vx"], b["Vx"])


def test_world_of_one_3d_without_a_group():
    """No process group: a (1, 1, 1) mesh runs the serial solve bit for
    bit."""
    case = dataclasses.replace(CASES["ve3d_no_slip_yz"], mesh=(1, 1, 1), iters=40, nout=20)
    got = dc.sharded_solve(case, make_grid_mesh((1, 1, 1), device="cpu"))
    ref = dc.serial_solve(case, "cpu")
    assert got["iters"] == ref["iters"] == 40 and got["err"] == ref["err"]
    for k in dc.VE3D_FIELDS:
        np.testing.assert_array_equal(dc.unblock(case, k, got[k]), ref[k])


def test_extend_axes_many_world_of_one():
    """On a world of one every axis pass replicates the edge: three passes
    of halo 2 equal the edge-padded block, and a (y, z) pair of passes
    (JAX's ``_ext2(A, 1, 2)``) pads exactly its two axes."""
    mesh = make_grid_mesh((1, 1, 1), device="cpu")
    A = torch.as_tensor(np.random.default_rng(0).normal(size=(3, 4, 5)))
    want = torch.as_tensor(np.pad(A.numpy(), 2, mode="edge"))
    with mesh:
        got, yz = halo.extend_axes_many([(A, (0, 1, 2), 2), (A, (1, 2), 1)])
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(yz.numpy(), np.pad(A.numpy(), ((0, 0), (1, 1), (1, 1)),
                                                     mode="edge"))


def test_staged_bytes_round_trip():
    """A staged batch packs slabs of mixed dtypes as bytes, each at a
    16-byte boundary, and views them back unchanged."""
    slabs = [torch.arange(5, dtype=torch.float64), torch.tensor([1, 0, 1], dtype=torch.uint8),
             torch.arange(6, dtype=torch.float32).reshape(2, 3)]
    offsets, n = halo._staged_layout(slabs)
    assert offsets == [0, 48, 64] and n == 96
    buf = torch.zeros(n, dtype=torch.uint8)
    for t, o in zip(slabs, offsets):
        b = halo._as_bytes(t)
        buf[o:o + b.numel()] = b
    for t, o in zip(slabs, offsets):
        back = halo._from_bytes(buf, o, t.shape, t.dtype)
        assert back.dtype == t.dtype and torch.equal(back, t)
