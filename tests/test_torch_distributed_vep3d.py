"""PyTorch port, the distributed 3D VEP Stokes solve
(``parallel/stokes3d_vep.py``) against the port's serial ``solve_vep_3d``
and the JAX package's sharded solve, in float64 on the CPU: a world of four
rank processes over gloo (one for the file) runs
tests/test_distributed_vep3d.py's two-phase Drucker-Prager pure shear at 8³
on (2, 2, 1) and (1, 2, 2) meshes, three loading steps of 200 fixed
iterations (JAX's test runs 300), its weak sphere straddling the tiles;
plasticity engages in the third step beside the tile edges. Fields within
1e-12 of their max, equal iterations, ``err`` within rel 1e-6, step by step
(every case comes out bit-equal to the serial solve). The JAX package's
sharded solve compiles for ~20 s per mesh on one thread: the (2, 2, 1) case
is held against it here, the (1, 2, 2) one under ``-m slow``.

The halo-aware moves on blocked tiles equal the serial moves on the global
arrays bit for bit (tests/test_distributed_vep3d.py's moves check), one at
a time and prefetched in two batches; what the sharded solve does not
thread raises ``NotImplementedError``."""

import numpy as np
import pytest
import torch

from dist_parity import assert_matches, jax_sharded
from justrelax_tpu_torch.ops.stokes3d_vep import serial_moves
from justrelax_tpu_torch.parallel.decomp import Decomp3D, unblock_staggered_nd
from justrelax_tpu_torch.parallel.mesh import make_grid_mesh
from justrelax_tpu_torch.parallel.stokes3d_vep import solve_vep_sharded_3d
import dist_cases as dc

torch.set_num_threads(1)

CASES = {k: v for k, v in dc.suite_cases("test").items() if v.kind == "vep3d"}
JAX_TIER1 = ("vep3d_xy",)


@pytest.fixture(scope="module")
def running():
    w = dc.world("vep3d", device="cpu", timeout=300)
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
    return dc.serial_solve(CASES["vep3d_xy"], "cpu")


@pytest.mark.parametrize("label", sorted(CASES))
def test_sharded_vep3d_matches_serial(world, serial, label):
    case = CASES[label]
    assert_matches(case, world[label], serial, "serial")
    for a, b in zip(dc.steps_of(world[label]), dc.steps_of(serial)):
        for k in dc.VEP3D_FIELDS:
            np.testing.assert_array_equal(dc.unblock(case, k, a[k]), b[k])


@pytest.mark.parametrize("label", JAX_TIER1)
def test_sharded_vep3d_matches_jax(world, jax_results, label):
    assert_matches(CASES[label], world[label], jax_results[label], "jax")


@pytest.mark.slow
@pytest.mark.parametrize("label", sorted(set(CASES) - set(JAX_TIER1)))
def test_sharded_vep3d_matches_jax_slow(world, label):
    assert_matches(CASES[label], world[label], jax_sharded(CASES[label]), "jax")


@pytest.mark.parametrize("label", sorted(CASES))
def test_sharded_vep3d_yields_beside_a_tile_edge(world, label):
    case = CASES[label]
    steps = dc.steps_of(world[label])
    assert len(steps) == case.nt
    lam = dc.unblock(case, "lam", steps[-1]["lam"])
    assert lam.max() > 0.0
    cuts = [(a, c * case.n // p) for a, p in enumerate(case.mesh) for c in range(1, p)]
    assert cuts and all((lam.take(range(c - 1, c + 1), axis=a) > 0).any() for a, c in cuts)


MOVES = [(shape, route, kind) for shape in dc.MOVES_MESHES for route in ("one", "prefetched")
         for kind in ("center", "harm", "other")]


@pytest.mark.parametrize("shape,route,kind", MOVES)
def test_distributed_moves_match_serial_moves(world, shape, route, kind):
    """Each halo-aware move on the blocked tiles equals its serial twin on
    the global arrays bit for bit."""
    d = dc.moves_inputs()
    n = d["n"]
    nl = tuple(n // p for p in shape)
    sm = serial_moves((n, n, n))
    C = torch.as_tensor(d["C"])
    got = world["moves"]
    checked = 0
    for name, (a, b) in dc.MOVE_FAMILIES.items():
        if kind == "center":
            pairs = [(got[(shape, route, "center", name)], sm.center_to_edge(C, a, b), name)]
        elif kind == "harm":
            pairs = [(got[(shape, route, "harm", name)], sm.harm_center_to_edge(C, a, b), name)]
        else:
            pairs = [(got[(shape, route, src, name)],
                      sm.other_to_edge(src, name, torch.as_tensor(d["E"][src])), name)
                     for src in dc.MOVE_FAMILIES if src != name]
        for blocked, want, dst in pairs:
            out = unblock_staggered_nd(blocked, nl, shape, dc.MOVE_EXTRAS[dst])
            np.testing.assert_array_equal(out, want.numpy())
            checked += 1
    assert checked == (6 if kind == "other" else 3)


def test_not_threaded_raises():
    """The φ-masked variant's blocks and per-node spacings are refused, as
    the JAX package threads neither."""
    mesh = make_grid_mesh((1, 1, 1), device="cpu")
    dec = Decomp3D.make((4, 4, 4), (1, 1, 1))
    with pytest.raises(NotImplementedError, match="φ-masked"):
        solve_vep_sharded_3d(mesh, dec, dict(phi_c=np.ones((4, 4, 4)), inv_dx=1.0, inv_dy=1.0,
                                             inv_dz=1.0), None, None, None, 0.1)
    with pytest.raises(NotImplementedError, match="uniform"):
        solve_vep_sharded_3d(mesh, dec, dict(inv_dx=np.ones(4), inv_dy=1.0, inv_dz=1.0), None,
                             None, None, 0.1)
