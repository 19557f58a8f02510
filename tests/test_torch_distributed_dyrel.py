"""PyTorch port, the distributed DYREL solve (``parallel/dyrel.py``: the
serial ``solve_dyrel`` on each rank's overlapping window through its halo
hook) against the port's serial ``solve_dyrel`` and the JAX package's
GSPMD-sharded solve, in float64 on the CPU: a world of four rank processes
over gloo (one for the file) runs tests/test_distributed_dyrel.py's
``_setup(n=32)`` (a weak circle in a Drucker-Prager band under pure shear,
``eps = 1e-6``, ``nout = 50``, ``rel_drop = 0.5``; it converges in 2 150 DR
iterations) on (2, 2) and (4, 1) meshes, returning the gathered global
state on every rank; and the band with dislocation creep (n = 3) at 16²,
whose η the DR loop refreshes (tests/test_dyrel_nonlinear.py's set-up,
held against the serial solve only). JAX's own gate: fields within 1e-12
absolute, equal iterations, ``err`` within rel 1e-10 (the sums of the
norms and of the Rayleigh quotient reorder, so the cases need not be
bit-equal).

The hook leaves the serial solve as it was: with no hook its CPU result is
bit for bit the one the solver gave before the hook existed (frozen
digests), and the chunk of a hooked solve refuses a CUDA graph capture."""

import dataclasses
import hashlib
import math

import numpy as np
import pytest
import torch

from dist_parity import assert_matches, jax_sharded
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.ops.bc import VelocityBoundaryConditions
from justrelax_tpu_torch.parallel.dyrel import DyrelWindow
from justrelax_tpu_torch.parallel.mesh import make_grid_mesh
from justrelax_tpu_torch.solvers import dyrel
import dist_cases as dc

torch.set_num_threads(1)

CASES = {k: v for k, v in dc.suite_cases("test").items() if v.kind == "dyrel"}
JAX_CASES = {k: v for k, v in CASES.items() if v.setup == ""}


@pytest.fixture(scope="module")
def running():
    w = dc.world("dyrel", device="cpu", timeout=300)
    yield w
    w.stop()


@pytest.fixture(scope="module")
def jax_results(running):
    return {k: jax_sharded(c) for k, c in JAX_CASES.items()}


@pytest.fixture(scope="module")
def world(running, jax_results):
    return running.result()


@pytest.fixture(scope="module")
def serials():
    return {dc.setup_key(c): dc.serial_solve(c, "cpu") for c in dc.setups(CASES).values()}


@pytest.fixture(scope="module")
def serial(serials):
    return serials[dc.setup_key(CASES["dyrel_2x2"])]


ITERS = {"": 2150, "nonlinear": 1300}  # to convergence (eps = 1e-6)


@pytest.mark.parametrize("label", sorted(CASES))
def test_sharded_dyrel_matches_serial(world, serials, label):
    case = CASES[label]
    ref = serials[dc.setup_key(case)]
    assert_matches(case, world[label], ref, "serial")
    assert world[label]["iters"] == ref["iters"] == ITERS[case.setup]


@pytest.mark.parametrize("label", sorted(JAX_CASES))
def test_sharded_dyrel_matches_jax(world, jax_results, label):
    assert_matches(CASES[label], world[label], jax_results[label], "jax")


def _serial_setup(n=16):
    d = dc.dyrel_inputs(n)
    return (dc.dyrel_state(d, "cpu", torch.float64), Geometry((n, n), (1.0, 1.0)),
            VelocityBoundaryConditions(**dc.FREE_SLIP), dc.dyrel_material("cpu", torch.float64),
            torch.as_tensor(d["pr_c"]), torch.as_tensor(d["pr_v"]), d["dt"])


# the serial solve's result at 16² before the halo hook existed (the parent
# commit's solvers/dyrel.py): DR iterations, err in hex, and a digest of the
# bytes of P, Vx, Vy, τxx, τxy, τII, η_vep, η and Rx
FROZEN = (1300, "0x1.68f7fb80670d8p-21", "cb016cca8db7f332067c3b18d963b34c")


@pytest.mark.parametrize("linear", [True, False])
def test_no_hook_is_the_serial_solve(linear):
    s, info = dyrel.solve_dyrel(*_serial_setup(), eps=1e-6, nout=50, rel_drop=0.5,
                                linear_viscosity=linear)
    h = hashlib.sha256()
    for a in (s.P, s.V.Vx, s.V.Vy, s.tau.xx, s.tau.xy, s.tau.II, s.viscosity.eta_vep,
              s.viscosity.eta, s.R.Rx):
        h.update(np.ascontiguousarray(a.numpy()).tobytes())
    assert (int(info.iters), float(info.err).hex(), h.hexdigest()[:32]) == FROZEN


def test_hooked_world_of_one_is_the_serial_solve(serial):
    """A (1, 1) mesh without a process group: the window is the whole grid,
    every exchange is empty and the sums are the serial ones; the solve
    gives the serial bits."""
    one = dataclasses.replace(CASES["dyrel_2x2"], mesh=(1, 1))
    got = dc.sharded_solve(one, make_grid_mesh((1, 1), device="cpu"))
    assert got["iters"] == serial["iters"] and got["err"] == serial["err"]
    for k, v in serial.items():
        if k not in ("err", "iters"):
            np.testing.assert_array_equal(got[k], v)


def test_hooked_chunk_refuses_capture():
    """The sharded route runs eagerly: capturing its chunk raises, and
    ``run_chunk`` runs the eager chunk."""
    st, g, bc, mat, pr_c, pr_v, dt = _serial_setup(8)
    win = DyrelWindow(make_grid_mesh((1, 1), device="cpu"), (8, 8))
    s = dyrel._DyrelSolve(st, g, bc, mat, pr_c, pr_v, dt, None, 20.0, 1.0, True, 1e-2,
                          (-math.inf, math.inf), None, None, halo=win)
    with pytest.raises(RuntimeError, match="eagerly"):
        s.capture(10)
    s.set_P(st.P)
    s.set_tuning(torch.tensor(0.0, dtype=torch.float64), 0.99)
    s.run_chunk(2)
    assert s.graphs is None and bool(torch.isfinite(s.Vx).all())


def test_window_owns_every_node_once():
    """Over a (3, 2) mesh the windows' owned ranges tile every staggered
    array of a 12×8 grid exactly once, and each window is the global
    array's slice."""
    from justrelax_tpu_torch.parallel.mesh import GridMesh

    ni = (12, 8)
    counts = {e: np.zeros((ni[0] + e[0], ni[1] + e[1]), dtype=int)
              for e in [(a, b) for a in (-1, 0, 1, 2) for b in (-1, 0, 1, 2)]}
    ranks = np.arange(6).reshape(3, 2)
    for r in range(6):
        coords = tuple(int(c) for c in np.argwhere(ranks == r)[0])
        mesh = GridMesh(ranks=ranks, axis_names=("x", "y"), rank=r, coords=coords,
                        device=torch.device("cpu"))
        win = DyrelWindow(mesh, ni)
        for e, c in counts.items():
            G = torch.arange(c.size, dtype=torch.float64).reshape(c.shape)
            L = win.cut(G)
            assert L.shape == tuple(n + x for n, x in zip(win.n_loc, e))
            (a0, a1), (b0, b1) = win._owned(L, 0), win._owned(L, 1)
            for v in L[a0:a1, b0:b1].reshape(-1).tolist():
                c.reshape(-1)[int(v)] += 1
    for e, c in counts.items():
        assert (c == 1).all(), e
