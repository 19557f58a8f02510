"""PyTorch port, the distributed 2D particle transport
(``parallel/particles.py``: RK2 advection on face-extended local velocities,
migration by one ring of the neighbours' slots and the serial re-slotting)
against the port's serial ``advect_rk2`` + ``move_particles`` and the JAX
package's sharded steps, in float64 on the CPU: a world of four rank
processes over gloo (one for the file) runs
tests/test_distributed_particles.py's random velocity field (CFL 0.45) at
16², four particles per cell, a random phase per slot, three steps, on
(2, 2) and (1, 4) meshes. As JAX's test asserts: the active (x, y, phase)
rows sorted equal within 1e-13 and the per-cell occupancy equal. The
(2, 2) case also runs through a staged mesh (every batch packed as bytes,
float64 slabs beside the uint8 ``active``) and gives the same bits."""

import numpy as np
import pytest
import torch

from dist_parity import assert_matches, jax_sharded
import dist_cases as dc

torch.set_num_threads(1)

KIND = "particles"
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
def test_sharded_particles_match_serial(world, label):
    case = CASES[label]
    ref = dc.serial_solve(case, "cpu")
    assert_matches(case, world[label], ref, "serial")
    assert len(ref["rows"]) > 0 and ref["count"].sum() == len(ref["rows"])


@pytest.mark.parametrize("label", sorted(CASES))
def test_sharded_particles_match_jax(world, jax_results, label):
    assert_matches(CASES[label], world[label], jax_results[label], "jax")


@pytest.mark.parametrize("label", [k for k in dc.STAGED_CASES if k in CASES])
def test_staged_mesh_gives_the_same_bits(world, label):
    a, b = world[label], world[label + "@staged"]
    np.testing.assert_array_equal(a["rows"], b["rows"])
    np.testing.assert_array_equal(a["count"], b["count"])


def test_float32_particles_kept_at_the_physical_boundary():
    """In float32 the serial clamp's ``extent − 1e-12`` rounds to the extent;
    the extended block would file such a particle in its ring and drop it.
    The bounds move inward by ulps instead: a step that pushes particles
    against the upper boundaries keeps every one, in the cells the serial
    step files them in (a world of one, whose block edges are all
    physical)."""
    from justrelax_tpu_torch.core.grid import Geometry
    from justrelax_tpu_torch.parallel.decomp import Decomp2D
    from justrelax_tpu_torch.parallel.mesh import make_grid_mesh
    from justrelax_tpu_torch.parallel.particles import (
        advect_move_local,
        inside_bounds,
        local_particle_geometry,
    )
    from justrelax_tpu_torch.particles.particles import (
        advect_rk2,
        init_particles,
        move_particles,
    )

    n = 16
    g = Geometry((n, n), (1.0, 1.0))
    dec = Decomp2D.make((n, n), (1, 1))
    p = init_particles(g, nxcell=4, max_xcell=24, min_xcell=2, seed=1, dtype=torch.float32,
                       device="cpu")
    V = (torch.full((n + 1, n + 2), 3.0), torch.full((n + 2, n + 1), 3.0))
    dt = 0.9 / n / 3.0
    ph = torch.zeros_like(p.px)
    with make_grid_mesh((1, 1), device="cpu"):
        q, _ = advect_move_local(p, {"phase": ph}, *V, dec, g.di, dt)
    s, _ = move_particles(advect_rk2(p, V, g, dt), g, {"phase": ph})
    assert int(q.count().sum()) == int(p.count().sum()) == int(s.count().sum())
    np.testing.assert_array_equal(q.count().numpy(), s.count().numpy())
    assert int(s.count()[-1, -1]) > 8  # the corner cell is where they pile up
    g_loc, g_ext = local_particle_geometry(dec, g.di)
    lo64, hi64 = inside_bounds(1e-12, 1.0 - 1e-12, g_ext, 0, torch.float64)
    assert (lo64, hi64) == (1e-12, 1.0 - 1e-12)  # float64: the serial clamp
    lo32, hi32 = inside_bounds(1e-12, 1.0 - 1e-12, g_ext, 0, torch.float32)
    assert hi32 < 1.0 and lo32 == float(torch.tensor(1e-12, dtype=torch.float32))


def test_float32_particles_at_tile_faces_kept_once(world):
    """Float32 particles within a few ulps of the faces between the tiles
    (and of the domain's upper faces), at rest: the blocks' frames round
    apart there, yet every particle is kept by exactly one rank, in its
    cell or the next one of the serial step's."""
    from justrelax_tpu_torch.core.grid import Geometry
    from justrelax_tpu_torch.particles.particles import move_particles

    got = world["faces"]
    parts, V, dt = dc.face_particles()
    n = parts.px.shape[0]
    s, _ = move_particles(parts, Geometry((n, n), (1.0, 1.0)),
                          {"phase": torch.zeros_like(parts.px)})
    assert got["placed"] == int(got["count"].sum()) == int(s.count().sum()) > 0
    # where the occupancy differs from the serial step's, a particle was
    # filed on the other side of a face: only cells beside a face differ
    c, r = got["count"], s.count().numpy()
    beside = {n // 2 - 1, n // 2, n - 1}
    for i, j in np.argwhere(c != r):
        assert i in beside or j in beside, (i, j)
