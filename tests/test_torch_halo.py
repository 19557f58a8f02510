"""PyTorch port, the halo exchange (``parallel/halo.py``) and the mesh
(``parallel/mesh.py``) against the JAX package's, on gloo over CPU tiles:
a world of four rank processes (one for the file) runs every case on the
meshes (2, 2), (4, 1) and (1, 3), the last over a group of ranks 0–2.

- ``factor_devices`` equal to JAX's for n ≤ 16 and one to three axes;
- ``exchange_ghosts`` (extra 1–3, both axes) and ``extend`` (halo 1–2, both
  axes) bit-equal to JAX's halo under ``shard_map`` and to the oracles of
  tests/test_halo_unit.py;
- the cyclic ``from_prev``/``from_next`` bit-equal to JAX's;
- a block without ghost layers refused;
- the byte counter: each rank sends one slab to each neighbour;
- the ranks laid out in row-major order."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from dist_parity import jax_mesh
from justrelax_tpu.parallel import halo as jhalo
from justrelax_tpu.parallel import mesh as jmesh
from justrelax_tpu_torch.parallel import mesh as pmesh
import dist_cases as dc
from test_halo_unit import _exchange_oracle

torch.set_num_threads(1)

MESHES = dc.HALO_MESHES
EXCHANGE = [(m, e, a) for m in MESHES for e in (1, 2, 3) for a in (0, 1)]
EXTEND = [(m, h, a) for m in MESHES for h in (1, 2) for a in (0, 1)]
SHIFT = [(name, m, ax) for name in ("from_prev", "from_next") for m in MESHES
         for ax in ("x", "y")]


@pytest.fixture(scope="module")
def world():
    return dc.world("halo", device="cpu", timeout=300).result()


def _jax(fn, B, shape):
    f = shard_map(fn, mesh=jax_mesh(shape), in_specs=P("x", "y"), out_specs=P("x", "y"))
    return np.asarray(jax.jit(f)(jnp.asarray(B)))


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_factor_devices_matches_jax(ndim):
    for n in range(1, 17):
        assert pmesh.factor_devices(n, ndim) == jmesh.factor_devices(n, ndim)


@pytest.mark.parametrize("shape,extra,axis", EXCHANGE)
def test_exchange_ghosts_matches_jax(world, shape, extra, axis):
    B, n_owned = dc.halo_inputs(*shape, extra, axis)
    got = world[("exchange", shape, extra, axis)]
    want = _jax(lambda A: jhalo.exchange_ghosts(A, axis, n_owned), B, shape)
    np.testing.assert_array_equal(got, want)
    # the rule-based oracle over each line of tiles along the axis
    px, py = shape
    sx, sy = (n_owned + extra, 4) if axis == 0 else (5, n_owned + extra)
    p, other = (px, py) if axis == 0 else (py, px)

    def tile(C, r, q):
        rx, ry = (r, q) if axis == 0 else (q, r)
        t = C[rx * sx:(rx + 1) * sx, ry * sy:(ry + 1) * sy]
        return t if axis == 0 else t.T

    for q in range(other):
        want_line = _exchange_oracle([tile(B, r, q) for r in range(p)], n_owned, extra)
        for r in range(p):
            np.testing.assert_array_equal(tile(got, r, q), want_line[r])


@pytest.mark.parametrize("shape,extra,axis", EXCHANGE)
def test_exchange_ghosts_bytes(world, shape, extra, axis):
    """One slab of ``tile width × 8`` bytes to each neighbour along the axis,
    in one batch; a rank with no neighbour posts none."""
    counts = world[("bytes", shape, extra, axis)]
    p = shape[axis]
    width = 4 if axis == 0 else 5  # halo_inputs' tile across the axis
    for pos in np.ndindex(*shape):
        nb = (pos[axis] > 0) + (pos[axis] < p - 1)
        sent, batches = counts[pos]
        assert sent == nb * width * 8
        assert batches == (1 if nb else 0)


@pytest.mark.parametrize("shape,h,axis", EXTEND)
def test_extend_matches_jax(world, shape, h, axis):
    B = dc.extend_inputs(*shape)
    got = world[("extend", shape, h, axis)]
    np.testing.assert_array_equal(got, _jax(lambda A: jhalo.extend(A, axis, h), B, shape))
    # the clamped-global oracle of tests/test_halo_unit.py
    nxl, nyl = 4, 6
    G = np.asarray(dc.unblock_staggered(B, dc.Decomp2D(*shape, nxl, nyl), (0, 0)))
    Gp = np.pad(G, [(h, h) if a == axis else (0, 0) for a in (0, 1)], mode="edge")
    sx, sy = nxl + (2 * h if axis == 0 else 0), nyl + (2 * h if axis == 1 else 0)
    for rx, ry in np.ndindex(*shape):
        np.testing.assert_array_equal(got[rx * sx:(rx + 1) * sx, ry * sy:(ry + 1) * sy],
                                      Gp[rx * nxl:rx * nxl + sx, ry * nyl:ry * nyl + sy])


@pytest.mark.parametrize("name,shape,mesh_axis", SHIFT)
def test_cyclic_shift_matches_jax(world, name, shape, mesh_axis):
    B = dc.extend_inputs(*shape)
    axis = "xy".index(mesh_axis)
    fn = getattr(jhalo, name)
    want = _jax(lambda A: fn(lax_slice(A, axis), mesh_axis), B, shape)
    np.testing.assert_array_equal(world[(name, shape, mesh_axis)], want)


def lax_slice(A, axis):
    return jax.lax.slice_in_dim(A, 0, 1, axis=axis)


@pytest.mark.parametrize("shape", MESHES)
def test_no_overlap_refused(world, shape):
    assert "no ghost layers" in world[("refusal", shape)]


@pytest.mark.parametrize("shape", MESHES)
def test_ranks_row_major(world, shape):
    np.testing.assert_array_equal(world[("coords", shape)],
                                  np.arange(math.prod(shape), dtype=float).reshape(shape))
