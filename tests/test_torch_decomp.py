"""PyTorch port, the domain decomposition (``parallel/decomp.py``, numpy
only) against the JAX package's: ``Decomp2D`` / ``Decomp3D`` and the
blocked-local containers of staggered arrays, block and unblock, 2D and
N-D, for seeded arrays."""

import dataclasses

import numpy as np
import pytest

from justrelax_tpu.parallel import decomp as jdecomp
from justrelax_tpu_torch.parallel import decomp

EXTRAS_2D = [(0, 0), (1, 1), (2, 1), (1, 2), (2, 2)]


@pytest.mark.parametrize("ni,mesh", [((8, 6), (2, 3)), ((12, 4), (4, 1)), ((6, 6), (1, 1))])
def test_decomp2d_matches_jax(ni, mesh):
    d, jd = decomp.Decomp2D.make(ni, mesh), jdecomp.Decomp2D.make(ni, mesh)
    assert dataclasses.asdict(d) == dataclasses.asdict(jd)
    assert (d.ni_global, d.ni_local) == (jd.ni_global, jd.ni_local)
    rng = np.random.default_rng(0)
    for extra in EXTRAS_2D:
        A = rng.standard_normal((ni[0] + extra[0], ni[1] + extra[1]))
        B = decomp.block_staggered(A, d, extra)
        np.testing.assert_array_equal(B, jdecomp.block_staggered(A, jd, extra))
        back = decomp.unblock_staggered(B, d, extra)
        np.testing.assert_array_equal(back, jdecomp.unblock_staggered(B, jd, extra))
        np.testing.assert_array_equal(back, A)


@pytest.mark.parametrize("extra", [(0, 0, 0), (1, 2, 0), (2, 1, 1), (1, 1, 2)])
def test_decomp3d_and_nd_match_jax(extra):
    ni, mesh = (6, 4, 6), (3, 2, 2)
    d, jd = decomp.Decomp3D.make(ni, mesh), jdecomp.Decomp3D.make(ni, mesh)
    assert dataclasses.asdict(d) == dataclasses.asdict(jd)
    assert (d.ni_global, d.ni_local, d.mesh_shape) == (jd.ni_global, jd.ni_local,
                                                       jd.mesh_shape)
    A = np.random.default_rng(1).standard_normal(tuple(n + e for n, e in zip(ni, extra)))
    B = decomp.block_staggered_nd(A, d.ni_local, mesh, extra)
    np.testing.assert_array_equal(B, jdecomp.block_staggered_nd(A, jd.ni_local, mesh, extra))
    back = decomp.unblock_staggered_nd(B, d.ni_local, mesh, extra)
    np.testing.assert_array_equal(back, jdecomp.unblock_staggered_nd(B, jd.ni_local, mesh,
                                                                     extra))
    np.testing.assert_array_equal(back, A)


def test_decomp_refusals():
    """A grid the mesh does not divide raises ValueError, as in the JAX
    package; so does a global array of the wrong shape."""
    with pytest.raises(ValueError, match="not divisible"):
        decomp.Decomp2D.make((7, 6), (2, 3))
    with pytest.raises(ValueError, match="not divisible"):
        decomp.Decomp3D.make((6, 5, 6), (3, 2, 2))
    d = decomp.Decomp2D.make((8, 6), (2, 3))
    with pytest.raises(ValueError, match="expected"):
        decomp.block_staggered(np.zeros((8, 6)), d, (1, 0))
    with pytest.raises(ValueError, match="expected"):
        decomp.block_staggered_nd(np.zeros((6, 6)), (3, 2), (2, 3), (0, 1))
