"""PyTorch port, ``ops/interpolation.py`` against the JAX package on the same
numpy inputs, in float64: the eight staggered-grid interpolations in 2D, and
in 3D where the JAX function takes a 3D field. The operations are the same
elementwise sums, so the two agree to 1e-15 relative to the field's max."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from justrelax_tpu.ops import interpolation as ji
from justrelax_tpu_torch.ops import interpolation as pi

torch.set_num_threads(1)

TOL = 1e-15


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() <= TOL * np.abs(b).max()


def _fields(shape, seed=0):
    """A lognormal field (positive, for the harmonic mean) of ``shape``."""
    return np.exp(np.random.default_rng(seed).normal(size=shape))


@pytest.mark.parametrize("ni", [(7, 5), (4, 6, 5)])
def test_vertex_center_averages(ni):
    c = _fields(ni)
    v = _fields(tuple(n + 1 for n in ni), seed=1)
    _close(pi.vertex2center(torch.tensor(v)), ji.vertex2center(jnp.asarray(v)))
    _close(pi.shear2center(torch.tensor(v)), ji.shear2center(jnp.asarray(v)))
    _close(pi.center2vertex_harm(torch.tensor(c)), ji.center2vertex_harm(jnp.asarray(c)))
    if len(ni) == 2:  # JAX's center2vertex is 2D
        _close(pi.center2vertex(torch.tensor(c)), ji.center2vertex(jnp.asarray(c)))


def test_velocity_interpolations():
    nx, ny = 7, 5
    Vx, Vy = _fields((nx + 1, ny + 2), 2), _fields((nx + 2, ny + 1), 3)
    for f in ("velocity2vertex", "velocity2center"):
        for a, b in zip(getattr(pi, f)(torch.tensor(Vx), torch.tensor(Vy)),
                        getattr(ji, f)(jnp.asarray(Vx), jnp.asarray(Vy))):
            _close(a, b)


@pytest.mark.parametrize("ndim", [2, 3])
def test_velocity_displacement(ndim):
    V = tuple(_fields((5,) * ndim, 4 + k) for k in range(ndim))
    dt = 0.37
    U = pi.velocity2displacement(tuple(map(torch.tensor, V)), dt)
    jU = ji.velocity2displacement(tuple(map(jnp.asarray, V)), dt)
    for a, b in zip(U, jU):
        _close(a, b)
    for a, b in zip(pi.displacement2velocity(U, dt), ji.displacement2velocity(jU, dt)):
        _close(a, b)
