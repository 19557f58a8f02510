"""PyTorch port, ``ops/heating.py`` against the JAX package on the same numpy
inputs, in float64, to 1e-14 relative to each result's max: 2D and 3D shear
heating (finite G·dt and the G = ∞ / dt = ∞ limits, with and without phase
ratios), the adiabatic term, and the edge-to-center shear averages."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from justrelax_tpu.ops import heating as jh
from justrelax_tpu.rheology import materials as jm
from justrelax_tpu_torch.ops import heating as ph
from justrelax_tpu_torch.rheology import materials as pm

torch.set_num_threads(1)

TOL = 1e-14
MATS = [dict(G=2.0), dict(G=0.5), dict(G=np.inf)]


def _stacks():
    return (pm.MaterialStack.make([pm.Material(**kw) for kw in MATS], device="cpu"),
            jm.MaterialStack.make([jm.Material(**kw) for kw in MATS]))


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() <= TOL * np.abs(b).max()


def _ratios(shape, seed):
    r = np.random.default_rng(seed).uniform(size=shape + (len(MATS),))
    return r / r.sum(axis=-1, keepdims=True)


@pytest.mark.parametrize("dt", [0.3, math.inf])
@pytest.mark.parametrize("with_ratios", [True, False])
def test_shear_heating_2d(dt, with_ratios):
    rng = np.random.default_rng(1)
    ni = (7, 5)
    c = [rng.standard_normal(ni) for _ in range(9)]
    exy_v = rng.standard_normal((ni[0] + 1, ni[1] + 1))
    r = _ratios(ni, 2) if with_ratios else None
    p, j = _stacks()
    a = ph.compute_shear_heating(*map(torch.tensor, c[:8]), torch.tensor(exy_v), p, dt,
                                 phase_ratios=None if r is None else torch.tensor(r))
    b = jh.compute_shear_heating(*map(jnp.asarray, c[:8]), jnp.asarray(exy_v), j, dt,
                                 phase_ratios=None if r is None else jnp.asarray(r))
    _close(a, b)
    assert float(a.min()) == 0.0 and float(a.max()) > 0.0  # the clamp takes part


def _edges(ni, rng):
    nx, ny, nz = ni
    return (rng.standard_normal((nx, ny + 1, nz + 1)), rng.standard_normal((nx + 1, ny, nz + 1)),
            rng.standard_normal((nx + 1, ny + 1, nz)))


@pytest.mark.parametrize("dt", [0.3, math.inf])
@pytest.mark.parametrize("with_ratios", [True, False])
def test_shear_heating_3d(dt, with_ratios):
    rng = np.random.default_rng(2)
    ni = (5, 4, 6)
    tau, tau_o, eps = ([rng.standard_normal(ni) for _ in range(6)] for _ in range(3))
    r = _ratios(ni, 3) if with_ratios else None
    p, j = _stacks()
    a = ph.compute_shear_heating_3d(tuple(map(torch.tensor, tau)), tuple(map(torch.tensor, tau_o)),
                                    tuple(map(torch.tensor, eps)), p, dt,
                                    phase_ratios=None if r is None else torch.tensor(r))
    b = jh.compute_shear_heating_3d(tuple(map(jnp.asarray, tau)), tuple(map(jnp.asarray, tau_o)),
                                    tuple(map(jnp.asarray, eps)), j, dt,
                                    phase_ratios=None if r is None else jnp.asarray(r))
    _close(a, b)
    assert float(a.min()) == 0.0 and float(a.max()) > 0.0


def test_shear_components_to_centers_3d():
    e = _edges((5, 4, 6), np.random.default_rng(3))
    for a, b in zip(ph.shear_components_to_centers_3d(*map(torch.tensor, e)),
                    jh.shear_components_to_centers_3d(*map(jnp.asarray, e))):
        _close(a, b)


def test_adiabatic_heating():
    rng = np.random.default_rng(4)
    nx, ny = 7, 5
    alpha, T, P, rho_gy = (rng.uniform(0.5, 1.5, (nx, ny)) for _ in range(4))
    Vx, Vy = rng.standard_normal((nx + 1, ny + 2)), rng.standard_normal((nx + 2, ny + 1))
    inv_di = (3.0, 0.7)
    a = ph.adiabatic_heating(*map(torch.tensor, (alpha, T, Vx, Vy, P, rho_gy)), inv_di)
    b = jh.adiabatic_heating(*map(jnp.asarray, (alpha, T, Vx, Vy, P, rho_gy)), inv_di)
    _close(a, b)
