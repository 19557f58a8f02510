"""PyTorch port, the coupled Blankenbach convection step against the JAX
package, in float64 on the CPU: the velocity interpolations, WENO-5
advection and the CFL time step (1e-14, relative to each field's max), and
``blankenbach.run(nx=16, ny=16, nit=1)`` — a VEP Stokes solve with a bare
``Material`` and no phase ratios, the time step, the material-path thermal
solve and the advection — on Urms, Nu and every field (1e-8).
"""

import math

import numpy as np
import pytest
import torch
from flax import serialization

from justrelax_tpu.advection import weno5 as jweno
from justrelax_tpu.models import blankenbach as jblankenbach
from justrelax_tpu.ops import interpolation as jinterp
from justrelax_tpu.utils import timestep as jtimestep
from justrelax_tpu_torch import convert
from justrelax_tpu_torch.advection import weno5
from justrelax_tpu_torch.models import blankenbach
from justrelax_tpu_torch.ops import hopper_stokes_vep as hv
from justrelax_tpu_torch.ops import hopper_thermal as ht
from justrelax_tpu_torch.ops import interpolation
from justrelax_tpu_torch.utils import timestep
from test_torch_stokes_ve import _family, _flat, _rel, _scales

torch.set_num_threads(1)


def _t(x):
    return torch.tensor(np.asarray(x))


def _velocities(nx=9, ny=7, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((nx + 1, ny + 2)), rng.standard_normal((nx + 2, ny + 1))


def test_velocity_interpolation():
    Vx, Vy = _velocities()
    for name in ("velocity2vertex", "velocity2center"):
        a = getattr(interpolation, name)(_t(Vx), _t(Vy))
        b = getattr(jinterp, name)(Vx, Vy)
        for x, y in zip(a, b):
            assert _rel(x, y) <= 1e-14, name


@pytest.mark.parametrize("method", [1, 2])
def test_weno_advect(method):
    rng = np.random.default_rng(1)
    n = (12, 10)
    X, Y = np.meshgrid(np.linspace(0, 1, n[0]), np.linspace(0, 1, n[1]), indexing="ij")
    u = np.exp(-((X - 0.4) ** 2 + (Y - 0.6) ** 2) / 0.02) + 0.01 * rng.standard_normal(n)
    vx, vy = rng.standard_normal(n), rng.standard_normal(n)  # both signs: up- and downwind
    di, dt = (1.0 / 11, 1.0 / 9), 0.02
    a = weno5.weno_advect(_t(u), (_t(vx), _t(vy)), di, dt, method=method)
    b = jweno.weno_advect(u, (vx, vy), di, dt, method=method)
    assert _rel(a, b) <= 1e-14
    assert _rel(a, u) > 1e-3  # it advected


def test_compute_dt():
    Vx, Vy = _velocities(seed=2)
    di = (0.3, 0.2)
    for dt_diff in (math.inf, 0.05, 1e-4):
        a = timestep.compute_dt((_t(Vx), _t(Vy)), di, dt_diff)
        b = jtimestep.compute_dt((Vx, Vy), di, dt_diff)
        assert float(a) == float(b), dt_diff
    zero = torch.zeros(3, 3, dtype=torch.float64)
    assert float(timestep.compute_dt((zero, zero), di, 7.0)) == 7.0


def test_blankenbach_matches_jax():
    """On the CPU the default path is the plain one: no kernel launches."""
    hv.stokes_vep_chunk.launches = ht.thermal_chunk.launches = 0
    p_urms, p_nu, p_info, p_st, p_th = blankenbach.run(nx=16, ny=16, nit=1, device="cpu")
    j_urms, j_nu, j_info, j_st, j_th = jblankenbach.run(nx=16, ny=16, nit=1)
    assert hv.stokes_vep_chunk.launches == 0 and ht.thermal_chunk.launches == 0
    np.testing.assert_allclose(p_urms, j_urms, rtol=1e-8)
    np.testing.assert_allclose(p_nu, j_nu, rtol=1e-8)
    assert p_info.iters == int(j_info.iters)
    assert float(p_info.err) == pytest.approx(float(j_info.err), rel=1e-8)
    # Stokes fields on their family's max (a field that is zero in the exact
    # solution, ∇·V, carries rounding only), residuals on the size of their
    # terms, with ρ0·g the buoyancy scale (test_torch_stokes_ve._scales).
    # EII_pl is NaN in both: the viscous limit runs with dt = ∞.
    a, b = _flat(convert.to_state_dict(p_st)), _flat(serialization.to_state_dict(j_st))
    assert a.keys() == b.keys()
    sc = _scales(b, (1000.0e3 / 16,) * 2, 4000.0 * 10.0)
    for k in a:
        nan = np.isnan(b[k])
        assert np.array_equal(np.isnan(a[k]), nan), k
        x, y = np.where(nan, 0.0, a[k]), np.where(nan, 0.0, b[k])
        if k.startswith("R."):
            assert np.abs(x - y).max() <= 1e-8 * sc["residual"], k
        elif _family(k) is not None:
            assert np.abs(x - y).max() <= 1e-8 * sc[_family(k)], k
        else:
            assert _rel(x, y) <= 1e-8, (k, _rel(x, y))
    a, b = convert.to_state_dict(p_th), serialization.to_state_dict(j_th)
    assert a.keys() == b.keys()
    for k in a:
        if b[k] is not None and k != "ResT":  # ResT: a residual, held in test_torch_thermal
            assert _rel(a[k], b[k]) <= 1e-8, (k, _rel(a[k], b[k]))
    assert p_th.T.dtype == torch.float64 and p_st.P.device.type == "cpu"
