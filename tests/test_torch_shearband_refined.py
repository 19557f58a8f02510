"""PyTorch port, ``models/shearband_refined.py`` (the shear band on a
monitor-refined x axis) against the JAX package in float64 on the CPU:
``refined_axis`` bit for bit, ``run(n=16, nt=2)`` within 1e-10 with equal
iterations (the JAX model's own caps, 50 000 and nout 100, on both), and
as a ``slow`` test the n=32, nt=10 golden on tests/test_shearband_refined.py's
assertions.
"""

import numpy as np
import pytest
import torch
from flax import serialization

from justrelax_tpu.models import shearband_refined as jm
from justrelax_tpu_torch import convert
from justrelax_tpu_torch.models import shearband_refined as pm
from test_torch_dyrel import _flat, _max_rel

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [16, 32, 1024])
def test_refined_axis_matches_jax(n):
    a, b = pm.refined_axis(n), jm.refined_axis(n)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    dx = np.diff(a)
    assert a[0] == 0.0 and a[-1] == 1.0 and (dx > 0).all()
    assert 0.4 < a[int(np.argmin(dx))] < 0.6 and dx.max() / dx.min() > 4.0


def test_run_matches_jax():
    ps, pi, p_tau, p_sol, p_tII = pm.run(n=16, nt=2, device="cpu")
    js, ji, j_tau, j_sol, j_tII = jm.run(n=16, nt=2)
    assert int(pi.iters) == int(ji.iters) > 0
    assert p_sol == j_sol
    np.testing.assert_allclose(p_tau, j_tau, rtol=1e-10, atol=0.0)
    assert _max_rel(p_tII.numpy(), np.asarray(j_tII)) <= 1e-10
    p = _flat(convert.to_state_dict(ps))
    j = _flat(serialization.to_state_dict(js))
    vmax = max(np.abs(j["V.Vx"]).max(), np.abs(j["V.Vy"]).max())
    # the residuals and ∇·V at the scale of their terms; P at the stress
    # scale (τ ≈ 1; P is rounding where the flow is pure shear)
    scales = {"R.Rx": 1.0, "R.Ry": 1.0, "R.RP": vmax * 16 * 10, "grad_V": vmax * 16 * 10,
              "P": 1.0, "P0": 1.0}
    worst = {k: _max_rel(p[k], j[k], scales.get(k)) for k in j if k in p}
    assert {k for k, v in worst.items() if v > 1e-10} == set(), worst


@pytest.mark.slow
def test_golden_n32():
    """tests/test_shearband_refined.py::test_shearband_refined on the port."""
    stokes, info, tau_max_hist, sol_hist, tau_II = pm.run(n=32, nt=10, device="cpu")
    assert float(info.err) < 1.0e-6
    for got, sol in zip(tau_max_hist[:5], sol_hist[:5]):
        np.testing.assert_allclose(got, sol, rtol=4.0e-2)
    tII = tau_II.numpy()
    np.testing.assert_allclose(tII.min(), 1.51336, atol=2e-3)
    np.testing.assert_allclose(tII.max(), 1.63926, atol=2e-3)
    np.testing.assert_allclose(tII.min(), 1.49798, atol=2e-2)
    np.testing.assert_allclose(tII.max(), 1.64485, atol=1e-2)
    np.testing.assert_allclose(tau_max_hist[-1], 1.64586, atol=2e-3)
