"""PyTorch port, the DYREL models and the displacement-driven shear band
against the JAX package on the CPU in float64:

- ``shearband_dyrel.run`` and ``run_dpcap`` at n=10 over their first steps;
- ``thermal_stresses_dyrel.run`` at 16², one step (DYREL's tolerance cut
  to 1e-1 in both packages, through the model's ``eps``);
- ``shearband.run(displacement_driven=True)`` at n=12 against JAX, and
  against the port's velocity-driven band (tests/test_displacement.py's
  check);

each with equal iterations and its fields within 1e-10 of their max.
"""

import math

import numpy as np
import pytest
import torch

from justrelax_tpu.models import shearband as jshearband
from justrelax_tpu.models import shearband_dyrel as jsd
from justrelax_tpu.models import thermal_stresses_dyrel as jtsd
from justrelax_tpu_torch.models import shearband, shearband_dyrel, thermal_stresses_dyrel

torch.set_num_threads(1)


def _close(a, b, tol=1e-10):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    scale = np.abs(b).max(initial=0.0)
    assert np.abs(a - b).max(initial=0.0) <= tol * scale


def test_shearband_dyrel_matches_jax():
    p_st, p_info, p_tmax, p_sol, p_tII = shearband_dyrel.run(n=10, nt=2, device="cpu")
    j_st, j_info, j_tmax, j_sol, j_tII = jsd.run(n=10, nt=2)
    assert p_info.iters == int(j_info.iters) > 0
    assert float(p_info.err) < 1e-6
    np.testing.assert_allclose(p_tmax, j_tmax, rtol=1e-10)
    assert p_sol == j_sol
    _close(p_tII.numpy(), j_tII)
    for a, b in ((p_st.V.Vx, j_st.V.Vx), (p_st.V.Vy, j_st.V.Vy), (p_st.P, j_st.P),
                 (p_st.tau.xy, j_st.tau.xy), (p_st.viscosity.eta_vep, j_st.viscosity.eta_vep)):
        _close(a.numpy(), b)


def test_shearband_dyrel_dpcap_matches_jax():
    p_st, p_info, p_tII = shearband_dyrel.run_dpcap(n=10, nt=1, device="cpu")
    j_st, j_info, j_tII = jsd.run_dpcap(n=10, nt=1)
    assert p_info.iters == int(j_info.iters) > 0
    _close(p_tII.numpy(), j_tII)
    for a, b in ((p_st.V.Vx, j_st.V.Vx), (p_st.P, j_st.P), (p_st.EVol_pl, j_st.EVol_pl),
                 (p_st.eps_vol_pl, j_st.eps_vol_pl), (p_st.eps_pl.xx, j_st.eps_pl.xx),
                 (p_st.dP_psi, j_st.dP_psi)):
        _close(a.numpy(), b)


def test_thermal_stresses_dyrel_matches_jax():
    p_st, p_th, p_phi, p_info, p_ch = thermal_stresses_dyrel.run(
        nx=16, ny=16, nt=1, eps=1e-1, device="cpu")
    j_st, j_th, j_phi, j_info, j_ch = jtsd.run(nx=16, ny=16, nt=1, eps=1e-1)
    assert p_info.iters == int(j_info.iters) > 0
    assert float(p_info.err) <= 1e-1
    assert (p_ch == np.asarray(j_ch)).all()
    for a, b in ((p_th.T, j_th.T), (p_phi, j_phi), (p_st.P, j_st.P), (p_st.V.Vx, j_st.V.Vx),
                 (p_st.V.Vy, j_st.V.Vy), (p_st.tau.xx, j_st.tau.xx)):
        _close(a.numpy(), b)


def test_shearband_displacement_driven():
    n, nt, dt = 12, 2, 0.25
    p_u = shearband.run(n=n, nt=nt, displacement_driven=True, device="cpu")
    j_u = jshearband.run(n=n, nt=nt, displacement_driven=True)
    assert p_u[1].iters == int(j_u[1].iters)
    np.testing.assert_allclose(p_u[2], j_u[2], rtol=1e-10)
    _close(p_u[4].numpy(), j_u[4])
    _close(p_u[0].U.Ux.numpy(), j_u[0].U.Ux)
    _close(p_u[0].U.Uy.numpy(), j_u[0].U.Uy)
    # the same physics as the velocity-driven band (tests/test_displacement.py)
    p_v = shearband.run(n=n, nt=nt, device="cpu")
    np.testing.assert_allclose(p_u[2], p_v[2], rtol=1e-12)
    np.testing.assert_allclose(p_u[4].numpy(), p_v[4].numpy(), atol=1e-12)
    np.testing.assert_allclose(p_u[0].U.Ux.numpy(), p_u[0].V.Vx.numpy() * dt, atol=1e-15)


@pytest.mark.slow
def test_shearband_dyrel_golden_f64():
    """tests/test_dyrel.py's assertions at n=32, nt=10 (on the card in
    ``chip_smoke.py`` phase 30)."""
    stokes, info, tau_max, sol, tau_II = shearband_dyrel.run(n=32, nt=10, device="cpu")
    assert float(info.err) < 1.0e-6
    assert sol[-1] == pytest.approx(1.8358, abs=1.0e-4)
    assert float(tau_II.max()) == pytest.approx(1.639, abs=1.0e-3)
    assert float(tau_II.min()) == pytest.approx(1.5383533580936255, abs=1.0e-2)
    assert tau_max[-1] == pytest.approx(1.6377101324888117, abs=5.0e-3)
    assert info.iters < 20_000
    assert math.isfinite(float(tau_II.max()))
