"""PyTorch port, the coupled thermo-mechanical models of the module queue
against the JAX models with the same arguments, in float64 on the CPU:
every Stokes field within 1e-10 of its family's max and the thermal fields
within 1e-10 of their own, equal iteration counts, the residuals and their
norms within 1e-10 of the residual scale.

- ``thermal_stresses.run(nx=8, ny=8, nt=1)`` on the plain path and on the
  thermal kernel's route (CPU tensors run the chunk's plain version), and
  ``run_3d(n=6, nt=1)``;
- ``shearheating.run(nx=8, ny=8, nt=1)`` and
  ``shearheating3d.run(nx=6, ny=6, nz=6, nt=1)``, the latter also on the 3D
  kernel's route (its residuals come from the chunk's output, so it is held
  to the plain path's physics, not to its iteration count).
"""

import numpy as np
import pytest
import torch
from flax import serialization

from justrelax_tpu.models import shearheating as jsh
from justrelax_tpu.models import shearheating3d as jsh3
from justrelax_tpu.models import thermal_stresses as jts
from justrelax_tpu_torch import convert
from justrelax_tpu_torch.models import shearheating, shearheating3d, thermal_stresses
from test_torch_models_flow import TOL, _model_close
from test_torch_stokes_ve import _info_close
from test_torch_thermal import _rel

torch.set_num_threads(1)


def _thermal_close(p_th, j_th, res_scale, tol=TOL):
    """Each thermal field within ``tol`` of its own max, the fluxes of its
    family's: a flux that is zero by symmetry (the x-flux of a model uniform
    along x) carries rounding only, so it is held on the largest flux. ResT
    is a difference of its terms, held on ``res_scale``."""
    a, b = convert.to_state_dict(p_th), serialization.to_state_dict(j_th)
    assert a.keys() == b.keys()
    fluxes = [k for k in b if k.startswith("qT") and b[k] is not None]
    q_scale = max(float(np.abs(np.asarray(b[k])).max()) for k in fluxes)
    for k in a:
        if b[k] is None:
            assert a[k] is None
            continue
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.shape == y.shape, k
        d = np.abs(x - y).max(initial=0.0)
        if k == "ResT":
            assert d <= tol * res_scale, k
        elif k in fluxes:
            assert d <= tol * q_scale, (k, d / q_scale)
        else:
            assert _rel(x, y) <= tol, (k, _rel(x, y))


def _rhoCp_T_scale(j_th, rho_cp, dt):
    """The size of the terms the heat-equation residual sums (ρCp·T/dt)."""
    return float(np.abs(np.asarray(j_th.Told)).max() * rho_cp / dt)


def _shear_heating_res_scale(j_th):
    """The size of the shear heating models' residual terms: the source the
    residual balances (the models do not return their CFL time step, which
    ρCp·T/dt would need)."""
    return float(np.abs(np.asarray(j_th.shear_heating)).max())


@pytest.mark.parametrize("use_kernel", [False, True])
def test_thermal_stresses_matches_jax(use_kernel):
    p_st, p_th, p_phi, p_info, p_ch = thermal_stresses.run(
        nx=8, ny=8, nt=1, device="cpu", use_kernel=use_kernel)
    j_st, j_th, j_phi, j_info, j_ch = jts.run(nx=8, ny=8, nt=1)
    assert np.array_equal(p_ch, j_ch)
    di = (20.0e3 / 8,) * 2
    sc = _model_close(p_st, j_st, di)
    _info_close(p_info, j_info, sc["residual"], res_tol=TOL)
    dt = 0.25 * di[0] ** 2 / (3.0 / (2.65e3 * 1.05e3))
    _thermal_close(p_th, j_th, _rhoCp_T_scale(j_th, 2.65e3 * 1.05e3, dt))
    np.testing.assert_allclose(p_phi.numpy(), np.asarray(j_phi), rtol=TOL, atol=TOL)
    assert float(p_phi.max()) > 0.5 and float(p_st.P.abs().max()) > 0.0


def test_thermal_stresses_3d_matches_jax():
    p_st, p_th, p_phi, p_info, p_ch = thermal_stresses.run_3d(n=6, nt=1, device="cpu")
    j_st, j_th, j_phi, j_info, j_ch = jts.run_3d(n=6, nt=1)
    assert np.array_equal(p_ch, j_ch)
    di = (20.0e3 / 6,) * 3
    sc = _model_close(p_st, j_st, di)
    _info_close(p_info, j_info, sc["residual"], res_tol=TOL)
    dt = 0.25 * di[0] ** 2 / (3.0 / (2.65e3 * 1.05e3))
    _thermal_close(p_th, j_th, _rhoCp_T_scale(j_th, 2.65e3 * 1.05e3, dt))
    np.testing.assert_allclose(p_phi.numpy(), np.asarray(j_phi), rtol=TOL, atol=TOL)


def test_shearheating_matches_jax():
    p_st, p_th, p_info = shearheating.run(nx=8, ny=8, nt=1, device="cpu")
    j_st, j_th, j_info = jsh.run(nx=8, ny=8, nt=1)
    di = (70.0e3 / 8, 40.0e3 / 8)
    sc = _model_close(p_st, j_st, di, rho_g=2700.0 * 9.81)
    _info_close(p_info, j_info, sc["residual"], res_tol=TOL)
    _thermal_close(p_th, j_th, _shear_heating_res_scale(j_th))
    H = p_th.shear_heating.numpy()
    assert (H >= 0).all() and H.max() > 0.0


def test_shearheating3d_matches_jax():
    p_st, p_th, p_info = shearheating3d.run(nx=6, ny=6, nz=6, nt=1, device="cpu")
    j_st, j_th, j_info = jsh3.run(nx=6, ny=6, nz=6, nt=1)
    di = (70.0e3 / 6, 60.0e3 / 6, 40.0e3 / 6)
    sc = _model_close(p_st, j_st, di)
    _info_close(p_info, j_info, sc["residual"], res_tol=TOL)
    _thermal_close(p_th, j_th, _shear_heating_res_scale(j_th))
    H = p_th.shear_heating.numpy()
    assert (H >= 0).all() and H.max() > 0.0


def test_shearheating3d_kernel_route():
    """On CPU tensors ``use_kernel=True`` runs B7's plain chunk: the guard
    takes the model's configuration, and the result is the plain path's
    within the solve's tolerance."""
    k_st, k_th, k_info = shearheating3d.run(nx=6, ny=6, nz=6, nt=1, device="cpu",
                                            use_kernel=True)
    p_st, p_th, p_info = shearheating3d.run(nx=6, ny=6, nz=6, nt=1, device="cpu")
    assert float(k_info.err) < 1e-5
    H_k, H_p = k_th.shear_heating, p_th.shear_heating
    assert bool((H_k >= 0).all()) and float(H_k.max()) > 0.0
    assert float((H_k - H_p).abs().max()) <= 1e-6 * float(H_p.abs().max())


@pytest.mark.slow
def test_thermal_stresses_golden():
    """tests/test_thermal_stresses.py's assertions at 48², two steps, through
    the port."""
    stokes, thermal, phi, info, chamber = thermal_stresses.run(nx=48, ny=48, nt=2, device="cpu")
    assert int(info.iters) < 100_000 and float(info.err) < 1.0e-5
    P, phi = stokes.P.numpy(), phi.numpy()
    rr = np.hypot(*np.meshgrid(np.linspace(-1, 1, P.shape[0]), np.linspace(-1, 1, P.shape[1]),
                               indexing="ij"))
    core, far = rr < 0.15, rr > 0.8
    assert phi[core].min() > 0.95 and phi[~chamber].max() < 0.5
    near = ~chamber & ~far
    assert P[near].max() > 10.0 * abs(P[far]).max()
    assert P[chamber].min() < -10.0 * abs(P[far]).max()
    dT = (thermal.T - thermal.Told).numpy()[1:-1, 1:-1]
    assert np.abs(P).max() < (1.0 / 6.0e-11) * 6.0e-5 * np.abs(dT).max() * 1.5


def test_default_routes_as_on_the_card(monkeypatch):
    """With ``use_kernel=None`` resolved as on the card (the kernel), every
    model of the queue runs: the kernel-capable solves take their chunk's
    route (the plain chunk on CPU tensors) and each plain-by-contract solve
    passes ``use_kernel=False`` itself, so none raises the kernel guard's
    ``ValueError``."""
    from justrelax_tpu_torch.core import device
    from justrelax_tpu_torch.models import diffusion3d, global_convection2d, sinking_block, solvi2d
    from justrelax_tpu_torch.solvers import stokes2d, stokes2d_vep, stokes3d, thermal

    def as_on_the_card(use_kernel, tensor, allowed=(False, True, "blocked")):
        return device.resolve_use_kernel(True if use_kernel is None else use_kernel, tensor,
                                         allowed)

    for mod in (stokes2d, stokes2d_vep, stokes3d, thermal):
        monkeypatch.setattr(mod, "resolve_use_kernel", as_on_the_card)
    runs = (
        lambda: sinking_block.run(n=8, iter_max=200, nout=100, device="cpu"),
        lambda: solvi2d.run(n=8, iter_max=100, nout=50, device="cpu"),
        lambda: global_convection2d.run(n=8, nt=1, picard=1, device="cpu"),
        lambda: thermal_stresses.run(nx=8, ny=8, nt=1, device="cpu"),
        lambda: thermal_stresses.run_3d(n=4, nt=1, device="cpu"),
        lambda: shearheating.run(nx=8, ny=8, nt=1, device="cpu"),
        lambda: shearheating3d.run(nx=4, ny=4, nz=4, nt=1, device="cpu"),
        lambda: diffusion3d.run(n=4, ttot=50 * diffusion3d.KYR, device="cpu"),
    )
    for run in runs:
        out = run()
        assert out is not None
