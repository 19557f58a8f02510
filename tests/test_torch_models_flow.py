"""PyTorch port, the 2D Stokes models of the module queue against the JAX
models with the same arguments, in float64 on the CPU: every field within
1e-10 of its family's max, equal iteration counts, the residuals and their
norms within 1e-10 of the residual scale (``test_torch_stokes_ve``'s
``_state_close`` and ``_info_close``).

- ``sinking_block.run(n=8)`` with ``iter_max`` and ``nout`` cut, on the plain
  path and on the kernel's route (CPU tensors run the chunk's plain
  version), and its set-up;
- ``solvi2d.run(n=8)`` (no cell inside the default inclusion: the uniform
  pure shear, exact after one chunk) and with a wider inclusion and a cut
  iteration budget;
- ``global_convection2d.run(n=16, nt=1, picard=1)`` on both routes (at
  n=8 no cell lies in the anomaly, so the flow is rounding noise around
  V = 0), the strain rates held on max |V| / min(di); its custom viscosity
  and half-space-cooling set-up;
- ``shearband.run(n=8, nt=2, visc_plastic_tau=True, use_kernel=False)``
  (elastic loading: nothing yields yet at n=8), and ``solve_vep`` with the
  variant from a state near yield, where it acts; ηv held where τxy at the
  vertex is not rounding.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from justrelax_tpu.models import global_convection2d as jgc
from justrelax_tpu.models import shearband as jshearband
from justrelax_tpu.models import sinking_block as jsinking_block
from justrelax_tpu.models import solvi2d as jsolvi2d
from justrelax_tpu_torch.models import global_convection2d, shearband, sinking_block, solvi2d
from flax import serialization

from justrelax_tpu_torch import convert
from justrelax_tpu.core.coeffs import PTStokesCoeffs as JCoeffs
from justrelax_tpu.core.grid import Geometry as JGeometry
from justrelax_tpu.core.state import StokesState as JStokesState
from justrelax_tpu.ops import bc as jbc
from justrelax_tpu.rheology import materials as jm
from justrelax_tpu.solvers.stokes2d_vep import solve_vep as j_solve_vep
from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.ops import bc as pbc
from justrelax_tpu_torch.rheology import materials as pm
from justrelax_tpu_torch.solvers.stokes2d_vep import solve_vep
from test_torch_shearband import _setup as _sb_setup
from test_torch_stokes_ve import _family, _flat, _info_close, _rel, _scales, _state_close
from test_torch_thermal import _res_scale, _thermal_close

torch.set_num_threads(1)

TOL = 1e-10


def _rho_g_sinking_block():
    return 3.3e3 * 9.81


def _model_close(port_state, jax_state, di, rho_g=0.0, rates_on_velocity=False, skip=(),
                 tol=TOL):
    """``test_torch_stokes_ve._state_close`` with two options.
    ``rates_on_velocity`` holds the strain rates on max |V| / min(di): for a
    flow that is a small remainder of large terms, a rate is a difference
    of velocities over a spacing, so its rounding is absolute on that
    scale, as a residual's is on its terms' size. ``skip`` names fields the
    caller checks itself. A nan (dt = ∞ makes the plastic strain 0·∞ in
    both packages) must sit where JAX has one; the rest is compared.
    Returns the scales."""
    a = _flat(convert.to_state_dict(port_state))
    b = _flat(serialization.to_state_dict(jax_state))
    assert a.keys() == b.keys()
    for k in a:
        nan = np.isnan(b[k])
        assert np.array_equal(np.isnan(a[k]), nan), k
        a[k], b[k] = np.where(nan, 0.0, a[k]), np.where(nan, 0.0, b[k])
    sc = _scales(b, di, rho_g)
    if rates_on_velocity:
        sc["rate"] = max(sc["rate"], sc["velocity"] / min(di))
    for k in a:
        d = np.abs(a[k] - b[k]).max(initial=0.0)
        if k in skip:
            continue
        if k.startswith("R."):
            assert d <= tol * sc["residual"], k
        elif _family(k) is not None:
            assert d <= tol * sc[_family(k)], (k, d / sc[_family(k)])
        else:
            assert _rel(a[k], b[k]) <= tol, (k, _rel(a[k], b[k]))
    return sc


@pytest.mark.parametrize("use_kernel", [False, True])
def test_sinking_block_matches_jax(use_kernel):
    kw = dict(n=8, iter_max=2000, nout=100)
    p_st, p_info, p_vmax = sinking_block.run(device="cpu", use_kernel=use_kernel, **kw)
    j_st, j_info, j_vmax = jsinking_block.run(**kw)
    di = (500.0e3 / 8,) * 2
    sc = _state_close(p_st, j_st, di, rho_g=_rho_g_sinking_block(), tol=TOL, res_tol=TOL)
    _info_close(p_info, j_info, sc["residual"], res_tol=TOL)
    assert p_vmax == pytest.approx(j_vmax, rel=TOL)
    assert p_info.iters == 1200 and p_vmax > 0.0


def test_solvi2d_matches_jax():
    p_g, p_st, p_info, p_inside = solvi2d.run(n=8, device="cpu")
    j_g, j_st, j_info, j_inside = jsolvi2d.run(n=8)
    assert np.array_equal(p_inside, j_inside) and not p_inside.any()
    sc = _state_close(p_st, j_st, p_g.di, tol=TOL, res_tol=TOL)
    _info_close(p_info, j_info, sc["residual"], res_tol=TOL)
    assert float(p_info.err) == 0.0  # the exact pure shear: 0/0 stops after one chunk


def test_solvi2d_inclusion_matches_jax():
    kw = dict(n=8, rc=0.6, iter_max=2000, nout=500)
    p_g, p_st, p_info, p_inside = solvi2d.run(device="cpu", **kw)
    j_g, j_st, j_info, j_inside = jsolvi2d.run(**kw)
    assert p_inside.sum() > 4
    sc = _state_close(p_st, j_st, p_g.di, tol=TOL, res_tol=TOL)
    _info_close(p_info, j_info, sc["residual"], res_tol=TOL)
    assert solvi2d.interior_amplitude(1.0, 1e-3, 1.0) == jsolvi2d.interior_amplitude(1.0, 1e-3, 1.0)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_global_convection_matches_jax(use_kernel):
    kw = dict(n=16, nt=1, picard=1)
    p_g, p_st, p_th, p_info, p_t, p_eta = global_convection2d.run(
        device="cpu", use_kernel=use_kernel, **kw)
    j_g, j_st, j_th, j_info, j_t, j_eta = jgc.run(**kw)
    sc = _model_close(p_st, j_st, p_g.di, 3.1e3 * 9.81, rates_on_velocity=True)
    _info_close(p_info, j_info, sc["residual"], res_tol=TOL)
    _thermal_close(p_th, j_th, tol=TOL)
    res = np.abs(np.asarray(p_th.ResT) - np.asarray(j_th.ResT)).max()
    assert res <= TOL * _res_scale(j_th.Told, 3.1e3 * 1.2e3, j_t)
    assert p_t == pytest.approx(j_t, rel=TOL)
    np.testing.assert_allclose(p_eta, j_eta, rtol=TOL)
    assert float(p_info.err) < 1e-4


def test_global_convection_setup_matches_jax():
    rng = np.random.default_rng(5)
    T = rng.uniform(300.0, 3500.0, (6, 5))
    P = rng.uniform(0.0, 1.4e11, (6, 5))
    depth = np.linspace(0.0, 2890.0e3, 30).reshape(6, 5)
    a = global_convection2d.custom_viscosity(torch.tensor(T), torch.tensor(P), torch.tensor(depth))
    b = jgc.custom_viscosity(jnp.asarray(T), jnp.asarray(P), jnp.asarray(depth))
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14)
    zc = -np.linspace(10.0e3, 2880.0e3, 17)
    kappa = 3.0 / (1.2e3 * 3.1e3)
    assert np.array_equal(global_convection2d.half_space_cooling_T(zc, kappa, 2767.0, 1900.0, 300.0),
                          jgc.half_space_cooling_T(zc, kappa, 2767.0, 1900.0, 300.0))


def test_shearband_visc_plastic_tau_matches_jax():
    p_st, p_info, p_tmax, _, p_tII = shearband.run(n=8, nt=2, visc_plastic_tau=True,
                                                   use_kernel=False, device="cpu")
    j_st, j_info, j_tmax, _, j_tII = jshearband.run(n=8, nt=2, visc_plastic_tau=True)
    sc = _model_close(p_st, j_st, (1.0 / 8, 1.0 / 8), skip=("viscosity.eta_v",))
    _info_close(p_info, j_info, sc["residual"], res_tol=TOL)
    # ηv is a diagnostic (the stress update reads η at the centers). Where
    # τxy at a vertex is rounding (on the symmetry lines, |τxy| ~ 1e-16 or
    # below 1e-30, where the composite's clamp acts), η = τII/(2 ε̇) is a
    # quotient of rounding in both packages; elsewhere it agrees
    live = np.abs(np.asarray(j_st.tau.xy)) > 1e-12 * sc["stress"]
    assert live.sum() > 10
    np.testing.assert_allclose(p_st.viscosity.eta_v.numpy()[live],
                               np.asarray(j_st.viscosity.eta_v)[live], rtol=TOL)
    np.testing.assert_allclose(p_tII.numpy(), np.asarray(j_tII), rtol=TOL)
    np.testing.assert_allclose(p_tmax, j_tmax, rtol=TOL)


def test_solve_vep_visc_plastic_tau_matches_jax():
    """The variant where it acts: ``tests/test_torch_shearband.py``'s solve
    with stresses near yield, 300 iterations (``iter_min == iter_max``),
    against JAX's ``solve_vep(visc_plastic_tau=True)``."""
    c = _sb_setup(16)
    n, kw = c["n"], dict(iter_max=300, iter_min=300, nout=100, visc_plastic_tau=True)
    bc = c["bc"]
    jst = serialization.from_state_dict(JStokesState.make((n, n)), c["state"])
    jmat = jm.MaterialStack.make([jm.Material(**m) for m in c["mats"]])
    jg = JGeometry((n, n), (1.0, 1.0))
    j_out, j_info = j_solve_vep(
        jst, JCoeffs.make(jg.li, jg.di, CFL=0.75 / math.sqrt(2.1)), jg,
        jbc.VelocityBoundaryConditions(**bc), jmat, jnp.asarray(c["pr"][0]),
        jnp.asarray(c["pr"][1]), 0.25, **kw)
    pmat = pm.MaterialStack.make([pm.Material(**m) for m in c["mats"]], device="cpu")
    g = Geometry((n, n), (1.0, 1.0))
    p_out, p_info = solve_vep(
        convert.stokes_state_from_dict(c["state"], device="cpu"),
        PTStokesCoeffs.make(g.li, g.di, CFL=0.75 / math.sqrt(2.1)), g,
        pbc.VelocityBoundaryConditions(**bc), pmat, torch.tensor(c["pr"][0]),
        torch.tensor(c["pr"][1]), 0.25, use_kernel=False, **kw)
    assert float(j_out.lam.max()) > 0.0  # the return mapping and the composite act
    sc = _model_close(p_out, j_out, g.di, skip=("viscosity.eta_v",))
    _info_close(p_info, j_info, sc["residual"], res_tol=TOL)
    live = np.abs(np.asarray(j_out.tau.xy)) > 1e-12 * sc["stress"]
    np.testing.assert_allclose(p_out.viscosity.eta_v.numpy()[live],
                               np.asarray(j_out.viscosity.eta_v)[live], rtol=TOL)
    # the variant changes the solve against the base convention
    base, _ = solve_vep(
        convert.stokes_state_from_dict(c["state"], device="cpu"),
        PTStokesCoeffs.make(g.li, g.di, CFL=0.75 / math.sqrt(2.1)), g,
        pbc.VelocityBoundaryConditions(**bc), pmat, torch.tensor(c["pr"][0]),
        torch.tensor(c["pr"][1]), 0.25, use_kernel=False, iter_max=300, iter_min=300, nout=100)
    assert float((base.viscosity.eta - p_out.viscosity.eta).abs().max()) > 1e-3


@pytest.mark.slow
def test_sinking_block_golden():
    """tests/test_more_benchmarks.py's oracle through the port."""
    stokes, info, vmax = sinking_block.run(n=32, device="cpu")
    assert float(info.err) < 1.0e-5
    assert vmax == pytest.approx(4.841885609356093e-10, rel=0.10)


@pytest.mark.slow
def test_shearband_visc_plastic_tau_golden():
    """tests/test_shearband2d.py's frozen values of the variant, through the
    port's plain path."""
    _, info, _, _, tII = shearband.run(n=32, nt=10, visc_plastic_tau=True, use_kernel=False,
                                       device="cpu")
    assert float(info.err) < 1.0e-6
    assert float(tII.min()) == pytest.approx(1.4422770, abs=1e-4)
    assert float(tII.max()) == pytest.approx(1.6643166, abs=1e-4)


def test_kernel_refusals():
    """``solve_vep(visc_plastic_tau=True)`` with the kernel asked for raises
    ``ValueError`` naming ``use_kernel=False``; the plain-by-contract models
    pass it themselves, so their defaults run on any device."""
    with pytest.raises(ValueError, match="use_kernel=False"):
        shearband.run(n=8, nt=1, visc_plastic_tau=True, use_kernel=True, device="cpu")
    assert math.isfinite(float(solvi2d.run(n=8, iter_max=100, nout=50, device="cpu")[2].err))
