"""The port's 2D PT loops against JAX's at their edges, on the CPU in float64:

- ``solve_vep`` when ``iter_min`` asks for more chunks than ``iter_max``
  allows: JAX runs ``min_chunks`` chunks and its clamped dynamic update keeps
  the last chunk's norms in the history's last row;
- ``solve_vep`` and ``solve_ve`` on a state whose first residual is exactly
  0: JAX takes err/err₁ = 0/0 = nan, which is not above ϵ_rel, and stops
  after the chunks it must run;
- ``heatdiffusion_PT`` on the same two edges (its loop has no ``iter_min``
  and no ratio: it stops where err ≤ ϵ, and at ``iter_max`` rounded up to a
  chunk).

Iteration counts are equal; residual histories and fields within 1e-10.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from justrelax_tpu.core.coeffs import PTStokesCoeffs as JCoeffs
from justrelax_tpu.core.coeffs import PTThermalCoeffs as JThermalCoeffs
from justrelax_tpu.core.grid import Geometry as JGeometry
from justrelax_tpu.core.state import StokesState as JStokesState
from justrelax_tpu.core.state import ThermalState as JThermalState
from justrelax_tpu.ops import bc as jbc
from justrelax_tpu.rheology import materials as jm
from justrelax_tpu.solvers.stokes2d import solve_ve as j_solve_ve
from justrelax_tpu.solvers.stokes2d_vep import solve_vep as j_solve_vep
from justrelax_tpu.solvers.thermal import heatdiffusion_PT as j_heatdiffusion_PT
from justrelax_tpu_torch import convert
from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs, PTThermalCoeffs
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.core.state import StokesState, ThermalState
from justrelax_tpu_torch.ops import bc as pbc
from justrelax_tpu_torch.rheology import materials as pm
from justrelax_tpu_torch.solvers.stokes2d import _ratio, solve_ve
from justrelax_tpu_torch.solvers.stokes2d_vep import solve_vep
from justrelax_tpu_torch.solvers.thermal import heatdiffusion_PT
from test_torch_shearband import _flat, _setup

torch.set_num_threads(1)

TOL = 1e-10


def _fields_close(p_state, j_state):
    a = _flat(convert.to_state_dict(p_state))
    b = _flat(serialization.to_state_dict(j_state))
    assert a.keys() == b.keys()
    for k in a:
        scale = max(float(np.abs(b[k]).max(initial=0.0)), 1.0)
        assert np.abs(a[k] - b[k]).max(initial=0.0) <= TOL * scale, k


def _history_close(p_hist, j_hist):
    p, j = p_hist.numpy(), np.asarray(j_hist)
    assert p.shape == j.shape
    assert np.array_equal(np.isnan(p), np.isnan(j))
    np.testing.assert_allclose(p[~np.isnan(p)], j[~np.isnan(j)], rtol=TOL, atol=0.0)


def _vep_pair(c, kw, use_kernel, zero=False):
    """The JAX and the port's ``solve_vep`` on the inputs of ``c``
    (``_setup``), or on a zero state with those materials."""
    n = c["n"]
    ni = (n, n)
    jst = JStokesState.make(ni) if zero else serialization.from_state_dict(
        JStokesState.make(ni), c["state"])
    jmat = jm.MaterialStack.make([jm.Material(**m) for m in c["mats"]])
    jg = JGeometry(ni, (1.0, 1.0))
    jpt = JCoeffs.make(jg.li, jg.di, CFL=0.75 / math.sqrt(2.1))
    j_out, j_info = j_solve_vep(
        jst, jpt, jg, jbc.VelocityBoundaryConditions(**c["bc"]), jmat,
        jnp.asarray(c["pr"][0]), jnp.asarray(c["pr"][1]), 0.25, **kw)

    pst = (StokesState.make(ni, device="cpu") if zero
           else convert.stokes_state_from_dict(c["state"], device="cpu"))
    pmat = pm.MaterialStack.make([pm.Material(**m) for m in c["mats"]], device="cpu")
    g = Geometry(ni, (1.0, 1.0))
    pt = PTStokesCoeffs.make(g.li, g.di, CFL=0.75 / math.sqrt(2.1))
    p_out, p_info = solve_vep(
        pst, pt, g, pbc.VelocityBoundaryConditions(**c["bc"]), pmat,
        torch.tensor(c["pr"][0]), torch.tensor(c["pr"][1]), 0.25,
        use_kernel=use_kernel, **kw)
    return (p_out, p_info), (j_out, j_info)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("kw,iters", [(dict(iter_max=20, iter_min=40, nout=10), 40),
                                      (dict(iter_max=20, nout=10), 100)],
                         ids=["iter_min_40", "iter_min_default"])
def test_solve_vep_iter_min_past_iter_max(kw, iters, use_kernel):
    """``iter_min`` above ``iter_max``: the port runs JAX's chunk count and
    keeps the last chunks' norms in the history's last row."""
    (p_out, p_info), (j_out, j_info) = _vep_pair(_setup(8), kw, use_kernel)
    assert p_info.iters == int(j_info.iters) == iters
    assert p_info.err_history.shape == (2,)
    _history_close(p_info.err_history, j_info.err_history)
    np.testing.assert_allclose(float(p_info.err), float(j_info.err), rtol=TOL)
    _fields_close(p_out, j_out)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_solve_vep_zero_first_residual(use_kernel):
    """A state at rest with no body force: the first residual is exactly 0,
    err/err₁ is nan, and the loop stops once ``iter_min`` is met."""
    c = _setup(8)
    (p_out, p_info), (j_out, j_info) = _vep_pair(
        c, dict(iter_max=20, iter_min=10, nout=10), use_kernel, zero=True)
    assert p_info.iters == int(j_info.iters) == 10
    assert float(p_info.err) == float(j_info.err) == 0.0
    _history_close(p_info.err_history, j_info.err_history)
    _fields_close(p_out, j_out)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_solve_ve_zero_first_residual(use_kernel):
    """``solve_ve`` on a zero state with zero ρg, G = 1, K = 5 and dt = ∞:
    one chunk, err 0."""
    ni = (8, 8)
    bc = dict(free_slip=dict(left=True, right=True, top=True, bot=True))
    kw = dict(iter_max=20, nout=10)
    z, G, K = np.zeros(ni), np.ones(ni), np.full(ni, 5.0)
    jg = JGeometry(ni, (1.0, 1.0))
    jpt = JCoeffs.make(jg.li, jg.di)
    j_out, j_info = j_solve_ve(JStokesState.make(ni), jpt, jg,
                               jbc.VelocityBoundaryConditions(**bc),
                               (jnp.asarray(z), jnp.asarray(z)), jnp.asarray(G),
                               jnp.asarray(K), math.inf, **kw)
    g = Geometry(ni, (1.0, 1.0))
    pt = PTStokesCoeffs.make(g.li, g.di)
    t = torch.as_tensor
    p_out, p_info = solve_ve(StokesState.make(ni, device="cpu"), pt, g,
                             pbc.VelocityBoundaryConditions(**bc), (t(z), t(z)), t(G), t(K),
                             math.inf, use_kernel=use_kernel, **kw)
    assert p_info.iters == int(j_info.iters) == 10
    assert float(p_info.err) == float(j_info.err) == 0.0
    _history_close(p_info.err_history, j_info.err_history)
    _fields_close(p_out, j_out)


@pytest.mark.parametrize("err,err1,want", [(0.0, 0.0, math.nan), (math.nan, 0.0, math.nan),
                                           (2.0, 0.0, math.inf), (-2.0, 0.0, -math.inf),
                                           (1.0, 4.0, 0.25)])
def test_ratio_is_ieee(err, err1, want):
    """The loops' err/err₁ is numpy's float64 division."""
    with np.errstate(divide="ignore", invalid="ignore"):
        assert np.array_equal(np.float64(err) / np.float64(err1), want, equal_nan=True)
    assert np.array_equal(_ratio(err, err1), want, equal_nan=True)


def _thermal_pair(T0, kw, use_kernel):
    """Both ``heatdiffusion_PT`` from ``T0`` with K = ρCp = 1, T = 0 at the
    top and bottom and no flux through the sides."""
    ni = tuple(s - 2 for s in T0.shape)
    bc = dict(no_flux=dict(left=True, right=True), constant_value=dict(top=0.0, bot=0.0))
    one = np.ones(ni)
    jg = JGeometry(ni, (1.0, 1.0))
    jth = JThermalState.make(ni).replace(T=jnp.asarray(T0), Told=jnp.asarray(T0))
    jpt = JThermalCoeffs.make(jnp.asarray(one), jnp.asarray(one), 0.3, jg.di, jg.li)
    j_out, j_info = j_heatdiffusion_PT(jth, jpt, jbc.TemperatureBoundaryConditions(**bc), 0.3, jg,
                                       K=jnp.asarray(one), rho_Cp=jnp.asarray(one), **kw)
    g = Geometry(ni, (1.0, 1.0))
    t = torch.as_tensor
    th = ThermalState.make(ni, device="cpu").replace(T=t(T0), Told=t(T0))
    pt = PTThermalCoeffs.make(t(one), t(one), 0.3, g.di, g.li)
    p_out, p_info = heatdiffusion_PT(th, pt, pbc.TemperatureBoundaryConditions(**bc), 0.3, g,
                                     K=t(one), rho_Cp=t(one), use_kernel=use_kernel, **kw)
    return (p_out, p_info), (j_out, j_info)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_heatdiffusion_zero_first_residual(use_kernel):
    """T = 0 everywhere: the first residual is 0, and both loops stop after
    one chunk."""
    (p_out, p_info), (j_out, j_info) = _thermal_pair(
        np.zeros((10, 10)), dict(iter_max=40, nout=10), use_kernel)
    assert p_info.iters == int(j_info.iters) == 10
    assert float(p_info.err) == float(j_info.err) == 0.0
    _history_close(p_info.err_history, j_info.err_history)
    _fields_close(p_out, j_out)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_heatdiffusion_iter_max_below_nout(use_kernel):
    """``iter_max`` below ``nout``: both loops run one whole chunk."""
    T0 = np.random.default_rng(3).random((10, 10))
    (p_out, p_info), (j_out, j_info) = _thermal_pair(T0, dict(iter_max=5, nout=10), use_kernel)
    assert p_info.iters == int(j_info.iters) == 10
    assert float(p_info.err) > 0.0
    _history_close(p_info.err_history, j_info.err_history)
    _fields_close(p_out, j_out)
