"""PyTorch port, ``rheology/melting.py``: the unit checks of
tests/test_thermal_stresses.py restated for the port, and each
parameterization's ϕ and dϕ/dT, the phase-weighted melt fraction and the
melt-dependent properties against the JAX package on the same numpy
inputs, in float64, to 1e-14 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from justrelax_tpu.rheology import melting as jmelt
from justrelax_tpu_torch.rheology import melting as pmelt

torch.set_num_threads(1)

RTOL = 1e-14


def _t(x):
    return torch.tensor(np.asarray(x, dtype=np.float64))


# ---- the unit checks of tests/test_thermal_stresses.py --------------------------
def test_caricchi_limits_and_midpoint():
    m = pmelt.MeltingCaricchi()
    T = _t([400.0 + 273.15, 800.0 + 273.15, 1200.0 + 273.15])
    phi = m.phi(T)
    assert phi[0] < 1.0e-7
    assert abs(float(phi[1]) - 0.5) < 1.0e-12  # θ=0 at 800 °C
    assert phi[2] > 1.0 - 1.0e-7
    h = 1.0e-3
    fd = (m.phi(T + h) - m.phi(T - h)) / (2 * h)
    np.testing.assert_allclose(m.dphi_dT(T).numpy(), fd.numpy(), rtol=1e-4)


def test_quadratic_bounds_and_derivative():
    m = pmelt.MeltingQuadratic(Ts=1000.0, Tl=1200.0)
    phi = m.phi(_t([900.0, 1000.0, 1100.0, 1200.0, 1300.0])).numpy()
    assert phi[0] == 0.0 and phi[1] == 0.0
    assert abs(phi[2] - 0.75) < 1e-12  # 1 - (1/2)^2
    assert phi[3] == 1.0 and phi[4] == 1.0
    h = 1.0e-4
    Tin = _t([1050.0, 1150.0])
    fd = (m.phi(Tin + h) - m.phi(Tin - h)) / (2 * h)
    np.testing.assert_allclose(m.dphi_dT(Tin).numpy(), fd.numpy(), rtol=1e-6)


def test_polynomial_matches_quadratic_form():
    # ϕ = 1 − ((Tl−T)/(Tl−Ts))² expanded as a polynomial in x = T/1000
    Ts, Tl = 1000.0, 1200.0
    d = (Tl - Ts) / 1.0e3
    a, b = Tl / 1.0e3, 1.0 / d
    poly = pmelt.MeltingPolynomial(
        coeffs=(1.0 - (a * b) ** 2, 2.0 * a * b * b, -(b * b)), Ts=Ts, Tl=Tl)
    quad = pmelt.MeltingQuadratic(Ts=Ts, Tl=Tl)
    T = _t(np.linspace(900.0, 1300.0, 41))
    np.testing.assert_allclose(poly.phi(T).numpy(), quad.phi(T).numpy(), atol=1e-12)
    Tin = _t([1050.0, 1150.0])
    np.testing.assert_allclose(poly.dphi_dT(Tin).numpy(), quad.dphi_dT(Tin).numpy(), rtol=1e-10)


def test_phase_averaged_melt_fraction():
    melting = (pmelt.NoMelting(), pmelt.MeltingCaricchi())
    T = torch.full((4, 4), 1200.0 + 273.15, dtype=torch.float64)  # molten for phase 1
    ratios = torch.zeros((4, 4, 2), dtype=torch.float64)
    ratios[..., 1], ratios[..., 0] = 0.25, 0.75
    phi = pmelt.compute_melt_fraction(melting, T, phase_ratios=ratios)
    np.testing.assert_allclose(phi.numpy(), 0.25, atol=1e-6)
    with pytest.raises(ValueError):
        pmelt.compute_melt_fraction(melting, T)


def test_melt_dependent_properties():
    phi = _t([0.0, 0.5, 1.0])
    np.testing.assert_allclose(pmelt.melt_dependent_alpha(1.0e-5, 3.0e-5, phi).numpy(),
                               [1.0e-5, 2.0e-5, 3.0e-5])
    np.testing.assert_allclose(pmelt.melt_dependent_density(2700.0, 2300.0, phi).numpy(),
                               [2700.0, 2500.0, 2300.0])
    assert abs(pmelt.gas_pyroclast_alpha(1.0e-5, 1.0e-3, 0.0) - 1.0e-5) < 1e-18
    a_bf = pmelt.bubble_flow_alpha(_t(1.0e-5), _t(1.0e-3), _t(1.0e4), c0=1.0e-2, a=4.0e-6)
    assert 1.0e-5 < float(a_bf) < 1.0e-3
    a_sat = pmelt.bubble_flow_alpha(_t(1.0e-5), _t(1.0e-3), _t(1.0e10), c0=1.0e-2, a=4.0e-6)
    np.testing.assert_allclose(float(a_sat), 1.0e-5, rtol=1e-10)


# ---- against the JAX package ------------------------------------------------------
_PARAMS = {
    "none": lambda mod: mod.NoMelting(),
    "caricchi": lambda mod: mod.MeltingCaricchi(),
    "caricchi_custom": lambda mod: mod.MeltingCaricchi(a=750.0, b=30.0),
    "quadratic": lambda mod: mod.MeltingQuadratic(),
    "polynomial": lambda mod: mod.MeltingPolynomial(
        coeffs=(-4.1, 2.5, 1.3, -0.4), Ts=950.0, Tl=1350.0),
}


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * np.abs(b).max(initial=0.0))


@pytest.mark.parametrize("name", sorted(_PARAMS))
def test_parameterization_matches_jax(name):
    T = np.random.default_rng(1).uniform(800.0, 1500.0, (9, 7))
    T[0, :3] = (963.15, 1273.15, 1073.15)  # the quadratic's ends, Caricchi's midpoint
    p, j = _PARAMS[name](pmelt), _PARAMS[name](jmelt)
    _close(p.phi(_t(T)), j.phi(jnp.asarray(T)))
    _close(p.dphi_dT(_t(T)), j.dphi_dT(jnp.asarray(T)))


def test_melt_fraction_and_properties_match_jax():
    rng = np.random.default_rng(2)
    T = rng.uniform(900.0, 1500.0, (6, 5))
    r = rng.uniform(size=(6, 5, 3))
    r /= r.sum(axis=-1, keepdims=True)
    names = ("none", "caricchi", "quadratic")
    phi = pmelt.compute_melt_fraction(tuple(_PARAMS[k](pmelt) for k in names), _t(T),
                                      phase_ratios=_t(r))
    jphi = jmelt.compute_melt_fraction(tuple(_PARAMS[k](jmelt) for k in names),
                                       jnp.asarray(T), phase_ratios=jnp.asarray(r))
    _close(phi, jphi)
    _close(pmelt.compute_melt_fraction(_PARAMS["caricchi"](pmelt), _t(T)),
           jmelt.compute_melt_fraction(_PARAMS["caricchi"](jmelt), jnp.asarray(T)))
    _close(pmelt.melt_dependent_alpha(3e-5, 6e-5, phi), jmelt.melt_dependent_alpha(3e-5, 6e-5, jphi))
    _close(pmelt.melt_dependent_density(2700.0, 2300.0, phi),
           jmelt.melt_dependent_density(2700.0, 2300.0, jphi))
    delta = rng.uniform(size=(6, 5))
    _close(pmelt.gas_pyroclast_alpha(1e-5, 1e-3, _t(delta)),
           jmelt.gas_pyroclast_alpha(1e-5, 1e-3, jnp.asarray(delta)))
    P = 10.0 ** rng.uniform(2.0, 10.0, (6, 5))
    _close(pmelt.bubble_flow_alpha(1e-5, 1e-3, _t(P), c0=1e-2, a=4e-6),
           jmelt.bubble_flow_alpha(1e-5, 1e-3, jnp.asarray(P), c0=1e-2, a=4e-6))
