"""PyTorch port, rheology layer against the JAX package on the same numpy
inputs, in float64: elastic moduli, density, plastic parameters (linear and
non-linear softening, tension cap), yield function and flow gradients,
tau-mode creep viscosity (the creep-law inputs of tests/test_creep_laws.py),
the viscosity fields, and the collapsed power law of
tests/test_pallas_vep.py. Tolerance 1e-12 relative: pow/exp/sin may differ
by an ulp between the two libraries."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from justrelax_tpu.rheology import materials as jm
from justrelax_tpu.rheology import plasticity as jp
from justrelax_tpu.rheology import viscosity as jv
from justrelax_tpu_torch.rheology import materials as pm
from justrelax_tpu_torch.rheology import plasticity as pp
from justrelax_tpu_torch.rheology import viscosity as pv

torch.set_num_threads(1)

RTOL = 1e-12
C = 1.6 / np.cos(np.radians(30.0))
_PLASTIC = dict(rho0=0.0, Kb=5.0, is_plastic=1.0, C=C, friction_angle=30.0,
                dilation_angle=10.0, eta_reg=1e-2)

MATERIALS = {
    "shearband": [dict(G=1.0, **_PLASTIC), dict(G=0.5, **_PLASTIC)],
    "powerlaw": [
        dict(G=1.0, disl_A=0.4, disl_n=3.0, disl_E=1.0e3, **_PLASTIC),
        dict(G=0.5, diff_A=0.3, diff_m=1.0, grain_size=0.5, diff_E=5.0e2, **_PLASTIC),
    ],
    "softening": [
        dict(G=1.0, soft_C_active=1.0, soft_C_min=0.5, soft_phi_active=1.0,
             soft_phi_min=20.0, soft_strain_lo=0.001, soft_strain_hi=0.01, **_PLASTIC),
        dict(G=0.5, soft_C_nl=1.0, soft_C_nl_xi0=1.6, soft_C_nl_delta=0.8, **_PLASTIC),
    ],
    "cap": [dict(G=1.0, tension_pT=-0.5, **_PLASTIC), dict(G=0.0, Kb=np.nan, tension_pT=-0.3)],
    "thermal": [dict(rho0=3.3, alpha=3e-5, beta=1e-3, T0=273.0, P0=1.0, G=2.0, gravity=9.8),
                dict(rho0=2.7, alpha=2e-5, T0=273.0, G=np.inf, gravity=9.8)],
    "creep_laws": [
        dict(disl_A=1e-16, disl_n=3.5, disl_E=530e3, disl_V=14e-6),
        dict(diff_A=1.5e-15, diff_m=3.0, diff_E=375e3, diff_V=6e-6, grain_size=1e-3),
        dict(gbs_A=1e-24, gbs_n=2.9, gbs_m=0.7, gbs_E=445e3, grain_size=1e-3),
        dict(peierls_A=1.4e-19, peierls_n=2.0, peierls_E=320e3, peierls_q=1.0,
             peierls_o=0.5, peierls_tauP=5.9e9),
        dict(eta0=1.0e21),
    ],
}


def _stacks(case):
    kws = MATERIALS[case]
    return (pm.MaterialStack.make([pm.Material(**kw) for kw in kws], device="cpu"),
            jm.MaterialStack.make([jm.Material(**kw) for kw in kws]))


def _ratios(shape, nphase, seed=0):
    r = np.random.default_rng(seed).uniform(0.0, 1.0, shape + (nphase,))
    r = r / r.sum(axis=-1, keepdims=True)
    r[0, 0] = 0.0
    r[0, 0, 0] = 1.0  # one-hot cell: the dominant-phase exit
    if shape[0] > 1:
        r[1, 0] = 0.0005 / max(nphase - 1, 1)
        r[1, 0, 0] = 1.0 - 0.0005 * (nphase > 1)
    return r


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=0.0)


def _t(x):
    return None if x is None else torch.tensor(np.asarray(x))


@pytest.mark.parametrize("case", ["shearband", "cap", "thermal"])
@pytest.mark.parametrize("with_ratios", [True, False])
def test_moduli_and_density(case, with_ratios):
    p, j = _stacks(case)
    nph = len(MATERIALS[case])
    r = _ratios((5, 4), nph) if with_ratios else None
    jr = None if r is None else jnp.asarray(r)
    _close(pm.get_shear_modulus(p, _t(r)), jm.get_shear_modulus(j, jr))
    _close(pm.get_bulk_modulus(p, _t(r)), jm.get_bulk_modulus(j, jr))
    T = np.random.default_rng(5).uniform(300.0, 1600.0, (5, 4))
    P = np.random.default_rng(6).uniform(0.0, 10.0, (5, 4))
    _close(pm.compute_density(p, T=_t(T), P=_t(P), phase_ratios=_t(r)),
           jm.compute_density(j, T=jnp.asarray(T), P=jnp.asarray(P), phase_ratios=jr))
    _close(pm.compute_density(p, T=_t(T), phase_ratios=_t(r)),
           jm.compute_density(j, T=jnp.asarray(T), phase_ratios=jr))
    _close(pm.phase_average(p.params.rho0, _t(r)), jm.phase_average(j.params.rho0, jr))


def test_material_stack():
    p, _ = _stacks("shearband")
    assert p.nphase == 2 and p.dtype == torch.float64
    assert p.to(dtype=torch.float32).params.G.dtype == torch.float32
    one = pm._as_stack(pm.Material(G=3.0), torch.zeros(1, dtype=torch.float64))
    assert one.nphase == 1 and float(one.params.G[0]) == 3.0


@pytest.mark.parametrize("case", ["shearband", "softening", "cap"])
def test_plastic_params_yield_and_gradients(case):
    p, j = _stacks(case)
    rng = np.random.default_rng(7)
    EII = rng.uniform(0.0, 0.02, (6, 5))
    r = _ratios((6, 5), 2)
    P = rng.uniform(-0.6, 0.6, (6, 5))
    tII = rng.uniform(0.5, 2.5, (6, 5))
    for ratios in (r, None):
        a = pp.plastic_params_phase(p, _t(EII), _t(ratios))
        b = jp.plastic_params_phase(j, jnp.asarray(EII), None if ratios is None else jnp.asarray(ratios))
        for name, x, y in zip(a._fields, a, b):
            if name == "is_pl":
                assert np.array_equal(np.asarray(x), np.asarray(y))
            else:
                np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=RTOL, atol=1e-15)
        _close(pp.yield_function(a, _t(P), _t(tII)), jp.yield_function(b, jnp.asarray(P), jnp.asarray(tII)))
        for x, y in zip(pp.flow_gradients_P(a, _t(P), _t(tII)),
                        jp.flow_gradients_P(b, jnp.asarray(P), jnp.asarray(tII))):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=RTOL, atol=1e-15)


def test_second_invariants():
    rng = np.random.default_rng(8)
    xx, yy, xy = (rng.standard_normal((5, 4)) for _ in range(3))
    xyv = rng.standard_normal((6, 5))
    _close(pp.second_invariant(_t(xx), _t(yy), _t(xy)),
           jp.second_invariant(jnp.asarray(xx), jnp.asarray(yy), jnp.asarray(xy)))
    g = lambda A: (A[:-1, :-1], A[1:, :-1], A[:-1, 1:], A[1:, 1:])  # noqa: E731
    _close(pp.second_invariant_staggered(_t(xx), _t(yy), g(_t(xyv))),
           jp.second_invariant_staggered(jnp.asarray(xx), jnp.asarray(yy), g(jnp.asarray(xyv))))


@pytest.mark.parametrize("case", ["creep_laws", "powerlaw", "shearband"])
@pytest.mark.parametrize("with_T", [True, False])
def test_phase_viscosity_tau(case, with_T):
    p, j = _stacks(case)
    nph = len(MATERIALS[case])
    rng = np.random.default_rng(9)
    tau = 10.0 ** rng.uniform(-3.0, 9.5, (6, 5))
    tau[0, 1] = 0.0  # the tiny floor
    T = rng.uniform(600.0, 1700.0, (6, 5)) if with_T else None
    P = rng.uniform(0.0, 3e9, (6, 5))
    r = _ratios((6, 5), nph)
    for ratios in (r, None):
        for Pin in (P, None):
            a = pv.phase_viscosity(p, _t(tau), _t(T), _t(ratios), "tau", P=_t(Pin))
            b = jv.phase_viscosity(j, jnp.asarray(tau), None if T is None else jnp.asarray(T),
                                   None if ratios is None else jnp.asarray(ratios), "tau",
                                   P=None if Pin is None else jnp.asarray(Pin))
            _close(a, b)


def test_shared_powerlaw_exponent():
    for case in MATERIALS:
        p, j = _stacks(case)
        assert pv.shared_powerlaw_exponent(p) == jv.shared_powerlaw_exponent(j)
    mixed = [dict(disl_A=0.5, disl_n=3.0), dict(disl_A=0.5, disl_n=2.0)]
    assert pv.shared_powerlaw_exponent(pm.MaterialStack.make([pm.Material(**k) for k in mixed], device="cpu")) is None
    diff_only = [dict(diff_A=0.3), dict()]
    assert pv.shared_powerlaw_exponent(pm.MaterialStack.make([pm.Material(**k) for k in diff_only], device="cpu")) == 0.0


@pytest.mark.parametrize("with_T", [True, False])
def test_powerlaw_recip_coeffs(with_T):
    """Inputs of tests/test_pallas_vep.py::test_powerlaw_recip_coeffs_match_phase_viscosity."""
    p, j = _stacks("powerlaw")
    rng = np.random.default_rng(0)
    ni = (6, 5)
    r0 = rng.uniform(0.0, 1.0, ni)
    r0[0, 0] = 0.9995
    ratios = np.stack([r0, 1.0 - r0], axis=-1)
    T = 250.0 + 100.0 * rng.uniform(size=ni) if with_T else None
    for rr in (ratios, None):
        a = pv.powerlaw_recip_coeffs(p, torch.ones(ni, dtype=torch.float64), _t(T), _t(rr))
        b = jv.powerlaw_recip_coeffs(j, jnp.ones(ni), None if T is None else jnp.asarray(T),
                                     None if rr is None else jnp.asarray(rr))
        for x, y in zip(a, b):
            _close(x, y)
    m = pv.shared_powerlaw_exponent(p)
    A, B = pv.powerlaw_recip_coeffs(p, torch.ones(ni, dtype=torch.float64), _t(T), _t(ratios))
    for tau in (1.0e-3, 0.7, 13.0):
        eta = pv.phase_viscosity(p, torch.full(ni, tau, dtype=torch.float64), _t(T), _t(ratios), "tau")
        _close(1.0 / (A + B * tau**m), eta)


@pytest.mark.parametrize("case", ["shearband", "powerlaw"])
def test_compute_viscosity_fields(case):
    p, j = _stacks(case)
    rng = np.random.default_rng(10)
    n = 6
    rc, rv = _ratios((n, n), 2), _ratios((n + 1, n + 1), 2, seed=1)
    xx, yy, xyc = (rng.standard_normal((n, n)) for _ in range(3))
    xx[1, 1] = yy[1, 1] = xyc[1, 1] = 0.0  # the ε jitter
    xyv = rng.standard_normal((n + 1, n + 1))
    zv = np.zeros((n + 1, n + 1))
    eta, eta_v = rng.uniform(0.5, 2.0, (n, n)), rng.uniform(0.5, 2.0, (n + 1, n + 1))
    T = rng.uniform(250.0, 350.0, (n, n))
    Tv = rng.uniform(250.0, 350.0, (n + 1, n + 1))
    kw = dict(relaxation=0.3, cutoff=(0.8, 1.5))
    a = pv.compute_viscosity_fields(_t(eta), _t(eta_v), p, _t(xx), _t(yy), _t(xyc),
                                    _t(zv), _t(zv), _t(xyv), _t(rc), _t(rv),
                                    T=_t(T), T_v=_t(Tv), mode="tau", **kw)
    J = jnp.asarray
    b = jv.compute_viscosity_fields(J(eta), J(eta_v), j, J(xx), J(yy), J(xyc), J(zv), J(zv),
                                    J(xyv), J(rc), J(rv), T=J(T), T_v=J(Tv), mode="tau", **kw)
    for x, y in zip(a, b):
        _close(x, y)
    with pytest.raises(NotImplementedError):
        pv.phase_viscosity(p, _t(xx), None, None, "eps")
