"""PyTorch port, the strain-rate ("eps") mode of ``rheology/viscosity.py``
against the JAX package on the same numpy inputs, in float64:

- ``phase_viscosity(..., "eps")`` per mechanism (dislocation, diffusion,
  grain-boundary sliding, Peierls with its fixed 30-step Newton inversion)
  and with all four active in one phase at once, with and without T, P and
  phase ratios, to 1e-12 relative;
- ``compute_viscosity_fields`` with ``mode`` left out (both packages
  default to "eps") and with ``plastic_in_tau=True`` in "tau" mode, to
  1e-13 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from justrelax_tpu.rheology import materials as jm
from justrelax_tpu.rheology import viscosity as jv
from justrelax_tpu_torch.rheology import materials as pm
from justrelax_tpu_torch.rheology import viscosity as pv

torch.set_num_threads(1)

DISL = dict(disl_A=1e-16, disl_n=3.5, disl_E=530e3, disl_V=14e-6)
DIFF = dict(diff_A=1.5e-15, diff_m=3.0, diff_E=375e3, diff_V=6e-6, grain_size=1e-3)
GBS = dict(gbs_A=1e-24, gbs_n=2.9, gbs_m=0.7, gbs_E=445e3, gbs_V=3e-6, grain_size=1e-3)
PEIERLS = dict(peierls_A=1.4e-19, peierls_n=2.0, peierls_E=320e3, peierls_q=1.0,
               peierls_o=0.5, peierls_tauP=5.9e9)
PEIERLS_Q2 = dict(peierls_A=5.7e-11, peierls_n=2.0, peierls_E=540e3, peierls_q=2.0,
                  peierls_o=1.0, peierls_tauP=8.5e9)

MATERIALS = {
    "disl": [DISL, dict(eta0=1e21)],
    "diff": [DIFF, dict(eta0=1e21)],
    "gbs": [GBS, dict(eta0=1e21)],
    "peierls": [PEIERLS, PEIERLS_Q2],
    "peierls_no_barrier": [dict(PEIERLS, peierls_tauP=np.inf), dict(eta0=1e21)],
    # every mechanism at once in one phase, beside another mix and a linear phase
    "all_four": [{**DISL, **DIFF, **GBS, **PEIERLS},
                 dict(disl_A=3.2e-20, disl_n=3.0, disl_E=276e3, **PEIERLS_Q2),
                 dict(eta0=1e22)],
    "shearheating": [dict(disl_A=3.2e-20, disl_n=3.0, disl_E=276.0e3),
                     dict(disl_A=3.16e-26, disl_n=3.3, disl_E=186.0e3)],
}
NI = (7, 6)


def _stacks(case):
    kws = MATERIALS[case]
    return (pm.MaterialStack.make([pm.Material(**kw) for kw in kws], device="cpu"),
            jm.MaterialStack.make([jm.Material(**kw) for kw in kws]))


def _ratios(shape, nphase, seed=0):
    r = np.random.default_rng(seed).uniform(0.0, 1.0, shape + (nphase,))
    r = r / r.sum(axis=-1, keepdims=True)
    r[0, 0] = 0.0
    r[0, 0, 0] = 1.0  # one-hot cell: the dominant-phase exit
    return r


def _t(x):
    return None if x is None else torch.tensor(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.all(np.isfinite(b))
    np.testing.assert_allclose(a, b, rtol=rtol, atol=0.0)


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    eps = 10.0 ** rng.uniform(-18.0, -10.0, NI)
    eps[0, 1] = 0.0  # the tiny floor
    T = rng.uniform(600.0, 1700.0, NI)
    P = rng.uniform(0.0, 3e9, NI)
    return eps, T, P


@pytest.mark.parametrize("case", sorted(MATERIALS))
@pytest.mark.parametrize("with_T", [True, False])
def test_phase_viscosity_eps(case, with_T):
    p, j = _stacks(case)
    eps, T, P = _inputs()
    T = T if with_T else None
    r = _ratios(NI, len(MATERIALS[case]))
    for ratios in (r, None):
        for Pin in (P, None):
            a = pv.phase_viscosity(p, _t(eps), _t(T), _t(ratios), "eps", P=_t(Pin))
            b = jv.phase_viscosity(j, _j(eps), _j(T), _j(ratios), "eps", P=_j(Pin))
            _close(a, b, 1e-12)


def test_peierls_newton_is_active():
    """The all-four material's Peierls element takes part: dropping it
    changes the viscosity where it dominates, and its stress stays below the
    barrier τP after the 30 Newton steps."""
    p, _ = _stacks("all_four")
    eps, T, _ = _inputs()
    no_pei = pm.MaterialStack.make([pm.Material(**{**DISL, **DIFF, **GBS})], device="cpu")
    first = pm.MaterialStack.make([pm.Material(**MATERIALS["all_four"][0])], device="cpu")
    a = pv.phase_viscosity(first, _t(eps), _t(T), None, "eps")
    b = pv.phase_viscosity(no_pei, _t(eps), _t(T), None, "eps")
    assert bool((a < b).any())
    pei = pm.MaterialStack.make([pm.Material(**PEIERLS)], device="cpu")
    tau = 2.0 * pv.phase_viscosity(pei, _t(eps), _t(T), None, "eps") * _t(eps).clamp_min(1e-300)
    assert float(tau.max()) < PEIERLS["peierls_tauP"]
    with pytest.raises(ValueError):
        pv.phase_viscosity(p, _t(eps), None, None, "strain")


def _tensor_fields(seed=4, scale=1e-14):
    rng = np.random.default_rng(seed)
    nx, ny = NI
    xx, yy, xyc = (scale * rng.standard_normal(NI) for _ in range(3))
    xx[1, 1] = yy[1, 1] = xyc[1, 1] = 0.0  # the ε jitter
    xyv = scale * rng.standard_normal((nx + 1, ny + 1))
    zv = np.zeros((nx + 1, ny + 1))
    eta = rng.uniform(0.5, 2.0, NI) * 1e21
    eta_v = rng.uniform(0.5, 2.0, (nx + 1, ny + 1)) * 1e21
    T = rng.uniform(600.0, 1400.0, NI)
    Tv = rng.uniform(600.0, 1400.0, (nx + 1, ny + 1))
    return xx, yy, xyc, xyv, zv, eta, eta_v, T, Tv


@pytest.mark.parametrize("case", ["all_four", "shearheating"])
def test_compute_viscosity_fields_default_mode(case):
    """``mode`` left out: both packages evaluate the strain-rate mode."""
    p, j = _stacks(case)
    xx, yy, xyc, xyv, zv, eta, eta_v, T, Tv = _tensor_fields()
    nph = len(MATERIALS[case])
    rc, rv = _ratios(NI, nph), _ratios((NI[0] + 1, NI[1] + 1), nph, seed=1)
    kw = dict(relaxation=0.3, cutoff=(1e18, 1e24))
    a = pv.compute_viscosity_fields(_t(eta), _t(eta_v), p, _t(xx), _t(yy), _t(xyc),
                                    _t(zv), _t(zv), _t(xyv), _t(rc), _t(rv),
                                    T=_t(T), T_v=_t(Tv), **kw)
    b = jv.compute_viscosity_fields(_j(eta), _j(eta_v), j, _j(xx), _j(yy), _j(xyc), _j(zv),
                                    _j(zv), _j(xyv), _j(rc), _j(rv), T=_j(T), T_v=_j(Tv), **kw)
    for x, y in zip(a, b):
        _close(x, y, 1e-13)


C = 1.6 / np.cos(np.radians(30.0))
_PLASTIC = dict(rho0=0.0, Kb=5.0, is_plastic=1.0, C=C, friction_angle=30.0,
                dilation_angle=10.0, eta_reg=1e-2)
PLASTIC = {
    "shearband": [dict(G=1.0, eta0=1.0, **_PLASTIC), dict(G=0.5, eta0=1.0, **_PLASTIC)],
    "powerlaw": [dict(G=1.0, disl_A=0.4, disl_n=3.0, **_PLASTIC),
                 dict(G=0.5, eta0=2.0)],
}


@pytest.mark.parametrize("case", sorted(PLASTIC))
def test_compute_viscosity_fields_plastic_in_tau(case):
    kws = PLASTIC[case]
    p = pm.MaterialStack.make([pm.Material(**kw) for kw in kws], device="cpu")
    j = jm.MaterialStack.make([jm.Material(**kw) for kw in kws])
    rng = np.random.default_rng(11)
    xx, yy, xyc, xyv, zv, eta, eta_v, _, _ = _tensor_fields(scale=1.5)
    eta, eta_v = eta * 1e-21, eta_v * 1e-21
    P = rng.uniform(-0.5, 0.5, NI)
    P_v = rng.uniform(-0.5, 0.5, (NI[0] + 1, NI[1] + 1))
    rc, rv = _ratios(NI, 2), _ratios((NI[0] + 1, NI[1] + 1), 2, seed=1)
    kw = dict(mode="tau", relaxation=0.4, plastic_in_tau=True)
    a = pv.compute_viscosity_fields(_t(eta), _t(eta_v), p, _t(xx), _t(yy), _t(xyc),
                                    _t(zv), _t(zv), _t(xyv), _t(rc), _t(rv),
                                    P=_t(P), P_v=_t(P_v), **kw)
    b = jv.compute_viscosity_fields(_j(eta), _j(eta_v), j, _j(xx), _j(yy), _j(xyc), _j(zv),
                                    _j(zv), _j(xyv), _j(rc), _j(rv), P=_j(P), P_v=_j(P_v), **kw)
    for x, y in zip(a, b):
        _close(x, y, 1e-13)
    # the plastic element takes part: it lowers η where a cell yields
    c = pv.compute_viscosity_fields(_t(eta), _t(eta_v), p, _t(xx), _t(yy), _t(xyc),
                                    _t(zv), _t(zv), _t(xyv), _t(rc), _t(rv),
                                    P=_t(P), P_v=_t(P_v), mode="tau", relaxation=0.4)
    assert bool((a[0] < c[0]).any())
