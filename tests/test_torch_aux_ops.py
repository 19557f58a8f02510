"""PyTorch port, the small modules against the JAX package on the CPU in
float64: nondimensionalization (tests/test_units.py), the displacement
conversion (tests/test_displacement.py), principal stresses, stress
rotation and vorticity (tests/test_aux_physics.py:39-93,
tests/test_aux_components.py:38-108), the tension cap and the
Drucker-Prager cap gradients (tests/test_aux_physics.py:217,
tests/test_aux_components.py:111-164), ``free_surface_vy``
(tests/test_aux_components.py:167-194), the creep presets,
``continuation_log``, ``correct_phase_ratio`` and the ``air_phase`` blend,
and the explicit thermal solver on uniform grids
(tests/test_thermal_explicit.py). Each holds the port to the JAX function
on the same inputs, at 1e-15 of the output's max (elementwise) or 1e-12
(the time loops), beside the JAX tests' own analytic checks.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from justrelax_tpu.core.grid import Geometry as JGeometry
from justrelax_tpu.core.state import StokesState as JStokesState
from justrelax_tpu.core.state import ThermalState as JThermalState
from justrelax_tpu.ops import bc as jbc
from justrelax_tpu.ops import displacement as jdisp
from justrelax_tpu.ops import principal_stresses as jps
from justrelax_tpu.ops import stress_rotation as jrot
from justrelax_tpu.rheology import materials as jm
from justrelax_tpu.rheology import plasticity as jpl
from justrelax_tpu.rheology import viscosity as jvisc
from justrelax_tpu.solvers import thermal_explicit as jte
from justrelax_tpu.utils import units as junits
from justrelax_tpu_torch import convert
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.core.state import StokesState
from justrelax_tpu_torch.ops import bc as pbc
from justrelax_tpu_torch.ops import displacement as pdisp
from justrelax_tpu_torch.ops import principal_stresses as pps
from justrelax_tpu_torch.ops import stress_rotation as prot
from justrelax_tpu_torch.rheology import materials as pm
from justrelax_tpu_torch.rheology import plasticity as ppl
from justrelax_tpu_torch.rheology import viscosity as pvisc
from justrelax_tpu_torch.solvers import thermal_explicit as pte
from justrelax_tpu_torch.utils import units as punits

torch.set_num_threads(1)
T = torch.as_tensor


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    d = np.abs(a - b).max(initial=0.0)
    return 0.0 if d == 0.0 else d / np.abs(b).max()


def _all_close(pa, ja, tol=1e-15):
    for a, b in zip(pa, ja, strict=True):
        assert _rel(a, b) <= tol


# --- units ----------------------------------------------------------------------
def test_units_match_jax():
    for kw in (dict(), dict(length=10.0e3, temperature=1000.0, viscosity=1.0e20, stress=10.0e6),
               dict(length=20.0e3, viscosity=1.0e21, temperature=1.0e3)):
        pu, ju = punits.geo_units(**kw), junits.geo_units(**kw)
        assert pu.time == ju.time and pu.mass == ju.mass
        for q in punits._DIMS:
            assert pu.scale(q) == ju.scale(q), q
            for v in (2.5e8, np.linspace(1.0, 5.0, 7) * 9.81):
                nd = punits.nondimensionalize(v, q, pu)
                np.testing.assert_array_equal(nd, junits.nondimensionalize(v, q, ju))
                np.testing.assert_array_equal(punits.dimensionalize(nd, q, pu),
                                              junits.dimensionalize(nd, q, ju))
    u = punits.geo_units(length=10.0e3, temperature=1000.0, viscosity=1.0e20, stress=10.0e6)
    np.testing.assert_allclose(u.time, 1.0e20 / 1.0e7)
    np.testing.assert_allclose(u.scale("density") * u.length**2 / u.time**2, 1.0e7)
    np.testing.assert_allclose(
        u.scale("conductivity"),
        u.scale("density") * u.scale("heat_capacity") * u.scale("diffusivity"), rtol=1e-12)
    assert 1.0 <= punits.nondimensionalize(1.0e21, "viscosity", punits.geo_units()) <= 100.0
    with pytest.raises(KeyError, match="unknown quantity"):
        punits.nondimensionalize(1.0, "flux_capacitance", u)


# --- displacement ---------------------------------------------------------------
def test_displacement_conversion_matches_jax():
    js = JStokesState.make((6, 5))
    V = js.V.replace(Vx=jnp.arange(7 * 7, dtype=float).reshape(7, 7), Vy=jnp.ones((8, 6)))
    js = js.replace(V=V)
    ps = convert.stokes_state_from_dict(serialization.to_state_dict(js), device="cpu")
    dt = 0.25
    js, ps = jdisp.velocity2displacement(js, dt), pdisp.velocity2displacement(ps, dt)
    np.testing.assert_array_equal(ps.U.Ux.numpy(), np.asarray(js.U.Ux))
    np.testing.assert_array_equal(ps.U.Ux.numpy(), np.asarray(V.Vx) * dt)
    js2 = js.replace(V=js.V.replace(Vx=jnp.zeros((7, 7)), Vy=jnp.zeros((8, 6))))
    ps2 = ps.replace(V=ps.V.replace(Vx=torch.zeros(7, 7, dtype=torch.float64),
                                    Vy=torch.zeros(8, 6, dtype=torch.float64)))
    for jb, pb in ((jbc.DisplacementBoundaryConditions(free_slip=jbc.Faces(left=True)),
                    pbc.DisplacementBoundaryConditions(free_slip=pbc.Faces(left=True))),
                   (None, None)):
        j3, p3 = jdisp.displacement2velocity(js2, dt, jb), pdisp.displacement2velocity(ps2, dt, pb)
        np.testing.assert_array_equal(p3.V.Vx.numpy(), np.asarray(j3.V.Vx))
        np.testing.assert_array_equal(p3.V.Vx.numpy(), np.asarray(V.Vx))
    # velocity-BC problems are left untouched
    p4 = pdisp.displacement2velocity(
        ps2, dt, pbc.VelocityBoundaryConditions(free_slip=pbc.Faces(left=True)))
    assert float(p4.V.Vx.abs().max()) == 0.0
    # the displacement BCs act as the velocity BCs on U
    fs, ns = dict(left=True, bot=True), dict(top=True, right=True)
    U = (torch.rand(7, 7, dtype=torch.float64), torch.rand(8, 6, dtype=torch.float64))
    a = pbc.flow_bcs(U, pbc.DisplacementBoundaryConditions(free_slip=fs, no_slip=ns))
    b = jbc.flow_bcs(tuple(jnp.asarray(u.numpy()) for u in U),
                     jbc.DisplacementBoundaryConditions(free_slip=jbc.Faces(**fs),
                                                        no_slip=jbc.Faces(**ns)))
    _all_close(a, b, 0.0)


# --- principal stresses, rotation, vorticity ------------------------------------
def test_principal_stresses_match_jax():
    rng = np.random.default_rng(0)
    c2 = rng.normal(size=(3, 6, 5))
    pa, ja = pps.principal_stresses_2d(*map(T, c2)), jps.principal_stresses_2d(*map(jnp.asarray, c2))
    _all_close(pa, ja)
    p1 = pps.principal_stresses_2d(T([[2.0]]), T([[-2.0]]), T([[0.0]]))
    assert float(p1.sigma1[0, 0, 0]) == pytest.approx(np.sqrt(8.0))
    assert float(p1.sigma2[1, 0, 0]) == pytest.approx(-np.sqrt(8.0))

    c3 = rng.normal(size=(6, 3, 4, 2))
    pa, ja = pps.principal_stresses_3d(*map(T, c3)), jps.principal_stresses_3d(*map(jnp.asarray, c3))
    for a, b in zip(pa, ja):  # eigenvectors up to sign
        a, b = a.numpy(), np.asarray(b)
        sign = np.sign((a * b).sum(axis=0, keepdims=True))
        assert np.abs(a * sign - b).max() <= 1e-12 * np.abs(b).max()
    ni = (2, 2, 2)
    z = torch.zeros(ni, dtype=torch.float64)
    f = dict(dtype=torch.float64)
    ps = pps.principal_stresses_3d(torch.full(ni, 3.0, **f), torch.full(ni, 2.0, **f),
                                   torch.full(ni, 1.0, **f), z, z, z)
    np.testing.assert_allclose(ps.sigma1[0].abs().numpy(), 3.0, atol=1e-12)
    np.testing.assert_allclose(ps.sigma3[2].abs().numpy(), 1.0, atol=1e-12)


def test_stress_rotation_matches_jax():
    rng = np.random.default_rng(1)
    t3 = rng.normal(size=(3, 7))
    w = rng.normal(size=7)
    for dt in (1e-3, 0.3):
        _all_close(prot.rotate_stress_particles_2d(*map(T, t3), T(w), dt),
                   jrot.rotate_stress_particles_2d(*map(jnp.asarray, t3), jnp.asarray(w), dt))
        _all_close(prot.rotate_stress_grid_2d(*map(T, t3), T(w), dt),
                   jrot.rotate_stress_grid_2d(*map(jnp.asarray, t3), jnp.asarray(w), dt))
    t6 = rng.normal(size=(6, 7))
    w3 = rng.normal(size=(3, 7))
    _all_close(prot.rotate_stress_particles_3d(*map(T, t6), *map(T, w3), dt=0.7),
               jrot.rotate_stress_particles_3d(*map(jnp.asarray, t6), *map(jnp.asarray, w3),
                                               dt=0.7))
    # invariants kept, 3D reduces to 2D (tests/test_aux_components.py)
    out = torch.stack(prot.rotate_stress_particles_3d(*map(T, t6), *map(T, w3), dt=0.7)).numpy()

    def j2(c):
        xx, yy, zz, yz, xz, xy = c
        return 0.5 * (xx**2 + yy**2 + zz**2) + yz**2 + xz**2 + xy**2

    np.testing.assert_allclose(j2(out), j2(t6), rtol=1e-12)
    z = T(np.zeros(7))
    xx2, yy2, xy2 = prot.rotate_stress_particles_2d(*map(T, t3), T(w), 0.3)
    r3 = prot.rotate_stress_particles_3d(T(t3[0]), T(t3[1]), T(-(t3[0] + t3[1])), z, z, T(t3[2]),
                                         z, z, T(w), 0.3)
    np.testing.assert_allclose(r3[0].numpy(), xx2.numpy(), atol=1e-12)
    np.testing.assert_allclose(r3[5].numpy(), xy2.numpy(), atol=1e-12)
    np.testing.assert_allclose(r3[3].numpy(), 0.0, atol=1e-12)


def test_vorticity_center_matches_jax():
    g = JGeometry((8, 8), (1.0, 1.0))
    w0 = 0.7
    Vx = -w0 * np.asarray(g.xi_vel[0][1])[None, :] * np.ones((9, 1))
    Vy = w0 * np.asarray(g.xi_vel[1][0])[:, None] * np.ones((1, 9))
    pw = prot.compute_vorticity_center(T(Vx), T(Vy), 8.0, 8.0)
    np.testing.assert_allclose(pw.numpy(), w0, atol=1e-12)
    rng = np.random.default_rng(2)
    Vx, Vy = rng.normal(size=(9, 10)), rng.normal(size=(10, 9))
    assert _rel(prot.compute_vorticity_center(T(Vx), T(Vy), 8.0, 7.0),
                jrot.compute_vorticity_center(jnp.asarray(Vx), jnp.asarray(Vy), 8.0, 7.0)) <= 1e-15


# --- plasticity -----------------------------------------------------------------
def _pp(mod, sinphi=0.5, sinpsi=0.1):
    one = torch.tensor(1.0, dtype=torch.float64) if mod is ppl else jnp.asarray(1.0)
    return mod.PlasticParams(
        is_pl=one > 0, pl_frac=one, C_cosphi=one * 0.866, sinphi=one * sinphi,
        cosphi=one * 0.866, sinpsi=one * sinpsi, eta_reg=one * 0.0, pT=one * 0.0, dq_shear=one)


def test_cap_gradients_match_jax():
    rng = np.random.default_rng(4)
    t3 = rng.normal(size=(3, 40))
    tII = np.sqrt(0.5 * (t3[0] ** 2 + t3[1] ** 2) + t3[2] ** 2)
    P = rng.uniform(0.0, 20.0, 40)  # both sides of Pc
    for cap in (None, (10.0, 5.0, 2.0)):
        pc = None if cap is None else ppl.DruckerPragerCap(*cap)
        jc = None if cap is None else jpl.DruckerPragerCap(*cap)
        (pg, pq, pf) = ppl.plastic_gradients(*map(T, t3), T(tII), T(P), _pp(ppl), cap=pc)
        (jg, jq, jf) = jpl.plastic_gradients(*map(jnp.asarray, t3), jnp.asarray(tII),
                                             jnp.asarray(P), _pp(jpl), cap=jc)
        _all_close(pg, jg)
        for a, b in ((pq, jq), (pf, jf)):
            assert _rel(torch.as_tensor(a).expand(40) if torch.as_tensor(a).ndim == 0 else a,
                        np.broadcast_to(np.asarray(b), (40,))) <= 1e-15
        if pc is not None:
            assert _rel(ppl.yield_function_cap(_pp(ppl), T(P), T(tII), pc),
                        jpl.yield_function_cap(_pp(jpl), jnp.asarray(P), jnp.asarray(tII), jc)) <= 1e-15
    # the cap's gradients (tests/test_aux_components.py)
    cap = ppl.DruckerPragerCap(Pc=10.0, a=5.0, b=2.0)
    txx, tyy, txy = T(1.0, dtype=torch.float64), T(-1.0, dtype=torch.float64), T(0.5, dtype=torch.float64)
    tII = torch.sqrt(0.5 * (txx**2 + tyy**2) + txy**2)
    _, dQdP, dFdP = ppl.plastic_gradients(txx, tyy, txy, tII, T(5.0, dtype=torch.float64), _pp(ppl), cap=cap)
    assert float(dFdP) == -0.5
    _, dQdP, dFdP = ppl.plastic_gradients(txx, tyy, txy, tII, T(14.0, dtype=torch.float64), _pp(ppl), cap=cap)
    S = float(torch.sqrt(((14.0 - cap.Pc) / cap.a) ** 2 + (tII / cap.b) ** 2))
    np.testing.assert_allclose(float(dFdP), 4.0 / (cap.a**2 * S), rtol=1e-12)
    assert float(dFdP) > 0 and float(dQdP) == float(dFdP)
    # continuous at the corner
    pp = _pp(ppl)
    tII = T(1.5, dtype=torch.float64)
    b = float(tII) / (1.0 + float(tII - pp.C_cosphi - 0.5 * pp.sinphi))
    cap = ppl.DruckerPragerCap(Pc=0.5, a=3.0, b=b)
    lo = float(ppl.yield_function_cap(pp, T(0.5 - 1e-9, dtype=torch.float64), tII, cap))
    hi = float(ppl.yield_function_cap(pp, T(0.5 + 1e-9, dtype=torch.float64), tII, cap))
    assert abs(lo - hi) < 1e-6


def test_tension_cap_yield_and_gradients():
    """tests/test_aux_physics.py:217 on the port, and against JAX."""
    kw = dict(is_plastic=1.0, C=1.6 / math.cos(math.radians(30.0)), friction_angle=30.0,
              dilation_angle=3.0, tension_pT=-0.5)
    mat = pm.MaterialStack.make([pm.Material(**kw)], device="cpu")
    P = T([0.4, 0.0, -0.3, -0.5], dtype=torch.float64)
    pp = ppl.plastic_params_phase(mat, torch.zeros_like(P), None)
    tau_y = -ppl.yield_function(pp, P, torch.zeros_like(P))
    assert float(tau_y[0]) == pytest.approx(1.6 + 0.4 * 0.5, abs=1e-12)
    assert float(tau_y[1]) == pytest.approx(1.6, abs=1e-12)
    assert float(tau_y[2]) == pytest.approx(1.6 * (1 - (0.3 / 0.5) ** 2) ** 0.5, abs=1e-12)
    assert float(tau_y[3]) == pytest.approx(0.0, abs=1e-5)
    dFdP, dQdP = ppl.flow_gradients_P(pp, P, torch.zeros_like(P))
    assert float(dFdP[0]) == pytest.approx(-0.5, abs=1e-12)
    assert float(dQdP[2]) < 0.0 and float(dFdP[2]) == pytest.approx(float(dQdP[2]))
    jpp = jpl.plastic_params_phase(jm.MaterialStack.make([jm.Material(**kw)]),
                                   jnp.zeros(4), None)
    jP = jnp.asarray(P.numpy())
    assert _rel(ppl.yield_function(pp, P, P * 0.0), jpl.yield_function(jpp, jP, jP * 0.0)) <= 1e-15
    _all_close(ppl.flow_gradients_P(pp, P, P * 0.0), jpl.flow_gradients_P(jpp, jP, jP * 0.0))


# --- free surface ---------------------------------------------------------------
def test_free_surface_vy_matches_jax():
    nx, ny, dx, dy, eps = 8, 6, 0.5, 0.5, 1.0e-3
    Vx = np.broadcast_to((eps * np.arange(nx + 1) * dx)[:, None], (nx + 1, ny + 2)).copy()
    Vy = np.zeros((nx + 2, ny + 1))
    z, one = np.zeros(nx), np.ones(nx)
    for nu in (1.0, 0.01):
        out = pbc.free_surface_vy(T(Vx), T(Vy), T(z), T(z), T(z), T(one), math.inf, 1 / dx,
                                  1 / dy, nu=nu)
        np.testing.assert_allclose(out.numpy()[1:-1, -1], nu * 0.5 * eps * dy, rtol=1e-12)
    rng = np.random.default_rng(5)
    Vx, Vy = rng.normal(size=(nx + 1, ny + 2)), rng.normal(size=(nx + 2, ny + 1))
    P, Po, to, eta = rng.normal(size=(4, nx))
    eta = np.abs(eta) + 0.5
    Gdt = rng.uniform(1.0, 2.0, nx)
    a = pbc.free_surface_vy(*map(T, (Vx, Vy, P, Po, to, eta, Gdt)), 2.0, 3.0, nu=0.3)
    b = jbc.free_surface_vy(*map(jnp.asarray, (Vx, Vy, P, Po, to, eta, Gdt)), 2.0, 3.0, nu=0.3)
    assert _rel(a, b) <= 1e-15
    assert torch.equal(a[:, :-1], T(Vy)[:, :-1])


# --- materials and viscosity ------------------------------------------------------
def test_creep_presets_match_jax():
    assert pm.CREEP_PRESETS == jm.CREEP_PRESETS
    names = ("wet_olivine_disl_Hirth_2003", "wet_olivine_diff_Hirth_2003")
    assert pm.creep_preset(*names) == jm.creep_preset(*names)
    m = pm.Material(**pm.creep_preset(*names), rho0=3.3e3)
    assert m.disl_n == 3.5 and m.diff_m == 3.0
    with pytest.raises(KeyError, match="unknown creep preset"):
        pm.creep_preset("granite")


def test_continuation_and_phase_ratio_helpers_match_jax():
    rng = np.random.default_rng(6)
    new, old = rng.uniform(0.1, 10.0, (2, 5, 4))
    new[0, 0] = -1.0  # log of a negative: nan, the old value stands
    for nu in (0.0, 0.3, 1.0):
        a = pvisc.continuation_log(T(new), T(old), nu)
        assert _rel(a, jvisc.continuation_log(jnp.asarray(new), jnp.asarray(old), nu)) <= 1e-15
        assert float(a[0, 0]) == old[0, 0] or nu == 0.0
    pr = rng.dirichlet(np.ones(3), (5, 4))
    pr[1, 1] = [0.0, 1.0, 0.0]  # pure air (air_phase 1)
    a = pvisc.correct_phase_ratio(T(pr), 1)
    assert _rel(a, jvisc.correct_phase_ratio(jnp.asarray(pr), 1)) <= 1e-15
    np.testing.assert_allclose(a.sum(-1).numpy(), 1.0)
    assert float(a[0, 0, 1]) == 0.0 and a[1, 1].tolist() == [0.0, 1.0, 0.0]
    # compute_viscosity_fields with air_phase
    mats = [dict(eta0=1.0, disl_A=0.5, disl_n=3.0), dict(eta0=1e-3), dict(eta0=5.0)]
    pmat = pm.MaterialStack.make([pm.Material(**m) for m in mats], device="cpu")
    jmat = jm.MaterialStack.make([jm.Material(**m) for m in mats])
    f = [rng.normal(size=(5, 4)) for _ in range(3)] + [rng.normal(size=(6, 5)) for _ in range(3)]
    prv = rng.dirichlet(np.ones(3), (6, 5))
    eta, eta_v = np.ones((5, 4)), np.ones((6, 5))
    a = pvisc.compute_viscosity_fields(T(eta), T(eta_v), pmat, *map(T, f), T(pr), T(prv),
                                       mode="tau", relaxation=0.5, air_phase=1)
    b = jvisc.compute_viscosity_fields(jnp.asarray(eta), jnp.asarray(eta_v), jmat,
                                       *map(jnp.asarray, f), jnp.asarray(pr), jnp.asarray(prv),
                                       mode="tau", relaxation=0.5, air_phase=1)
    _all_close(a, b, 1e-14)


# --- explicit thermal -------------------------------------------------------------
def _gaussian(ni, L=1.0, sigma=0.08):
    mesh = np.meshgrid(*[(np.arange(n + 2) - 0.5) * (L / n) - 0.5 * L for n in ni],
                       indexing="ij")
    return np.exp(-sum(x**2 for x in mesh) / sigma**2)


def _thermal_pair(ni, T0):
    jth = JThermalState.make(ni)
    jth = jth.replace(T=jnp.asarray(T0), Told=jnp.asarray(T0))
    pth = convert.thermal_state_from_dict(serialization.to_state_dict(jth), device="cpu")
    return jth, pth


@pytest.mark.parametrize("ni", [(24, 20), (10, 9, 8)])
def test_explicit_steps_match_jax(ni):
    rng = np.random.default_rng(7)
    jth, pth = _thermal_pair(ni, _gaussian(ni))
    kappa = rng.uniform(0.5, 2.0, ni)
    faces = dict(left=True, right=True, top=True, bot=True)
    if len(ni) == 3:
        faces.update(front=True, back=True)
    jb = jbc.TemperatureBoundaryConditions(no_flux=jbc.Faces(**faces))
    pb = pbc.TemperatureBoundaryConditions(no_flux=pbc.Faces(**faces))
    jp = jte.ThermalParameters.make(jnp.asarray(kappa), jnp.ones(ni))
    pp = pte.ThermalParameters.make(T(kappa), torch.ones(ni, dtype=torch.float64))
    jg, g = JGeometry(ni, (1.0,) * len(ni)), Geometry(ni, (1.0,) * len(ni))
    dt = 0.5 * pte.stable_dt_explicit(pp, g.di)
    assert dt == 0.5 * jte.stable_dt_explicit(jp, jg.di)
    V = None
    if len(ni) == 2:
        V = (rng.normal(size=(ni[0] + 1, ni[1] + 2)), rng.normal(size=(ni[0] + 2, ni[1] + 1)))
    a = pte.solve_explicit(pth, pp, g, pb, dt, 30, V=None if V is None else tuple(map(T, V)))
    b = jte.solve_explicit(jth, jp, jg, jb, dt, 30,
                           V=None if V is None else tuple(map(jnp.asarray, V)))
    for k in ("T", "Told", "dT", "dT_dt", "qTx", "qTy") + (("qTz",) if len(ni) == 3 else ()):
        assert _rel(getattr(a, k), getattr(b, k)) <= 1e-12, k
    assert float(a.T.max()) < float(pth.T.max())


def test_explicit_gaussian_and_advection():
    """tests/test_thermal_explicit.py's analytic checks on the port."""
    ni = (64, 64)
    jth, pth = _thermal_pair(ni, _gaussian(ni))
    g = Geometry(ni, (1.0, 1.0))
    bcs = pbc.TemperatureBoundaryConditions(no_flux=pbc.Faces(left=True, right=True, top=True,
                                                              bot=True))
    params = pte.ThermalParameters.make(torch.ones(ni, dtype=torch.float64),
                                        torch.ones(ni, dtype=torch.float64))
    dt = 0.5 * pte.stable_dt_explicit(params, g.di)
    out = pte.solve_explicit(pth, params, g, bcs, dt, 200)
    want = 0.08**2 / (0.08**2 + 4.0 * 200 * dt)
    assert abs(float(out.T.max()) - want) / want < 2.0e-2
    assert abs(float(out.T[1:-1, 1:-1].sum() - pth.T[1:-1, 1:-1].sum())) < 1e-10 * float(
        pth.T[1:-1, 1:-1].sum())
    params = pte.ThermalParameters.make(torch.zeros(ni, dtype=torch.float64),
                                        torch.ones(ni, dtype=torch.float64))
    Vx = torch.full((65, 66), 0.25, dtype=torch.float64)
    Vy = torch.zeros((66, 65), dtype=torch.float64)
    dx = g.di[0]
    dt = 0.3 * dx / 0.25
    out = pte.solve_explicit(pth, params, g, bcs, dt, 40, V=(Vx, Vy))
    x = np.asarray(g.xci[0])
    Ti, T0 = out.T[1:-1, 1:-1].numpy(), pth.T[1:-1, 1:-1].numpy()
    com0 = (x[:, None] * T0).sum() / T0.sum()
    com1 = (x[:, None] * Ti).sum() / Ti.sum()
    assert abs((com1 - com0) - 0.25 * 40 * dt) < 1.5 * dx
    assert Ti.max() <= T0.max() + 1e-12 and Ti.min() >= T0.min() - 1e-12


def test_explicit_nonuniform_raises():
    """A nonuniform grid, refused before ``NonuniformGeometry`` was ported:
    now the step on a stretched grid against JAX's (1e-14)."""
    from justrelax_tpu.core.grid import NonuniformGeometry as JNG
    from justrelax_tpu_torch.core.grid import NonuniformGeometry as PNG

    s = np.linspace(-1.0, 1.0, 5)
    xv = 0.5 * (np.tanh(1.5 * s) / np.tanh(1.5) + 1.0)
    vectors = (xv, np.linspace(0.0, 1.0, 5))
    T = np.random.default_rng(2).random((6, 6))
    th = convert.thermal_state_from_dict(
        serialization.to_state_dict(JThermalState.make((4, 4)).replace(T=jnp.asarray(T))),
        device="cpu")
    params = pte.ThermalParameters.make(torch.ones(4, 4, dtype=torch.float64),
                                        torch.ones(4, 4, dtype=torch.float64))
    out = pte.explicit_diffusion_step(th, params, PNG(vectors),
                                      pbc.TemperatureBoundaryConditions(), 0.01)
    jth = JThermalState.make((4, 4)).replace(T=jnp.asarray(T))
    jout = jte.explicit_diffusion_step(
        jth, jte.ThermalParameters.make(jnp.ones((4, 4)), jnp.ones((4, 4))), JNG(vectors),
        jbc.TemperatureBoundaryConditions(), 0.01)
    for k in ("T", "dT_dt", "qTx", "qTy"):
        np.testing.assert_allclose(getattr(out, k).numpy(), np.asarray(getattr(jout, k)),
                                   rtol=0.0, atol=1e-14)


@pytest.mark.parametrize("case", ["steady", "transient"])
def test_pt_1d_matches_jax(case):
    nx = 64
    dx = 1.0 / nx
    x = (np.arange(nx) + 0.5) * dx
    if case == "steady":
        T0 = np.zeros(nx + 2)
        cv = dict(left=1.0, right=0.0)
        jb = jbc.TemperatureBoundaryConditions(constant_value=jbc.Faces(**cv))
        pb = pbc.TemperatureBoundaryConditions(constant_value=pbc.Faces(**cv))
        dt, eps = 1.0e8, 1e-10
    else:
        T0 = np.pad(np.where(x < 0.5, 1.0, 0.0), 1, mode="edge")
        jb = jbc.TemperatureBoundaryConditions(no_flux=jbc.Faces(left=True, right=True))
        pb = pbc.TemperatureBoundaryConditions(no_flux=pbc.Faces(left=True, right=True))
        dt, eps = 5.0e-4, 1e-10
    K = np.linspace(1.0, 2.0, nx) if case == "transient" else np.ones(nx)
    rc = np.ones(nx)
    a = pte.solve_pt_1d(T(T0), T(K), T(rc), dx, dt, pb, eps=eps)
    b = jte.solve_pt_1d(jnp.asarray(T0), jnp.asarray(K), jnp.asarray(rc), dx, dt, jb, eps=eps)
    assert a.iters == int(b.iters)
    assert _rel(a.T, b.T) <= 1e-12
    # err, the residual's norm, is rounding of its terms at convergence: held
    # to their scale max K·max |T|/dx²
    assert abs(float(a.err) - float(b.err)) <= 1e-12 * K.max() * np.abs(np.asarray(b.T)).max() / dx**2
    if case == "steady":
        assert float(a.err) < 1e-10
        np.testing.assert_allclose(a.T[1:-1].numpy(), 1.0 - x, atol=1e-6)
