"""PyTorch port, nonuniform (stretched) grids and the thermal solvers on
them, against the JAX package in float64 on the CPU:

- ``NonuniformGeometry``: every field, the spacing families and their
  broadcastable reciprocals bit for bit, equality and a hash equal to the
  JAX grid's, the ``ValueError`` of a bad vector; ``convert.geometry_from_dict``;
- ``heatdiffusion_PT`` (K/ρCp and material paths) and the explicit step
  (with and without upwind advection, 2D and 3D) on tanh-stretched grids
  with nx ≠ ny: fields within 1e-12 of their max, equal iterations;
- the steady linear profile, exact on any stretching (JAX's 5e-7);
- a float Dirichlet mask (``test_inner_dirichlet_anomaly``'s set-up):
  within 1e-10, equal iterations, and the same result as a bool mask.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from justrelax_tpu.core.coeffs import PTThermalCoeffs as JPT
from justrelax_tpu.core.grid import Geometry as JGeometry
from justrelax_tpu.core.grid import NonuniformGeometry as JNG
from justrelax_tpu.core.state import ThermalState as JThermalState
from justrelax_tpu.ops import bc as jbc
from justrelax_tpu.rheology import materials as jm
from justrelax_tpu.solvers import thermal_explicit as jte
from justrelax_tpu.solvers.thermal import heatdiffusion_PT as j_heat
from justrelax_tpu_torch import convert
from justrelax_tpu_torch.core.coeffs import PTThermalCoeffs as PPT
from justrelax_tpu_torch.core.grid import Geometry as PGeometry
from justrelax_tpu_torch.core.grid import NonuniformGeometry as PNG
from justrelax_tpu_torch.core.state import ThermalState as PThermalState
from justrelax_tpu_torch.ops import bc as pbc
from justrelax_tpu_torch.rheology import materials as pm
from justrelax_tpu_torch.solvers import thermal_explicit as pte
from justrelax_tpu_torch.solvers.thermal import heatdiffusion_PT as p_heat

torch.set_num_threads(1)

YR = 365.25 * 24 * 3600


def stretched(n, L, beta=1.5, origin=0.0):
    """tanh-clustered vertices on [origin, origin + L], refined at the
    center."""
    s = np.linspace(-1.0, 1.0, n + 1)
    return origin + 0.5 * L * (np.tanh(beta * s) / np.tanh(beta) + 1.0)


GRIDS = {
    "2d": (stretched(12, 2.0), stretched(9, 1.0, 2.0, origin=-1.0)),
    "3d": (stretched(7, 1.0), stretched(6, 0.5, 2.5), stretched(5, 1.5, 1.0, origin=0.3)),
}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    d = np.abs(a - b).max(initial=0.0)
    return 0.0 if d == 0.0 else d / np.abs(b).max(initial=0.0)


# ---- the geometry -----------------------------------------------------------------
@pytest.mark.parametrize("dims", sorted(GRIDS))
def test_geometry_fields_match_jax(dims):
    p, j = PNG(GRIDS[dims]), JNG(GRIDS[dims])
    for k in ("ni", "li", "origin", "di", "di_center", "di_vertex"):
        assert getattr(p, k) == getattr(j, k), k
    for k in ("xci", "xvi"):
        for a, b in zip(getattr(p, k), getattr(j, k)):
            np.testing.assert_array_equal(a, b)
    for comp_p, comp_j in zip(p.xi_vel, j.xi_vel):
        for a, b in zip(comp_p, comp_j):
            np.testing.assert_array_equal(a, b)
    for k in ("inv_flux_di", "inv_div_di"):
        for a, b in zip(getattr(p, k), getattr(j, k)):
            assert a.dtype == np.float64 and a.shape == np.asarray(b).shape
            np.testing.assert_array_equal(a, np.asarray(b))
    # the ghost nodes sit one edge cell width outside
    dc0 = np.diff(GRIDS[dims][1])
    assert p.xi_vel[0][1][0] == p.xci[1][0] - dc0[0]
    assert p.min_di == min(p.di) and p.ndim == len(GRIDS[dims])
    assert hash(p) == hash(j)
    q = PNG(tuple(np.copy(v) for v in GRIDS[dims]))
    assert p == q and hash(p) == hash(q)
    other = PNG((stretched(len(GRIDS[dims][0]) - 1, 2.0, 1.0),) + GRIDS[dims][1:])
    assert p != other
    assert p != PGeometry(p.ni, p.li, p.origin)


@pytest.mark.parametrize("bad", ["decreasing", "repeated", "2d_array", "one_axis", "four_axes",
                                 "one_vertex"])
def test_geometry_refuses_bad_vectors(bad):
    v = np.linspace(0.0, 1.0, 5)
    vectors = {
        "decreasing": (v[::-1], v),
        "repeated": (np.array([0.0, 0.5, 0.5, 1.0]), v),
        "2d_array": (v.reshape(1, -1), v),
        "one_axis": (v,),
        "four_axes": (v, v, v, v),
        "one_vertex": (np.array([0.0]), v),
    }[bad]
    for cls in (PNG, JNG):
        with pytest.raises(ValueError):
            cls(vectors)


@pytest.mark.parametrize("kind", ["uniform_2d", "uniform_3d", "stretched_2d", "stretched_3d"])
def test_geometry_from_dict(kind):
    if kind.startswith("uniform"):
        ni, li = ((6, 5), (2.0, 1.0)) if kind.endswith("2d") else ((4, 5, 3), (1.0, 2.0, 0.5))
        jg = JGeometry(ni, li, origin=tuple(-0.5 * v for v in li))
    else:
        jg = JNG(GRIDS[kind[-2:]])
    pg = convert.geometry_from_dict(vars(jg))
    assert type(pg) is (PGeometry if kind.startswith("uniform") else PNG)
    for k in ("ni", "li", "origin", "di"):
        assert getattr(pg, k) == getattr(jg, k)
    for a, b in zip(pg.xci + pg.xvi, jg.xci + jg.xvi):
        np.testing.assert_array_equal(a, b)
    if not kind.startswith("uniform"):
        assert pg.di_center == jg.di_center and pg.di_vertex == jg.di_vertex
        assert hash(pg) == hash(jg)


# ---- the PT thermal solve and the explicit step ----------------------------------
def _thermal_inputs(geometry, pkg, seed=4):
    """A random T between a hot bottom and a cold top, insulated sides,
    random K, ρCp and H at the centers."""
    ni = geometry.ni
    rng = np.random.default_rng(seed)
    Tg = rng.random(tuple(n + 2 for n in ni))
    K = rng.uniform(0.5, 2.0, ni)
    rc = rng.uniform(0.8, 1.2, ni)
    H = 0.1 * rng.random(ni)
    if pkg == "jax":
        bc = jbc.TemperatureBoundaryConditions(no_flux=jbc.Faces(left=True, right=True),
                                               constant_value=jbc.Faces(top=0.0, bot=1.0))
        T = jbc.thermal_bcs(jnp.asarray(Tg), bc)
        th = JThermalState.make(ni).replace(T=T, Told=T, H=jnp.asarray(H))
        return th, bc, jnp.asarray(K), jnp.asarray(rc)
    bc = pbc.TemperatureBoundaryConditions(no_flux=pbc.Faces(left=True, right=True),
                                           constant_value=pbc.Faces(top=0.0, bot=1.0))
    T = pbc.thermal_bcs(torch.as_tensor(Tg), bc)
    th = PThermalState.make(ni, device="cpu").replace(T=T, Told=T, H=torch.as_tensor(H))
    return th, bc, torch.as_tensor(K), torch.as_tensor(rc)


def _thermal_held(p_th, j_th, tol=1e-12):
    a, b = convert.to_state_dict(p_th), serialization.to_state_dict(j_th)
    for k, v in b.items():
        if v is None:
            assert a[k] is None
        elif k != "ResT":  # a residual: its rounding is on its terms' scale
            assert _rel(a[k], v) <= tol, (k, _rel(a[k], v))


@pytest.mark.parametrize("path", ["K", "material"])
def test_heatdiffusion_stretched_matches_jax(path):
    vectors = GRIDS["2d"]
    dt = 0.05
    out = {}
    for pkg, G, heat, PT, M in (("jax", JNG, j_heat, JPT, jm), ("port", PNG, p_heat, PPT, pm)):
        g = G(vectors)
        th, bc, K, rc = _thermal_inputs(g, pkg)
        kw = dict(K=K, rho_Cp=rc)
        pt = PT.make(K, rc, dt, g.di, g.li)
        if path == "material":
            mat = M.Material(rho0=1.0, alpha=1e-3, T0=0.0, Cp=1.0, k=1.5, H_r=0.05)
            P = jnp.zeros(g.ni) if pkg == "jax" else torch.zeros(g.ni, dtype=torch.float64)
            kw = dict(material=mat, P=P)
            pt = PT.from_material(mat, th.T[1:-1, 1:-1], P, dt, g.di, g.li)
        if pkg == "port":
            kw["use_kernel"] = False
        out[pkg] = heat(th, pt, bc, dt, g, iter_max=300, nout=300, **kw)
    (p_th, p_info), (j_th, j_info) = out["port"], out["jax"]
    assert p_info.iters == int(j_info.iters) == 300
    _thermal_held(p_th, j_th)
    scale = float(np.abs(np.asarray(j_th.T)).max() / dt)
    assert np.abs(p_th.ResT.numpy() - np.asarray(j_th.ResT)).max() <= 1e-12 * scale
    np.testing.assert_allclose(p_info.err_history.numpy(), np.asarray(j_info.err_history),
                               rtol=0.0, atol=1e-12 * scale)


def test_heatdiffusion_stretched_refuses_the_kernel():
    g = PNG(GRIDS["2d"])
    th, bc, K, rc = _thermal_inputs(g, "port")
    pt = PPT.make(K, rc, 0.05, g.di, g.li)
    with pytest.raises(ValueError, match="use_kernel=False"):
        p_heat(th, pt, bc, 0.05, g, K=K, rho_Cp=rc, use_kernel=True)


@pytest.mark.parametrize("case", ["2d", "2d_advection", "3d", "3d_advection"])
def test_explicit_step_stretched_matches_jax(case):
    dims = case[:2]
    out = {}
    for pkg, G, te in (("jax", JNG, jte), ("port", PNG, pte)):
        g = G(GRIDS[dims])
        ni = g.ni
        ndim = len(ni)
        r = np.random.default_rng(11)
        Tg = r.random(tuple(n + 2 for n in ni))
        kappa = r.uniform(0.5, 2.0, ni)
        V = tuple(r.standard_normal(tuple(n + 1 if a == c else n + 2 for a, n in enumerate(ni)))
                  for c in range(ndim))
        faces = dict(left=True, right=True, top=True, bot=True)
        if ndim == 3:
            faces.update(front=True, back=True)
        conv = jnp.asarray if pkg == "jax" else torch.as_tensor
        bcm = jbc if pkg == "jax" else pbc
        bcs = bcm.TemperatureBoundaryConditions(no_flux=bcm.Faces(**faces))
        th = (JThermalState.make(ni) if pkg == "jax"
              else PThermalState.make(ni, device="cpu")).replace(T=conv(Tg), Told=conv(Tg))
        params = te.ThermalParameters.make(conv(kappa), conv(np.ones(ni)))
        dt = 0.5 * te.stable_dt_explicit(params, g.di)
        Vin = tuple(map(conv, V)) if case.endswith("advection") else None
        out[pkg] = te.solve_explicit(th, params, g, bcs, dt, 3, V=Vin)
    a, b = convert.to_state_dict(out["port"]), serialization.to_state_dict(out["jax"])
    for k, v in b.items():
        if v is not None and k != "ResT":
            assert _rel(a[k], v) <= 1e-12, k


def test_steady_linear_profile_exact_on_stretched_grid():
    """Steady conduction between two Dirichlet ends is linear in x, which
    the two-point flux on the face spacings reproduces on any stretching
    (tests/test_nonuniform.py's oracle, 5e-7)."""
    g = PNG((stretched(24, 1.0, 2.5), np.linspace(0.0, 1.0, 7)))
    ni = g.ni
    bc = pbc.TemperatureBoundaryConditions(constant_value=pbc.Faces(left=0.0, right=1.0),
                                           no_flux=pbc.Faces(top=True, bot=True))
    T = pbc.thermal_bcs(torch.full((ni[0] + 2, ni[1] + 2), 0.5, dtype=torch.float64), bc)
    th = PThermalState.make(ni, device="cpu").replace(T=T, Told=T)
    K = torch.ones(ni, dtype=torch.float64)
    dt = 1.0e6
    pt = PPT.make(K, K, dt, g.di, g.li, eps=1.0e-11, CFL=0.95 / math.sqrt(2.0))
    th, info = p_heat(th, pt, bc, dt, g, K=K, rho_Cp=K, iter_max=100_000, nout=500)
    assert float(info.err) <= 1.0e-11
    X = g.cell_centers_mesh()[0]
    np.testing.assert_allclose(th.T[1:-1, 1:-1].numpy(), X, atol=5.0e-7)


# ---- the float Dirichlet mask -----------------------------------------------------
def _anomaly(pkg, mask_kind="float", nt=3):
    """tests/test_diffusion_inner_bcs.py::test_inner_dirichlet_anomaly: a
    circular anomaly pinned at 1050 K by a Dirichlet mask in a 300–3500 K
    geotherm, two-phase conductivity, ``nt`` steps of 50 kyr."""
    nx = ny = 32
    lx = ly = 100.0e3
    ni = (nx, ny)
    G = JGeometry if pkg == "jax" else PGeometry
    geometry = G(ni, (lx, ly), origin=(0.0, -ly))
    y_c = np.asarray(geometry.xci[1])
    T0 = 300.0 + (3500.0 - 300.0) * (-y_c / ly)
    Tg = np.zeros((nx + 2, ny + 2))
    Tg[1:-1, 1:-1] = np.broadcast_to(T0[None, :], ni)
    Omega_T, r = 1050.0, 10.0e3
    X, Y = np.meshgrid(*[np.asarray(c) for c in geometry.xci], indexing="ij")
    inside = (X - lx / 2) ** 2 + (Y + ly / 2) ** 2 < r**2
    Tg[1:-1, 1:-1] = np.where(inside, Omega_T, Tg[1:-1, 1:-1])
    mask = inside.astype(float) if mask_kind == "float" else inside
    K = np.where(inside, 9.0, 3.0)
    rho_Cp = np.full(ni, 3.3e3 * 1.2e3)
    dt = 50.0e3 * YR
    if pkg == "jax":
        conv, bcm, th = jnp.asarray, jbc, JThermalState.make(ni)
        PT, heat, kw = JPT, j_heat, {}
    else:
        conv, bcm, th = torch.as_tensor, pbc, PThermalState.make(ni, device="cpu")
        PT, heat, kw = PPT, p_heat, dict(use_kernel=False)
    bc = bcm.TemperatureBoundaryConditions(no_flux=bcm.Faces(left=True, right=True),
                                           constant_value=bcm.Faces(top=300.0, bot=3500.0))
    T = bcm.thermal_bcs(conv(Tg), bc)
    th = th.replace(T=T, Told=T)
    K, rho_Cp = conv(K), conv(rho_Cp)
    pt = PT.make(K, rho_Cp, dt, geometry.di, geometry.li, eps=1.0e-5, CFL=0.97 / math.sqrt(2.0))
    iters = []
    for _ in range(nt):
        th, info = heat(th, pt, bc, dt, geometry, K=K, rho_Cp=rho_Cp,
                        dirichlet=(conv(mask), conv(np.full(ni, Omega_T))),
                        iter_max=10_000, nout=100, **kw)
        iters.append(int(info.iters))
    return th, info, iters, inside


def test_float_dirichlet_mask_matches_jax():
    p_th, p_info, p_iters, inside = _anomaly("port")
    j_th, j_info, j_iters, _ = _anomaly("jax")
    assert p_iters == j_iters and all(0 < i < 10_000 for i in p_iters)
    _thermal_held(p_th, j_th, 1e-10)
    T = p_th.T[1:-1, 1:-1].numpy()
    assert float(p_info.err) < 1.0e-5
    np.testing.assert_allclose(T[inside], 1050.0, atol=1e-8)
    assert (p_th.ResT.numpy()[inside] == 0.0).all()
    # a bool mask pins the same cells: the same result bit for bit
    b_th, _, b_iters, _ = _anomaly("port", mask_kind="bool")
    assert b_iters == p_iters and torch.equal(b_th.T, p_th.T)
