"""PyTorch port, the 3D Stokes solvers on nonuniform (stretched) grids
against the JAX package in float64 on the CPU: ``solve_ve_3d`` through the
stretched Taylor–Green model, ``solve_vep_3d`` without and with ``phi`` (a
plastic crust, a stiff sphere and sticky air) and ``solve_variational_3d``
(a sphere under sticky air), on tanh-stretched grids with nx ≠ ny ≠ nz.

Each solve runs a fixed count of iterations set alike on both packages
(``iter_max = nout``). Held: equal iterations and every field within 1e-10
of its max (the momentum residuals at the scale of their terms). The
spacing families and ``compute_V_3d`` with them match JAX's, uniform
vectors give the scalar path's result (1e-13, P 1e-12), and the kernel
routes refuse a stretched grid naming ``use_kernel=False``.
"""

import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from justrelax_tpu.core.coeffs import PTStokesCoeffs as JPT
from justrelax_tpu.core.grid import Geometry as JGeometry
from justrelax_tpu.core.grid import NonuniformGeometry as JNG
from justrelax_tpu.core.state import StokesState as JStokesState
from justrelax_tpu.models import taylor_green as j_tg
from justrelax_tpu.ops import bc as jbc
from justrelax_tpu.ops import stokes3d as jk3
from justrelax_tpu.ops.rock_ratio import update_rock_ratio_3d as j_rock
from justrelax_tpu.rheology import materials as jm
from justrelax_tpu.rheology.phases import phase_ratios_from_field as j_ratios
from justrelax_tpu.solvers.stokes3d_variational import solve_variational_3d as j_var3d
from justrelax_tpu.solvers.stokes3d_vep import solve_vep_3d as j_vep3d
from justrelax_tpu_torch import convert
from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs as PPT
from justrelax_tpu_torch.core.grid import Geometry as PGeometry
from justrelax_tpu_torch.core.grid import NonuniformGeometry as PNG
from justrelax_tpu_torch.core.state import StokesState as PStokesState
from justrelax_tpu_torch.models import taylor_green as p_tg
from justrelax_tpu_torch.ops import bc as pbc
from justrelax_tpu_torch.ops import stokes3d as pk3
from justrelax_tpu_torch.ops.rock_ratio import update_rock_ratio_3d as p_rock
from justrelax_tpu_torch.rheology import materials as pm
from justrelax_tpu_torch.rheology.phases import phase_ratios_from_field as p_ratios
from justrelax_tpu_torch.solvers.stokes3d_variational import solve_variational_3d as p_var3d
from justrelax_tpu_torch.solvers.stokes3d_vep import solve_vep_3d as p_vep3d
from test_torch_dyrel import _flat, _max_rel
from test_torch_nonuniform import stretched

torch.set_num_threads(1)

_ALL = dict(left=True, right=True, top=True, bot=True, front=True, back=True)
VECTORS = {
    "stretched": (stretched(8, 1.0, 1.2), stretched(7, 1.0, 1.5), stretched(6, 1.0, 1.0)),
    "uniform_vectors": tuple(np.linspace(0.0, 1.0, n + 1) for n in (8, 7, 6)),
}


def _pkg(name):
    if name == "jax":
        return types.SimpleNamespace(
            NG=JNG, G=JGeometry, PT=JPT, bc=jbc, conv=jnp.asarray, state=JStokesState.make,
            stack=lambda ms: jm.MaterialStack.make([jm.Material(**m) for m in ms]),
            ratios=j_ratios, rock=j_rock, tg=lambda **kw: j_tg.run(**kw), vep=j_vep3d,
            var=j_var3d, kw={})
    return types.SimpleNamespace(
        NG=PNG, G=PGeometry, PT=PPT, bc=pbc, conv=torch.as_tensor,
        state=lambda ni: PStokesState.make(ni, device="cpu"),
        stack=lambda ms: pm.MaterialStack.make([pm.Material(**m) for m in ms], device="cpu"),
        ratios=p_ratios, rock=p_rock, tg=lambda **kw: p_tg.run(device="cpu", **kw),
        vep=p_vep3d, var=p_var3d, kw=dict(use_kernel=False))


def _geometry(k, grid):
    if grid == "scalar":
        return k.G(tuple(len(v) - 1 for v in VECTORS["uniform_vectors"]), (1.0, 1.0, 1.0))
    return k.NG(VECTORS[grid])


def _sphere_phases(g, air_z=0.7, r=0.3):
    """0 a plastic crust, 1 a stiff sphere, 2 air above ``air_z``, at the
    grid's own cell centers."""
    x, y, z = g.cell_centers_mesh()
    sphere = (x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.4) ** 2 < r**2
    return np.where(z > air_z, 2, np.where(sphere, 1, 0))


# ---- the set-ups, each run by either package ---------------------------------------
def _taylor_green(k, grid):
    _, st, info = k.tg(iter_max=200, nout=200, geometry=_geometry(k, grid))
    return st, info


_CRUST = [
    dict(rho0=1.0, eta0=1.0, gravity=1.0, G=1.0, Kb=10.0, is_plastic=1.0, C=0.05,
         friction_angle=30.0, eta_reg=1.0e-2),
    dict(rho0=2.0, eta0=10.0, gravity=1.0, G=1.0, Kb=10.0),
    dict(rho0=0.0, eta0=1.0e-2, gravity=1.0, G=1.0, Kb=10.0),
]
# yields in the second step (τII ≈ 2(1 − e^{−t}) = 0.79 at t = 0.5)
_SHEAR = [dict(rho0=0.0, G=1.0, Kb=4.0, eta0=1.0, is_plastic=1.0,
               C=0.6 / math.cos(math.radians(30.0)), friction_angle=30.0, eta_reg=8.0e-3),
          dict(rho0=0.0, G=0.5, Kb=4.0, eta0=1.0, is_plastic=1.0,
               C=0.6 / math.cos(math.radians(30.0)), friction_angle=30.0, eta_reg=8.0e-3)]


def _vep(k, grid, masked):
    """Masked: tests/test_torch_variational3d.py's crust, sphere and air.
    Unmasked: pure shear in x-z with a softer sphere
    (tests/test_nonuniform_stokes3d.py's set-up), two steps of dt = 0.25."""
    g = _geometry(k, grid)
    ni = g.ni
    st = k.state(ni)
    pt = k.PT.make(g.li, g.di, CFL=0.9 / math.sqrt(3.1), eps_rel=1.0e-6)
    bc = k.bc.VelocityBoundaryConditions(free_slip=k.bc.Faces(**_ALL))
    kw = dict(iter_max=100, iter_min=100, nout=100, **k.kw)
    phases = _sphere_phases(g, air_z=0.7 if masked else 2.0, r=0.3 if masked else 0.25)
    pr = k.ratios(k.conv(phases), 3 if masked else 2)
    edges = (pr.edge_yz, pr.edge_xz, pr.edge_xy)
    if masked:
        st = st.replace(viscosity=st.viscosity.replace(
            eta=k.conv(np.choose(phases, [1.0, 10.0, 1.0e-2]))))
        return k.vep(st, pt, g, bc, k.stack(_CRUST), pr.center, edges, 0.5,
                     phi=k.rock(pr, 2), **kw)
    xv, zv = g.xvi[0], g.xvi[2]
    Vx = np.broadcast_to(xv[:, None, None], (ni[0] + 1, ni[1] + 2, ni[2] + 2))
    Vz = np.broadcast_to(-zv[None, None, :], (ni[0] + 2, ni[1] + 2, ni[2] + 1))
    st = st.replace(V=st.V.replace(Vx=k.conv(np.array(Vx)), Vz=k.conv(np.array(Vz))),
                    viscosity=st.viscosity.replace(eta=k.conv(np.ones(ni))))
    mat = k.stack(_SHEAR)
    for _ in range(2):
        st, info = k.vep(st, pt, g, bc, mat, pr.center, edges, 0.25, **kw)
    return st, info


def _variational(k, grid):
    g = _geometry(k, grid)
    ni = g.ni
    phases = _sphere_phases(g, r=0.25)
    pr = k.ratios(k.conv(phases), 3)
    st = k.state(ni)
    st = st.replace(viscosity=st.viscosity.replace(eta=k.conv(np.where(phases == 1, 10.0, 1.0))))
    rho = np.where(phases == 2, 0.0, np.where(phases == 1, 2.0, 1.0))
    pt = k.PT.make(g.li, g.di, CFL=1.0 / math.sqrt(3.0), eps_rel=1.0e-6)
    bc = k.bc.VelocityBoundaryConditions(free_slip=k.bc.Faces(**_ALL))
    z = k.conv(np.zeros(ni))
    return k.var(st, pt, g, bc, (z, z, k.conv(rho)), k.conv(np.full(ni, math.inf)),
                 k.conv(np.asarray(math.inf)), k.rock(pr, 2), math.inf, iter_max=200, nout=200)


def _held(p_state, j_state, scale_R):
    p = _flat(convert.to_state_dict(p_state))
    j = _flat(serialization.to_state_dict(j_state))
    vmax = max(np.abs(j[f"V.{c}"]).max() for c in ("Vx", "Vy", "Vz"))
    n = max(p["P"].shape)
    scales = {"R.Rx": scale_R, "R.Ry": scale_R, "R.Rz": scale_R, "R.RP": vmax * n * 4,
              "grad_V": vmax * n * 4}
    worst = {key: _max_rel(p[key], j[key], scales.get(key)) for key in j if key in p}
    assert {key for key, v in worst.items() if v > 1e-10} == set(), worst


# ---- the ops ------------------------------------------------------------------------
def test_spacing_families_and_compute_V_3d_match_jax():
    pg, jg = PNG(VECTORS["stretched"]), JNG(VECTORS["stretched"])
    like = torch.zeros((), dtype=torch.float64)
    p_dc, p_dv, p_mom = pk3.spacing_families_3d(pg, like)
    j_dc, j_dv, j_mom = jk3.spacing_families_3d(jg)
    for a, b in zip(p_dc + p_dv + p_mom[0] + p_mom[1], j_dc + j_dv + j_mom[0] + j_mom[1]):
        assert a.dtype == torch.float64 and a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    f32 = pk3.spacing_families_3d(pg, torch.zeros((), dtype=torch.float32))
    assert all(t.dtype == torch.float32 for t in f32[0] + f32[1])
    nx, ny, nz = pg.ni
    rng = np.random.default_rng(5)
    shapes = dict(Vx=(nx + 1, ny + 2, nz + 2), Vy=(nx + 2, ny + 1, nz + 2),
                  Vz=(nx + 2, ny + 2, nz + 1), P=(nx, ny, nz))
    tau_shapes = [(nx, ny, nz)] * 3 + [(nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1),
                                       (nx + 1, ny + 1, nz)]
    V = [rng.standard_normal(shapes[c]) for c in ("Vx", "Vy", "Vz")]
    P = rng.standard_normal(shapes["P"])
    tau = [rng.standard_normal(s) for s in tau_shapes]
    f = [rng.standard_normal(shapes["P"]) for _ in range(3)]
    eta_tau = rng.uniform(0.5, 2.0, shapes["P"])
    t = torch.as_tensor
    a = pk3.compute_V_3d(*map(t, V), t(P), tuple(map(t, tau)), *map(t, f), t(eta_tau), 0.3,
                         p_dc, spacings=p_mom)
    b = jk3.compute_V_3d(*map(jnp.asarray, V), jnp.asarray(P), tuple(map(jnp.asarray, tau)),
                         *map(jnp.asarray, f), jnp.asarray(eta_tau), 0.3, j_dc, spacings=j_mom)
    for x, y in zip(a, b):
        assert _max_rel(x.numpy(), np.asarray(y)) <= 1e-15
    grad = pk3.compute_grad_V_3d(*map(t, V), p_dc)
    e_p = pk3.compute_strain_rate_3d(grad, *map(t, V), p_dc, p_dv)
    e_j = jk3.compute_strain_rate_3d(jk3.compute_grad_V_3d(*map(jnp.asarray, V), j_dc),
                                     *map(jnp.asarray, V), j_dc, j_dv)
    for x, y in zip(e_p, e_j):
        assert _max_rel(x.numpy(), np.asarray(y)) <= 1e-15


# ---- the solves against JAX on the stretched grid -----------------------------------
def test_taylor_green_stretched_matches_jax():
    ps, pi = _taylor_green(_pkg("port"), "stretched")
    js, ji = _taylor_green(_pkg("jax"), "stretched")
    assert pi.iters == int(ji.iters) == 200
    _held(ps, js, 36.0 * math.pi**2)
    assert _max_rel(pi.err_history.numpy(), np.asarray(ji.err_history)) <= 1e-10


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "phi"])
def test_solve_vep_3d_stretched_matches_jax(masked):
    ps, pi = _vep(_pkg("port"), "stretched", masked)
    js, ji = _vep(_pkg("jax"), "stretched", masked)
    assert pi.iters == int(ji.iters) == 100
    _held(ps, js, 2.0)
    assert float(ps.lam.max()) > 0.0  # the return mapping acted


def test_solve_variational_3d_stretched_matches_jax():
    ps, pi = _variational(_pkg("port"), "stretched")
    js, ji = _variational(_pkg("jax"), "stretched")
    assert pi.iters == int(ji.iters) == 200
    _held(ps, js, 2.0)
    assert float(ps.V.Vz.abs().max()) > 0.0


# ---- uniform vectors against the scalar path, and the refusals ----------------------
@pytest.mark.parametrize("solver", ["taylor_green", "vep3d", "vep3d_phi", "variational3d"])
def test_uniform_vectors_match_scalar_path(solver):
    k = _pkg("port")
    run = {"taylor_green": lambda grid: _taylor_green(k, grid),
           "vep3d": lambda grid: _vep(k, grid, False),
           "vep3d_phi": lambda grid: _vep(k, grid, True),
           "variational3d": lambda grid: _variational(k, grid)}[solver]
    (sv, iv), (ss, is_) = run("uniform_vectors"), run("scalar")
    assert int(iv.iters) == int(is_.iters)
    for x, y, tol in ((sv.V.Vx, ss.V.Vx, 1e-13), (sv.V.Vz, ss.V.Vz, 1e-13),
                      (sv.tau.xy, ss.tau.xy, 1e-13), (sv.P, ss.P, 1e-12)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0.0, atol=tol)


@pytest.mark.parametrize("route", [True, "edges", "edges_split", "blocked", "canvas"])
def test_kernel_routes_refuse_stretched_grid(route):
    k = _pkg("port")
    g = _geometry(k, "stretched")
    ni = g.ni
    st = k.state(ni)
    pt = PPT.make(g.li, g.di)
    bc = pbc.VelocityBoundaryConditions(free_slip=pbc.Faces(**_ALL))
    mat = k.stack(_SHEAR[:1])
    with pytest.raises(ValueError, match="use_kernel=False"):
        p_vep3d(st, pt, g, bc, mat, None, (None, None, None), 0.25, use_kernel=route)
    if route in (True, "blocked"):
        from justrelax_tpu_torch.solvers.stokes3d import solve_ve_3d

        z = torch.zeros(ni, dtype=torch.float64)
        with pytest.raises(ValueError, match="use_kernel=False"):
            solve_ve_3d(st, pt, g, bc, (z, z, z), z + math.inf, z + math.inf, math.inf,
                        use_kernel=route)
