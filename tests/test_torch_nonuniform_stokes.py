"""PyTorch port, the 2D Stokes solvers on nonuniform (stretched) grids
against the JAX package in float64 on the CPU: ``solve_ve`` (viscous, and
visco-elastic with the free-surface term), ``solve_vep`` (the plastic
capping set-up of tests/test_nonuniform_stokes.py, and with a softer
inclusion), ``solve_dyrel`` (a
buoyant box and the shear band) and ``solve_variational`` (sticky air), on
tanh-stretched grids with nx ≠ ny.

Each solve runs a fixed count of iterations set alike on both packages
(``iter_max = nout``; DYREL a fixed count of outer iterations of one chunk
each). Held: equal iterations and every field within 1e-10 of its max (the
momentum residuals at the scale of their terms). A ``NonuniformGeometry``
of uniform vectors gives the scalar path's result to JAX's 1e-13 (V, τII)
and 1e-12 (P), and the kernel asked for on a stretched grid raises
``ValueError`` naming ``use_kernel=False``.
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
from justrelax_tpu.models.shearband import _circle_phase_ratios
from justrelax_tpu.ops import bc as jbc
from justrelax_tpu.ops.rock_ratio import update_rock_ratio as j_rock
from justrelax_tpu.rheology import materials as jm
from justrelax_tpu.rheology.phases import phase_ratios_from_field as j_ratios
from justrelax_tpu.solvers.dyrel import solve_dyrel as j_dyrel
from justrelax_tpu.solvers.stokes2d import solve_ve as j_ve
from justrelax_tpu.solvers.stokes2d_variational import solve_variational as j_var
from justrelax_tpu.solvers.stokes2d_vep import solve_vep as j_vep
from justrelax_tpu_torch import convert
from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs as PPT
from justrelax_tpu_torch.core.grid import Geometry as PGeometry
from justrelax_tpu_torch.core.grid import NonuniformGeometry as PNG
from justrelax_tpu_torch.core.state import StokesState as PStokesState
from justrelax_tpu_torch.ops import bc as pbc
from justrelax_tpu_torch.ops.rock_ratio import update_rock_ratio as p_rock
from justrelax_tpu_torch.rheology import materials as pm
from justrelax_tpu_torch.rheology.phases import phase_ratios_from_field as p_ratios
from justrelax_tpu_torch.solvers.dyrel import solve_dyrel as p_dyrel
from justrelax_tpu_torch.solvers.stokes2d import solve_ve as p_ve
from justrelax_tpu_torch.solvers.stokes2d_variational import solve_variational as p_var
from justrelax_tpu_torch.solvers.stokes2d_vep import solve_vep as p_vep
from test_torch_dyrel import _flat, _max_rel
from test_torch_nonuniform import stretched

torch.set_num_threads(1)

_FS = dict(left=True, right=True, top=True, bot=True)
# tanh-stretched with nx ≠ ny, and the uniform vectors of the same box
VECTORS = {
    "stretched": (stretched(14, 1.0), stretched(11, 1.0, 2.0)),
    "uniform_vectors": (np.linspace(0.0, 1.0, 15), np.linspace(0.0, 1.0, 12)),
}


def _pkg(name):
    """The namespace of one package: its classes, solvers and a converter
    of numpy arrays."""
    if name == "jax":
        return types.SimpleNamespace(
            NG=JNG, G=JGeometry, PT=JPT, bc=jbc, m=jm, ve=j_ve, vep=j_vep, dyrel=j_dyrel,
            var=j_var, rock=j_rock, ratios=j_ratios, conv=jnp.asarray,
            state=JStokesState.make, stack=lambda ms: jm.MaterialStack.make(ms), kw={})
    return types.SimpleNamespace(
        NG=PNG, G=PGeometry, PT=PPT, bc=pbc, m=pm, ve=p_ve, vep=p_vep, dyrel=p_dyrel,
        var=p_var, rock=p_rock, ratios=p_ratios, conv=torch.as_tensor,
        state=lambda ni: PStokesState.make(ni, device="cpu"),
        stack=lambda ms: pm.MaterialStack.make(ms, device="cpu"), kw=dict(use_kernel=False))


def _geometry(k, grid):
    if grid == "scalar":
        n = tuple(len(v) - 1 for v in VECTORS["uniform_vectors"])
        return k.G(n, (1.0, 1.0))
    return k.NG(VECTORS[grid])


# ---- the set-ups, each run by either package ---------------------------------------
def _ve(k, grid, case):
    g = _geometry(k, grid)
    ni = g.ni
    X, Y = g.cell_centers_mesh()
    rho = -np.sin(np.pi * Y) * np.cos(np.pi * X)
    if case == "ve_free_surface":
        rho = np.where(Y > 0.7, 0.1, 1.0 + 0.3 * np.sin(np.pi * X))
    eta = 1.0 + 0.5 * np.cos(2.0 * np.pi * X) * np.cos(np.pi * Y)
    st = k.state(ni)
    st = st.replace(viscosity=st.viscosity.replace(eta=k.conv(eta)))
    pt = k.PT.make(g.li, g.di, CFL=1.0 / math.sqrt(2.1))
    bc = k.bc.VelocityBoundaryConditions(free_slip=k.bc.Faces(**_FS))
    if case == "viscous":
        G, K, dt, kw = k.conv(np.full(ni, np.inf)), math.inf, math.inf, {}
    else:
        G, K, dt, kw = k.conv(np.full(ni, 1.0)), k.conv(np.full(ni, 10.0)), 0.05, dict(
            free_surface=True)
    return k.ve(st, pt, g, bc, (k.conv(np.zeros(ni)), k.conv(rho)), G, K, dt,
                iter_max=400, nout=400, **kw, **k.kw)


def _vep(k, grid, nt=4, inclusion=False):
    """tests/test_nonuniform_stokes.py::_vep_solve: one plastic phase under
    pure shear, ``nt`` steps of dt = 0.25; with ``inclusion`` a second,
    softer phase (G = 0.5) in a disc off the center, so that the flow is
    not uniform."""
    g = _geometry(k, grid)
    ni = g.ni
    common = dict(Kb=4.0, eta0=1.0, is_plastic=1.0, C=0.8 / math.cos(math.radians(30.0)),
                  friction_angle=30.0, eta_reg=8.0e-3)
    phases = [k.m.Material(G=1.0, **common)]
    pr_c = pr_v = None
    if inclusion:
        phases.append(k.m.Material(G=0.5, **common))
        pr_c = k.conv(_circle_phase_ratios(g.xci[0], g.xci[1], (0.45, 0.55), 0.15))
        pr_v = k.conv(_circle_phase_ratios(g.xvi[0], g.xvi[1], (0.45, 0.55), 0.15))
    mat = k.stack(phases)
    st = k.state(ni)
    st = st.replace(viscosity=st.viscosity.replace(eta=k.conv(np.ones(ni))))
    xv, yv = g.xvi
    Vx = np.broadcast_to(xv[:, None], (ni[0] + 1, ni[1] + 2))
    Vy = np.broadcast_to(-yv[None, :], (ni[0] + 2, ni[1] + 1))
    bc = k.bc.VelocityBoundaryConditions(free_slip=k.bc.Faces(**_FS))
    Vx, Vy = k.bc.flow_bcs((k.conv(np.array(Vx)), k.conv(np.array(Vy))), bc)
    st = st.replace(V=st.V.replace(Vx=Vx, Vy=Vy))
    pt = k.PT.make(g.li, g.di, eps_rel=1.0e-8, eps_abs=1.0e-8, CFL=0.9 / math.sqrt(2.1))
    iters = []
    for _ in range(nt):
        st, info = k.vep(st, pt, g, bc, mat, pr_c, pr_v, 0.25, iter_max=200, iter_min=100,
                         nout=200, **k.kw)
        iters.append(int(info.iters))
    return st, info, iters


def _dyrel(k, grid, case):
    g = _geometry(k, grid)
    ni = g.ni
    bc = k.bc.VelocityBoundaryConditions(free_slip=k.bc.Faces(**_FS))
    st = k.state(ni)
    nv = (ni[0] + 1, ni[1] + 1)
    kw = dict(eps=1e-30, nout=50, iter_max=50, max_ph=3)
    if case == "buoyant":
        X, Y = g.cell_centers_mesh()
        rho = -np.sin(np.pi * Y) * np.cos(np.pi * X)
        st = st.replace(viscosity=st.viscosity.replace(eta=k.conv(np.ones(ni)),
                                                       eta_v=k.conv(np.ones(nv))))
        mat = k.stack([k.m.Material(rho0=0.0, eta0=1.0)])
        pr_c, pr_v = np.ones(ni + (1,)), np.ones(nv + (1,))
        dt = math.inf
        kw["rho_g"] = (k.conv(np.zeros(ni)), k.conv(rho))
    else:  # the DYREL shear band (tests/test_dyrel.py), its two phases
        common = dict(rho0=0.0, Kb=5.0, eta0=1.0, is_plastic=1.0,
                      C=1.6 / math.cos(math.radians(30.0)), friction_angle=30.0,
                      eta_reg=8.0e-3)
        mat = k.stack([k.m.Material(G=1.0, **common), k.m.Material(G=0.5, **common)])
        xv, yv = g.xvi
        Vx = np.broadcast_to(xv[:, None], (ni[0] + 1, ni[1] + 2))
        Vy = np.broadcast_to(-yv[None, :], (ni[0] + 2, ni[1] + 1))
        Vx, Vy = k.bc.flow_bcs((k.conv(np.array(Vx)), k.conv(np.array(Vy))), bc)
        st = st.replace(V=st.V.replace(Vx=Vx, Vy=Vy))
        pr_c = _circle_phase_ratios(g.xci[0], g.xci[1], (0.5, 0.5), 0.15)
        pr_v = _circle_phase_ratios(g.xvi[0], g.xvi[1], (0.5, 0.5), 0.15)
        dt = 0.25
    return k.dyrel(st, g, bc, mat, k.conv(pr_c), k.conv(pr_v), dt, **kw)


def _variational(k, grid):
    """tests/test_nonuniform_stokes.py::_variational_solve: a dense blob
    under sticky air."""
    g = _geometry(k, grid)
    X, Y = g.cell_centers_mesh()
    phase = np.zeros(g.ni, dtype=int)
    phase[Y > 0.75] = 1
    phase[(X - 0.5) ** 2 + (Y - 0.4) ** 2 <= 0.15**2] = 2
    pr = k.ratios(k.conv(phase), 3)
    phi = k.rock(pr, air_phase=1)
    mat = k.stack([k.m.Material(rho0=1.0, eta0=1.0, gravity=10.0),
                   k.m.Material(rho0=0.0, eta0=1.0e-3, gravity=10.0),
                   k.m.Material(rho0=2.0, eta0=1.0, gravity=10.0)])
    pt = k.PT.make(g.li, g.di, eps_rel=1e-6, CFL=1.0 / math.sqrt(2.1))
    bc = k.bc.VelocityBoundaryConditions(free_slip=k.bc.Faces(**_FS))
    return k.var(k.state(g.ni), pt, g, bc, mat, pr.center, pr.vertex, phi, math.inf,
                 iter_max=500, nout=500)


def _held(p_state, j_state, rho_g_max, tol=1e-10, floor=0.0):
    """Every field within ``tol`` of its max, or of ``floor`` where that is
    larger (the set-up's own scale, for fields that are rounding where the
    flow is uniform); the momentum residuals at the scale of their terms
    (max |ρg|, or max |V|/dx for RP and ∇·V)."""
    p = _flat(convert.to_state_dict(p_state))
    j = _flat(serialization.to_state_dict(j_state))
    assert p.keys() <= j.keys()
    vmax = max(np.abs(j["V.Vx"]).max(), np.abs(j["V.Vy"]).max())
    n = max(p["P"].shape)
    scales = {key: max(float(np.nan_to_num(np.abs(v)).max(initial=0.0)), floor) or None
              for key, v in j.items()}
    scales.update({"R.Rx": rho_g_max, "R.Ry": rho_g_max, "R.RP": vmax * n * 4,
                   "grad_V": vmax * n * 4})
    worst = {key: _max_rel(p[key], j[key], scales.get(key)) for key in p}
    assert {key for key, v in worst.items() if v > tol} == set(), worst


# ---- against JAX on the stretched grid ---------------------------------------------
@pytest.mark.parametrize("case", ["viscous", "ve_free_surface"])
def test_solve_ve_stretched_matches_jax(case):
    ps, pi = _ve(_pkg("port"), "stretched", case)
    js, ji = _ve(_pkg("jax"), "stretched", case)
    assert pi.iters == int(ji.iters) == 400
    _held(ps, js, 1.3)
    assert _max_rel(pi.err_history.numpy(), np.asarray(ji.err_history)) <= 1e-10


@pytest.mark.parametrize("case", ["capping", "inclusion"])
def test_solve_vep_stretched_matches_jax(case):
    """The capping set-up's flow is uniform, so its pressure, shear
    components and residuals are rounding: held at its stress scale
    (ε̇bg·η = 1). The inclusion makes them vary."""
    inclusion = case == "inclusion"
    ps, pi, p_iters = _vep(_pkg("port"), "stretched", inclusion=inclusion)
    js, ji, j_iters = _vep(_pkg("jax"), "stretched", inclusion=inclusion)
    assert p_iters == j_iters == [200] * 4
    _held(ps, js, 1.0, floor=0.0 if inclusion else 1.0)
    assert float(ps.lam.max()) > 0.0  # the return mapping acted
    if not inclusion:  # the capping of tests/test_nonuniform_stokes.py, at this step
        F = ps.tau.II.numpy() - 0.8 - ps.P.numpy() * math.sin(math.radians(30.0))
        assert F.max() < 0.05
    else:
        assert float(ps.P.abs().max()) > 1e-3


@pytest.mark.parametrize("case", ["buoyant", "band"])
def test_solve_dyrel_stretched_matches_jax(case):
    ps, pi = _dyrel(_pkg("port"), "stretched", case)
    js, ji = _dyrel(_pkg("jax"), "stretched", case)
    assert pi.iters == int(ji.iters) == 150
    _held(ps, js, 1.0)
    assert abs(float(pi.err) - float(ji.err)) <= 1e-10 * abs(float(ji.err))
    if case == "band":
        assert float(ps.tau.II.max()) > 0.0


def test_solve_variational_stretched_matches_jax():
    ps, pi = _variational(_pkg("port"), "stretched")
    js, ji = _variational(_pkg("jax"), "stretched")
    assert pi.iters == int(ji.iters) == 500
    _held(ps, js, 20.0)
    assert _max_rel(pi.err_history.numpy(), np.asarray(ji.err_history)) <= 1e-10


# ---- uniform vectors against the scalar path, on the port ---------------------------
def _against_scalar(a, b):
    """tests/test_nonuniform_stokes.py's bounds: V and τII 1e-13, P 1e-12
    (absolute)."""
    for x, y, tol in ((a.V.Vx, b.V.Vx, 1e-13), (a.V.Vy, b.V.Vy, 1e-13),
                      (a.tau.II, b.tau.II, 1e-13), (a.P, b.P, 1e-12)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0.0, atol=tol)


@pytest.mark.parametrize("solver", ["ve", "vep", "dyrel", "variational"])
def test_uniform_vectors_match_scalar_path(solver):
    k = _pkg("port")
    run = {"ve": lambda grid: _ve(k, grid, "ve_free_surface"),
           "vep": lambda grid: _vep(k, grid, nt=2, inclusion=True)[:2],
           "dyrel": lambda grid: _dyrel(k, grid, "band"),
           "variational": lambda grid: _variational(k, grid)}[solver]
    (sv, iv), (ss, is_) = run("uniform_vectors"), run("scalar")
    assert int(iv.iters) == int(is_.iters)
    _against_scalar(sv, ss)


def test_kernel_refused_on_stretched_grid():
    k = _pkg("port")
    g = _geometry(k, "stretched")
    ni = g.ni
    st = k.state(ni)
    pt = PPT.make(g.li, g.di)
    bc = pbc.VelocityBoundaryConditions(free_slip=pbc.Faces(**_FS))
    z = torch.zeros(ni, dtype=torch.float64)
    with pytest.raises(ValueError, match="use_kernel=False"):
        p_ve(st, pt, g, bc, (z, z), z + math.inf, math.inf, math.inf, use_kernel=True)
    mat = k.stack([pm.Material(G=1.0, Kb=4.0)])
    with pytest.raises(ValueError, match="use_kernel=False"):
        p_vep(st, pt, g, bc, mat, None, None, 0.25, use_kernel=True)
