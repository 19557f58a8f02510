"""PyTorch port, the 3D VEP Stokes solve and ShearBand3D against the JAX
package, in float64 on the CPU:

- ``solve_vep_3d`` at 6³ in bench.py's ``vep3d_hybrid`` configuration
  (plasticity active), ϵ = 0 so that two chunks of 10 run: the serial path
  and the ``"canvas"`` route against JAX's same routes, and the edge routes
  (``"edges"``, ``"edges_split"``: on CPU tensors the kernel's plain
  version, no launch) against JAX's serial path; equal iteration counts,
  every field within 1e-10 of its max;
- ``"blocked"`` (the fused chunk, B8) likewise: on CPU tensors its plain
  version, no launch, the serial path's result;
- the refusals: a material the kernels do not take (softening, a
  non-uniform Kb), ``phi``, a nonuniform grid, BCs other than free slip on
  all faces, an unknown route; a ``NonuniformGeometry`` of uniform vectors
  on the serial route against the scalar grid;
- ``shearband3d.run`` and ``run_multi`` against the JAX models (1e-10);
- ``slow``: bench.py's ``vep3d_hybrid`` golden at 10³ and
  tests/test_shearband3d.py's goldens at 12³, through the port on the CPU.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from chip_smoke import GOLDEN_VEP3D_HYBRID, vep3d_hybrid_setup
from justrelax_tpu.core.coeffs import PTStokesCoeffs as JCoeffs
from justrelax_tpu.core.grid import Geometry as JGeometry
from justrelax_tpu.core.state import StokesState as JStokesState
from justrelax_tpu.models import shearband3d as jsb3d
from justrelax_tpu.ops import bc as jbc
from justrelax_tpu.rheology.materials import Material as JMaterial
from justrelax_tpu.rheology.materials import MaterialStack as JMaterialStack
from justrelax_tpu.rheology.phases import phase_ratios_from_field as j_ratios
from justrelax_tpu.solvers.stokes3d_vep import solve_vep_3d as j_solve
from justrelax_tpu_torch import convert
from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs
from justrelax_tpu_torch.core.grid import Geometry, NonuniformGeometry
from justrelax_tpu_torch.models import shearband3d
from justrelax_tpu_torch.ops import bc as pbc
from justrelax_tpu_torch.ops import hopper_stokes3d_vep as hc
from justrelax_tpu_torch.ops import hopper_vep3d_edges as he
from justrelax_tpu_torch.ops.rock_ratio import update_rock_ratio_3d
from justrelax_tpu_torch.rheology.materials import MaterialStack
from justrelax_tpu_torch.rheology.phases import phase_ratios_from_field
from justrelax_tpu_torch.solvers.stokes3d_vep import solve_vep_3d

torch.set_num_threads(1)

N = 6
NI = (N, N, N)
_FS = dict(left=True, right=True, top=True, bot=True, front=True, back=True)
_KW = dict(iter_max=20, iter_min=0, nout=10)


def _jax_problem():
    """bench.py's vep3d_hybrid configuration at N³ with ϵ = 0."""
    common = dict(Kb=4.0, eta0=1.0, is_plastic=1.0, C=0.15 / math.cos(math.radians(30.0)),
                  friction_angle=30.0, eta_reg=8.0e-3)
    g = JGeometry(NI, (1.0, 1.0, 1.0))
    X, Y, Z = g.cell_centers_mesh()
    sph = ((np.asarray(X) - 0.5) ** 2 + (np.asarray(Y) - 0.5) ** 2
           + (np.asarray(Z) - 0.5) ** 2) < 0.15 ** 2
    pr = j_ratios(jnp.asarray(sph.astype(int)), 2)
    mat = JMaterialStack.make([JMaterial(G=1.0, **common), JMaterial(G=0.5, **common)])
    st = JStokesState.make(NI)
    st = st.replace(viscosity=st.viscosity.replace(eta=jnp.ones(NI)))
    xv, zv = jnp.asarray(g.xvi[0]), jnp.asarray(g.xvi[2])
    bc = jbc.VelocityBoundaryConditions(free_slip=jbc.Faces(**_FS))
    V = jbc.flow_bcs((jnp.broadcast_to(xv[:, None, None], (N + 1, N + 2, N + 2)),
                      jnp.zeros((N + 2, N + 1, N + 2)),
                      jnp.broadcast_to((-zv)[None, None, :], (N + 2, N + 2, N + 1))), bc)
    st = st.replace(V=st.V.replace(Vx=V[0], Vy=V[1], Vz=V[2]))
    pt = JCoeffs.make(g.li, g.di, eps_rel=0.0, eps_abs=0.0, CFL=0.75 / math.sqrt(3.1))
    return st, pt, g, bc, mat, pr


def _port_problem():
    st, _, _, _, mat, pr = _jax_problem()
    g = Geometry(NI, (1.0, 1.0, 1.0))
    ppr = convert.phase_ratios_from_dict(pr._asdict(), device="cpu")
    return (convert.stokes_state_from_dict(serialization.to_state_dict(st), device="cpu"),
            PTStokesCoeffs.make(g.li, g.di, eps_rel=0.0, eps_abs=0.0,
                                CFL=0.75 / math.sqrt(3.1)),
            g, pbc.VelocityBoundaryConditions(free_slip=pbc.Faces(**_FS)),
            convert.material_from_dict(serialization.to_state_dict(mat), device="cpu"),
            ppr.center, (ppr.edge_yz, ppr.edge_xz, ppr.edge_xy), 0.25)


def _jax_solve(route):
    st, pt, g, bc, mat, pr = _jax_problem()
    return j_solve(st, pt, g, bc, mat, pr.center, (pr.edge_yz, pr.edge_xz, pr.edge_xy), 0.25,
                   use_pallas=route, **_KW)


_FIELDS = (("V", "Vx"), ("V", "Vy"), ("V", "Vz"), ("P", None), ("tau", "xx"), ("tau", "zz"),
           ("tau", "yz"), ("tau", "xz"), ("tau", "xy"), ("tau", "xy_c"), ("tau", "II"),
           ("lam", None), ("EII_pl", None), ("EVol_pl", None), ("viscosity", "eta"),
           ("viscosity", "eta_vep"), ("eps", "xx"), ("eps", "xz"), ("eps", "II"),
           ("eps_pl", "xz"), ("R", "Rx"), ("R", "RP"))


def _get(st, path):
    a, b = path
    v = getattr(st, a)
    return v if b is None else getattr(v, b)


def _assert_states_close(p_out, j_out, tol=1e-10):
    """Every field within ``tol`` of its max; the residuals within ``tol``
    of their terms' size, O(1) in these non-dimensional problems (they
    cancel to far below it)."""
    for path in _FIELDS:
        a, b = _get(p_out, path).numpy(), np.asarray(_get(j_out, path))
        assert a.shape == b.shape, path
        scale = max(np.abs(b).max(), 1.0 if path[0] == "R" else 1e-300)
        d = np.abs(a - b).max()
        assert d <= tol * scale or d == 0.0, (path, d)


@pytest.mark.parametrize("route", [False, "canvas"])
def test_solve_vep_3d_matches_jax(route):
    p_out, p_info = solve_vep_3d(*_port_problem(), use_kernel=route, **_KW)
    j_out, j_info = _jax_solve(route)
    assert p_info.iters == int(j_info.iters) == 20
    _assert_states_close(p_out, j_out)
    np.testing.assert_allclose(p_info.err_history.numpy(), np.asarray(j_info.err_history),
                               rtol=1e-9)
    assert float(p_out.lam.max()) > 0.0   # the plastic branch ran


@pytest.fixture(scope="module")
def jax_serial():
    return _jax_solve(False)


@pytest.mark.parametrize("route", ["edges", "edges_split", True, "blocked"])
def test_edge_routes_on_cpu(route, jax_serial):
    """On CPU tensors the kernel routes run the kernels' plain versions: no
    launch, and the serial path's result."""
    he.vep3d_edges.launches = he.vep3d_edges.split_launches = 0
    hc.stokes3d_vep_chunk.launches = 0
    p_out, p_info = solve_vep_3d(*_port_problem(), use_kernel=route, **_KW)
    assert he.vep3d_edges.launches == he.vep3d_edges.split_launches == 0
    assert hc.stokes3d_vep_chunk.launches == 0
    j_out, j_info = jax_serial
    assert p_info.iters == int(j_info.iters)
    _assert_states_close(p_out, j_out)


def _with(material, **fields):
    return MaterialStack(params=dataclasses.replace(
        material.params, **{k: torch.as_tensor(v, dtype=torch.float64)
                            for k, v in fields.items()}))


def test_edge_route_refuses_unsupported_materials():
    args = list(_port_problem())
    mat = args[4]
    for bad in (_with(mat, soft_C_active=[1.0, 1.0]), _with(mat, Kb=[4.0, 5.0]),
                _with(mat, C=[0.2, 0.3]), _with(mat, dilation_angle=[0.0, 5.0])):
        args[4] = bad
        for route in (True, "edges", "edges_split", "blocked"):
            with pytest.raises(ValueError, match="use_kernel=False.*'canvas'"):
                solve_vep_3d(*args, use_kernel=route, **_KW)
        solve_vep_3d(*args, use_kernel="canvas", iter_max=2, iter_min=0, nout=1)


def test_not_ported_and_refused():
    args = _port_problem()
    # phi runs the masked solve on the serial route: all rock, it is the
    # unmasked solve (tests/test_torch_variational3d.py holds it to JAX)
    rock = update_rock_ratio_3d(phase_ratios_from_field(torch.zeros(NI, dtype=torch.long), 2), 1)
    masked, mi = solve_vep_3d(*args, phi=rock, use_kernel=False, **_KW)
    plain, pi = solve_vep_3d(*args, use_kernel=False, **_KW)
    assert int(mi.iters) == int(pi.iters)
    for a, b in ((masked.V.Vx, plain.V.Vx), (masked.V.Vz, plain.V.Vz), (masked.P, plain.P),
                 (masked.tau.xz, plain.tau.xz)):
        assert float((a - b).abs().max()) <= 1e-13 * float(b.abs().max())
    with pytest.raises(ValueError, match="use_kernel"):
        solve_vep_3d(*args, use_kernel="fused", **_KW)
    for route in ("edges", "edges_split", "canvas", "blocked"):
        with pytest.raises(ValueError, match="phi"):
            solve_vep_3d(*args, phi=object(), use_kernel=route, **_KW)
        noslip = pbc.VelocityBoundaryConditions(free_slip=pbc.Faces(left=True, right=True),
                                                no_slip=pbc.Faces(top=True, bot=True))
        with pytest.raises(ValueError, match="free-slip"):
            solve_vep_3d(*args[:3], noslip, *args[4:], use_kernel=route, **_KW)

    # a nonuniform grid: the canvas routes refuse it; the serial route on
    # uniform vectors gives the scalar grid's result
    # (tests/test_nonuniform_stokes3d.py; stretched against JAX in
    # tests/test_torch_nonuniform_stokes3d.py)
    g = NonuniformGeometry(tuple(np.linspace(0.0, 1.0, n + 1) for n in NI))
    for route in ("edges", "canvas"):
        with pytest.raises(ValueError, match="uniform grid"):
            solve_vep_3d(args[0], args[1], g, *args[3:], use_kernel=route, **_KW)
    vec, _ = solve_vep_3d(args[0], args[1], g, *args[3:], use_kernel=False, **_KW)
    for a, b, tol in ((vec.V.Vx, plain.V.Vx, 1e-13), (vec.V.Vz, plain.V.Vz, 1e-13),
                      (vec.tau.xz, plain.tau.xz, 1e-13), (vec.P, plain.P, 1e-12)):
        assert float((a - b).abs().max()) <= tol


_MODEL_KW = dict(nt=2, eps_bg=1.0)


@pytest.mark.parametrize("name", ["run", "run_multi"])
def test_shearband3d_matches_jax(name):
    """The models at 7³ (an odd n puts the inclusion on a cell center) over
    two steps: the max τ history and the final state against JAX's."""
    p_st, p_info, p_tau, p_sol = getattr(shearband3d, name)(n=7, device="cpu", **_MODEL_KW)
    j_st, j_info, j_tau, j_sol = getattr(jsb3d, name)(n=7, **_MODEL_KW)
    assert p_info.iters == int(j_info.iters)
    np.testing.assert_allclose(p_tau, j_tau, rtol=1e-12)
    np.testing.assert_allclose(p_sol, j_sol, rtol=1e-15)
    _assert_states_close(p_st, j_st)


def test_shearband3d_setup():
    """``_setup`` returns what ``run`` solves with: the inclusion's phase and
    viscosity, pure-shear boundary velocities, Kb = ∞, all free slip."""
    geometry, st, material, (pr_c, pr_e), bc, pt, dt = shearband3d._setup(
        7, torch.float32, "cpu")
    assert st.P.dtype == torch.float32 and pr_c.dtype == torch.float32
    assert pr_c.shape == (7, 7, 7, 2) and [p.shape[:3] for p in pr_e] == [
        (7, 8, 8), (8, 7, 8), (8, 8, 7)]
    assert float(pr_c[3, 3, 3, 1]) == 1.0 and st.viscosity.eta[3, 3, 3] == torch.tensor(0.1)
    assert bool(torch.isinf(material.params.Kb).all()) and dt == 0.125
    assert torch.equal(st.V.Vx[-1, 1:-1, 1:-1], torch.full((7, 7), 1.0))
    assert all(pbc.Faces.on(v) for v in vars(bc.free_slip).values())


@pytest.mark.slow
def test_vep3d_hybrid_golden():
    """bench.py's vep3d_hybrid golden at 10³ f64 through the port on the
    CPU: the edge route (the kernel's plain version here) and the serial
    path, on bench.py's gates."""
    args, kw = vep3d_hybrid_setup(torch.float64, "cpu")
    out_h, _ = solve_vep_3d(*args, use_kernel="edges", **kw)
    out_x, _ = solve_vep_3d(*args, use_kernel=False, **kw)
    scale = float(out_x.tau.II.abs().max())
    assert float((out_h.tau.II - out_x.tau.II).abs().max()) / scale < 1e-3
    v = float(out_h.tau.II.abs().max())
    assert abs(v - GOLDEN_VEP3D_HYBRID) / GOLDEN_VEP3D_HYBRID < 2e-2


@pytest.mark.slow
def test_shearband3d_golden():
    """tests/test_shearband3d.py's goldens at 12³ over 14 steps, on the
    serial path."""
    st, info, tau, sol = shearband3d.run(n=12, nt=14, device="cpu")
    assert float(info.err) < 1.0e-5
    for got, want in zip(tau[:6], sol[:6]):
        assert want <= got < 1.15 * want
    assert 1.6 < tau[-1] < 1.66
    np.testing.assert_allclose(tau[-1], 1.625106, atol=1e-4)
    np.testing.assert_allclose(float(st.EII_pl.max()), 0.3258544082022995, rtol=1e-5)
