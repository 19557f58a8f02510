"""PyTorch port, the 3D VE Stokes solve and its models against the JAX
package, in float64 on the CPU:

- ``solve_ve_3d`` at 8³ with G = 4, K = 9, dt = 0.5 and ϵ = 0 (a fixed 60
  iterations in chunks of 30), as tests/test_pallas3d_blocked.py holds
  JAX's two routes: the port's plain path against JAX's plain path, and the
  port's kernel route on CPU tensors (the plain chunk) against JAX's
  ``use_pallas=True``; equal iteration counts, every field within 1e-11 of
  its family's max, residuals within 1e-12 of their terms' size
  (``test_torch_stokes_ve._state_close``), and the port's two routes held
  against each other;
- the kernel guard's ``ValueError`` for each excluded option (a
  nonuniform grid among them), JAX's ``pallas_lean`` refusal, and a
  ``NonuniformGeometry`` of uniform vectors on the plain path against the
  scalar grid;
- ``solvi3d``, ``burstedde`` and ``taylor_green`` at 8³ with a fixed
  iteration count against the JAX models (1e-10);
- ``smooth_viscosity_3d`` against JAX and the bounds of
  tests/test_solvi3d.py;
- ``slow``: the goldens of tests/test_solvi3d.py, tests/test_taylor_green.py
  and tests/test_stokes_burstedde.py through the port.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from justrelax_tpu.core.coeffs import PTStokesCoeffs as JCoeffs
from justrelax_tpu.core.grid import Geometry as JGeometry
from justrelax_tpu.core.grid import NonuniformGeometry as JNonuniformGeometry
from justrelax_tpu.core.state import StokesState as JStokesState
from justrelax_tpu.models import burstedde as jburstedde
from justrelax_tpu.models import solvi3d as jsolvi3d
from justrelax_tpu.models import taylor_green as jtaylor_green
from justrelax_tpu.ops import bc as jbc
from justrelax_tpu.solvers.stokes3d import solve_ve_3d as j_solve_ve_3d
from justrelax_tpu_torch import convert
from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs
from justrelax_tpu_torch.core.grid import Geometry, NonuniformGeometry
from justrelax_tpu_torch.models import burstedde, solvi3d, taylor_green
from justrelax_tpu_torch.ops import bc as pbc
from justrelax_tpu_torch.ops import hopper_stokes3d as h3
from justrelax_tpu_torch.solvers.stokes3d import solve_ve_3d
from test_torch_stokes_ve import _info_close, _state_close

torch.set_num_threads(1)

N = 8
NI = (N, N, N)
_FS = dict(free_slip=dict(left=True, right=True, top=True, bot=True, front=True, back=True))


def _problem():
    """The set-up of tests/test_pallas3d_blocked.py:188-224 at 8³: lognormal
    η, a random fz, G = 4, K = 9, dt = 0.5, all free slip."""
    rng = np.random.default_rng(0)
    eta = np.exp(0.3 * rng.normal(size=NI))
    fz = rng.normal(size=NI)
    z = np.zeros(NI)
    return eta, (z, z, fz), np.full(NI, 4.0), np.full(NI, 9.0), 0.5


def _jax_solve(use_pallas, **kw):
    eta, rho_g, G, K, dt = _problem()
    st = JStokesState.make(NI)
    st = st.replace(viscosity=st.viscosity.replace(eta=jnp.asarray(eta)))
    g = JGeometry(NI, (1.0, 1.0, 1.0))
    pt = JCoeffs.make(g.li, g.di, eps_abs=0.0, eps_rel=0.0)
    return j_solve_ve_3d(st, pt, g, jbc.VelocityBoundaryConditions(**_FS),
                         tuple(map(jnp.asarray, rho_g)), jnp.asarray(G), jnp.asarray(K), dt,
                         iter_max=60, nout=30, use_pallas=use_pallas, **kw)


def _port_inputs():
    eta, rho_g, G, K, dt = _problem()
    st = JStokesState.make(NI)
    st = st.replace(viscosity=st.viscosity.replace(eta=jnp.asarray(eta)))
    pst = convert.stokes_state_from_dict(serialization.to_state_dict(st), device="cpu")
    g = Geometry(NI, (1.0, 1.0, 1.0))
    pt = PTStokesCoeffs.make(g.li, g.di, eps_abs=0.0, eps_rel=0.0)
    t = torch.tensor
    return (pst, pt, g, pbc.VelocityBoundaryConditions(**_FS), tuple(map(t, rho_g)), t(G),
            t(K), dt)


def _port_solve(use_kernel, **kw):
    return solve_ve_3d(*_port_inputs(), iter_max=60, nout=30, use_kernel=use_kernel, **kw)


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_solve_ve_3d_matches_jax(route):
    """On CPU tensors ``use_kernel=True`` runs the wrapper's CPU route: the
    plain chunk, with the kernel path's post-update residuals."""
    h3.stokes3d_chunk.launches = 0
    p_out, p_info = _port_solve(route == "kernel")
    j_out, j_info = _jax_solve(route == "kernel")
    assert h3.stokes3d_chunk.launches == 0
    assert p_info.iters == int(j_info.iters) == 60
    _, _, _, _, rho_g, _, _, _ = _port_inputs()
    sc = _state_close(p_out, j_out, (1.0 / N,) * 3, rho_g[2].abs().max().item(), tol=1e-11)
    _info_close(p_info, j_info, sc["residual"])
    # elementwise, as tests/test_pallas3d_blocked.py:214-224 holds JAX's routes
    for a, b, atol in ((p_out.V.Vz, j_out.V.Vz, 1e-14), (p_out.P, j_out.P, 1e-13),
                       (p_out.tau.yz, j_out.tau.yz, 1e-14)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-11, atol=atol)
    assert p_out.eps.zz.abs().max() == 0.0  # solve_ve_3d sets no strain rate
    for a, b in ((p_out.tau.yz, p_out.tau_o.yz), (p_out.viscosity.eta_tau,
                                                  torch.tensor(np.asarray(j_out.viscosity.eta_tau)))):
        assert torch.equal(a, b)


def test_plain_and_kernel_routes_agree():
    a, ia = _port_solve(False)
    b, ib = _port_solve(True)
    assert ia.iters == ib.iters
    for x, y in ((a.V.Vx, b.V.Vx), (a.V.Vz, b.V.Vz), (a.P, b.P), (a.tau.xy, b.tau.xy),
                 (a.tau.zz, b.tau.zz)):
        assert float((x - y).abs().max()) <= 1e-11 * float(y.abs().max())
    # the x-momentum residual reads P and τ only, so both routes take the same
    assert float((ia.norm_Rx - ib.norm_Rx).abs().max()) <= 1e-12 * float(ib.norm_Rx.max())


_EXCLUDED = {
    "mean_free_RP": (_FS, dict(mean_free_RP=True)),
    "boundary_shear": (_FS, dict(boundary_shear=True)),
    "alpha_dT": (_FS, dict(alpha_dT="field")),
    "no_slip": (dict(no_slip=dict(left=True, right=True, top=True, bot=True, front=True,
                                  back=True)), {}),
    "partial_free_slip": (dict(free_slip=dict(left=True, right=True, top=True, bot=True)), {}),
}


@pytest.mark.parametrize("case", sorted(_EXCLUDED))
def test_kernel_refused_where_jax_refuses(case):
    bc_kw, kw = _EXCLUDED[case]
    st, pt, g, _, rho_g, G, K, dt = _port_inputs()
    kw_p = {k: (torch.zeros(NI, dtype=torch.float64) if v == "field" else v) for k, v in kw.items()}
    with pytest.raises(ValueError, match="use_kernel=False"):
        solve_ve_3d(st, pt, g, pbc.VelocityBoundaryConditions(**bc_kw), rho_g, G, K, dt,
                    use_kernel=True, **kw_p)
    jst, jpt, jg = JStokesState.make(NI), JCoeffs.make((1.0,) * 3, (1.0 / N,) * 3), \
        JGeometry(NI, (1.0,) * 3)
    kw_j = {k: (jnp.zeros(NI) if v == "field" else v) for k, v in kw.items()}
    z = jnp.zeros(NI)
    with pytest.raises(ValueError):
        j_solve_ve_3d(jst, jpt, jg, jbc.VelocityBoundaryConditions(**bc_kw), (z, z, z),
                      jnp.full(NI, 4.0), jnp.full(NI, 9.0), 0.5, use_pallas="blocked", **kw_j)


def test_not_ported_and_refused_arguments():
    st, pt, g, bc, rho_g, G, K, dt = _port_inputs()

    # a nonuniform grid: the kernel refuses it; the plain path on uniform
    # vectors gives the scalar grid's result (tests/test_nonuniform_stokes3d.py)
    nonuniform = NonuniformGeometry(tuple(np.linspace(0.0, 1.0, N + 1) for _ in range(3)))
    with pytest.raises(ValueError, match="use_kernel=False"):
        solve_ve_3d(st, pt, nonuniform, bc, rho_g, G, K, dt, use_kernel=True)
    a, ia = solve_ve_3d(st, pt, nonuniform, bc, rho_g, G, K, dt, iter_max=20, nout=10,
                        use_kernel=False)
    b, ib = solve_ve_3d(st, pt, g, bc, rho_g, G, K, dt, iter_max=20, nout=10, use_kernel=False)
    assert ia.iters == ib.iters == 20
    for x, y in ((a.V.Vx, b.V.Vx), (a.V.Vz, b.V.Vz), (a.tau.xy, b.tau.xy)):
        assert float((x - y).abs().max()) <= 1e-13
    assert float((a.P - b.P).abs().max()) <= 1e-12
    with pytest.raises(ValueError, match="pallas_lean"):
        solve_ve_3d(st, pt, g, bc, rho_g, G, K, dt, pallas_lean=True)
    with pytest.raises(ValueError):
        solve_ve_3d(st, pt, g, bc, rho_g, G, K, dt, use_kernel="edges")
    # pallas_lean is a TPU lowering choice: in the viscous limit it changes nothing
    inf = torch.full(NI, math.inf, dtype=torch.float64)
    a, ia = solve_ve_3d(st, pt, g, bc, rho_g, inf, inf, math.inf, iter_max=10, nout=5,
                        pallas_lean=True)
    b, ib = solve_ve_3d(st, pt, g, bc, rho_g, inf, inf, math.inf, iter_max=10, nout=5)
    assert ia.iters == ib.iters and torch.equal(a.V.Vz, b.V.Vz)


# ---- the models -------------------------------------------------------------
def _burstedde_force():
    eta, (X, Y, Z) = burstedde._viscosity(*Geometry(NI, (1.0,) * 3).xci, burstedde.BETA)
    return max(float(np.abs(f).max()) for f in burstedde._body_forces(X, Y, Z, eta,
                                                                       burstedde.BETA))


# each model's run at 8³ for 200 iterations, the iterations it takes, and the
# size of its body force. At 8³ no cell centre lies within the default
# inclusion radius: the viscosity is uniform, pure shear is exact, the first
# chunk's residual is 0 and 0/0 stops the loop, as in JAX.
_MODELS = {
    "solvi3d": (lambda: solvi3d.run(nx=N, ny=N, nz=N, rc=2.0, iter_max=200, nout=100,
                                    device="cpu"),
                lambda: jsolvi3d.run(nx=N, ny=N, nz=N, rc=2.0, iter_max=200, nout=100),
                lambda: 0.0),
    "solvi3d_uniform": (lambda: solvi3d.run(nx=N, ny=N, nz=N, iter_max=200, nout=100,
                                            device="cpu"),
                        lambda: jsolvi3d.run(nx=N, ny=N, nz=N, iter_max=200, nout=100),
                        lambda: 0.0),
    "burstedde": (lambda: burstedde.run(nx=N, ny=N, nz=N, iter_max=200, nout=100, device="cpu"),
                  lambda: jburstedde.run(nx=N, ny=N, nz=N, iter_max=200, nout=100),
                  _burstedde_force),
    "taylor_green": (lambda: taylor_green.run(n=N, iter_max=200, nout=100, device="cpu"),
                     lambda: jtaylor_green.run(n=N, iter_max=200, nout=100),
                     lambda: 36.0 * math.pi ** 2),
}


@pytest.mark.parametrize("name", sorted(_MODELS))
def test_model_matches_jax(name):
    port, jax_run, force = _MODELS[name]
    g, p_st, p_info = port()
    _, j_st, j_info = jax_run()
    assert p_st.P.device.type == "cpu"
    assert p_info.iters == (100 if name == "solvi3d_uniform" else 200)
    sc = _state_close(p_st, j_st, g.di, force())
    _info_close(p_info, j_info, sc["residual"])


def test_analytic_fields_match_jax():
    g, jg = Geometry(NI, (1.0, 1.0, 1.0)), JGeometry(NI, (1.0, 1.0, 1.0))
    for a, b in zip(taylor_green.analytic_fields(g), jtaylor_green.analytic_fields(jg)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(burstedde.analytic_velocity(g), jburstedde.analytic_velocity(jg)):
        np.testing.assert_array_equal(a, b)

    # on a stretched grid: the same analytic fields at its own coordinates
    # (its solve is held in tests/test_torch_nonuniform_stokes3d.py)
    s_ = np.linspace(-1.0, 1.0, N + 1)
    xv = 0.5 * (np.tanh(1.2 * s_) / np.tanh(1.2) + 1.0)
    vectors = (xv, np.linspace(0.0, 1.0, N + 1), xv)
    for a, b in zip(taylor_green.analytic_fields(NonuniformGeometry(vectors)),
                    jtaylor_green.analytic_fields(JNonuniformGeometry(vectors))):
        np.testing.assert_array_equal(a, b)


def test_smooth_viscosity_3d():
    """As tests/test_solvi3d.py:30-41, and equal to the JAX function."""
    rng = np.random.default_rng(0)
    eta = rng.uniform(0.1, 1.0, size=(8, 8, 8))
    out = solvi3d.smooth_viscosity_3d(torch.tensor(eta), n_pass=5)
    # Jacobi smoothing with c=1/6.1 < 1/6 is a contraction: bounds preserved
    assert float(out.min()) >= 0.1 - 1e-12 and float(out.max()) <= 1.0 + 1e-12
    np.testing.assert_array_equal(out[0].numpy(), eta[0])  # boundary layer untouched
    ref = np.asarray(jsolvi3d.smooth_viscosity_3d(jnp.asarray(eta), n_pass=5))
    assert np.abs(out.numpy() - ref).max() <= 1e-15
    V = (torch.zeros(9, 10, 10), torch.ones(10, 9, 10), torch.zeros(10, 10, 9))
    g = Geometry(NI, (2.0, 1.0, 3.0))
    a = solvi3d.pureshear_bc_3d(*V, g.xvi, 0.5)
    b = jsolvi3d.pureshear_bc_3d(*(jnp.asarray(v.numpy()) for v in V), g.xvi, 0.5)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


# ---- slow: the JAX package's goldens through the port -------------------------
@pytest.mark.slow
def test_solvi3d_converges():
    """tests/test_solvi3d.py::test_solvi3d_converges through the port."""
    geom, stokes, info = solvi3d.run(device="cpu")
    nrx = info.norm_Rx.numpy()
    assert nrx[np.isfinite(nrx)][-1] < 1.0e-8
    assert int(info.iters) <= 5_000
    Vx = stokes.V.Vx.numpy()
    xv = np.asarray(geom.xvi[0])
    bg = xv[:, None, None] * np.ones_like(Vx)
    mid = slice(Vx.shape[1] // 2 - 2, Vx.shape[1] // 2 + 2)
    assert np.abs(Vx - bg)[:, mid, mid].max() > 1.0e-2
    np.testing.assert_allclose(Vx[0, 1:-1, 1:-1], xv[0], atol=1.0e-12)
    np.testing.assert_allclose(Vx[-1, 1:-1, 1:-1], xv[-1], atol=1.0e-12)


def _tg_errors(n):
    geom, st, info = taylor_green.run(n=n, device="cpu")
    assert float(info.err) < 1.0e-10
    Vxa, Vya, Vza, Pa = taylor_green.analytic_fields(geom)
    Vx = st.V.Vx.numpy()[:, 1:-1, 1:-1]
    Vz = st.V.Vz.numpy()[1:-1, 1:-1, :]
    ev = max(np.abs(Vx - Vxa).max() / np.abs(Vxa).max(),
             np.abs(Vz - Vza).max() / np.abs(Vza).max())
    P = st.P.numpy()
    P = P - P.mean() + Pa.mean()  # pressure defined up to a constant
    return ev, np.abs(P - Pa).max() / np.abs(Pa).max()


@pytest.mark.slow
def test_taylor_green_accuracy_and_convergence():
    """tests/test_taylor_green.py through the port."""
    ev12, ep12 = _tg_errors(12)
    ev24, ep24 = _tg_errors(24)
    assert ev12 < 0.02 and ep12 < 0.04
    assert ev24 < 0.35 * ev12 and ep24 < 0.35 * ep12
    assert ev24 < 4.0e-3 and ep24 < 8.0e-3


def _burstedde_vx_err(n, iter_max):
    geom, stokes, info = burstedde.run(nx=n, ny=n, nz=n, iter_max=iter_max, nout=1_000,
                                       device="cpu")
    X, Y = np.meshgrid(geom.xvi[0], geom.xci[1], indexing="ij")
    vxa = X + X**2 + X * Y + X**3 * Y
    return info, np.abs(stokes.V.Vx.numpy()[:, 1:-1, n // 2] - vxa).max() / np.abs(vxa).max()


@pytest.mark.slow
def test_burstedde_convergence_and_accuracy():
    """tests/test_stokes_burstedde.py through the port."""
    info, rel_err = _burstedde_vx_err(16, 60_000)
    assert float(info.err) < 1.0e-8
    assert rel_err < 2.0e-2


@pytest.mark.slow
def test_burstedde_second_order():
    errs = [_burstedde_vx_err(n, 30_000)[1] for n in (8, 16)]
    assert errs[1] < errs[0] / 2.5
