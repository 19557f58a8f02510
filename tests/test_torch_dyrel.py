"""PyTorch port, the DYREL solver against the JAX package on the CPU in
float64:

- its pieces (penalty, Gershgorin bounds, the damping coefficients, the
  per-phase VEP stress) on random inputs, at 1e-15 of each output's max,
  beside the closed forms of tests/test_interpolations_units.py;
- one DR chunk from the state after a step, against JAX's solve cut to one
  chunk (``max_ph=1``, ``iter_max=nout``), at 1e-13 of each field's max;
- ``solve_dyrel`` on the shear band, its tension-cap variant, the
  power-law refresh (``linear_viscosity=False``) with T, the sinking block
  with ``rho_g``, an ``alpha_dT`` source, ``max_ph`` and ``total_iter_max``
  reached before convergence and a state with no forcing: equal
  iterations, err within 1e-10, every field within 1e-10 of its max. A
  residual, which at convergence is rounding of its equation's terms, is
  held to its terms' scale: ``R.*`` to max |V| for the preconditioned
  momentum residuals and max |∇·V| for RP, err (the outer residual norms
  over their first values, so 1 at the start) to 1;
- the Gershgorin bound on a stretched grid's spacing families.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from justrelax_tpu.core.grid import Geometry as JGeometry
from justrelax_tpu.core.state import StokesState as JStokesState
from justrelax_tpu.models.shearband import _circle_phase_ratios
from justrelax_tpu.ops import bc as jbc
from justrelax_tpu.rheology import materials as jm
from justrelax_tpu.rheology.viscosity import phase_viscosity as j_phase_viscosity
from justrelax_tpu.solvers import dyrel as jd
from justrelax_tpu_torch import convert
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.ops import bc as pbc
from justrelax_tpu_torch.rheology import materials as pm
from justrelax_tpu_torch.solvers import dyrel as pd

torch.set_num_threads(1)

_C = 1.6 / math.cos(math.radians(30.0))
_BAND = dict(rho0=0.0, Kb=5.0, eta0=1.0, is_plastic=1.0, C=_C, friction_angle=30.0,
             dilation_angle=0.0, eta_reg=1.0e-2)
_BC = dict(free_slip=dict(left=True, right=True, top=True, bot=True))


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif v is not None:
            out[prefix + k] = np.asarray(v)
    return out


def _max_rel(a, b, scale=None):
    """max |a − b| over ``scale`` (default max |b|), nan positions equal."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    na, nb = np.isnan(a), np.isnan(b)
    assert (na == nb).all()
    fin = ~nb
    ia, ib = np.isinf(a) & fin, np.isinf(b) & fin
    assert (ia == ib).all() and (a[ib] == b[ib]).all()
    fin &= ~ib
    d = np.abs(a[fin] - b[fin]).max(initial=0.0)
    if scale is None:
        scale = np.abs(b[fin]).max(initial=0.0)
    return 0.0 if d == 0.0 else d / scale


# --- the pieces ---------------------------------------------------------------
_PHASES = [
    dict(G=0.0, Kb=4.0, eta0=1.0, is_plastic=1.0, C=1.2, friction_angle=30.0,
         dilation_angle=0.0, eta_reg=1e-2),                       # G = 0: ∞
    dict(G=1.0, Kb=math.nan, eta0=2.0, is_plastic=1.0, C=0.9, friction_angle=25.0,
         dilation_angle=5.0, eta_reg=5e-3),                       # Kb = nan: ∞
    dict(G=0.5, Kb=3.0, eta0=0.5, is_plastic=1.0, C=1.0, friction_angle=30.0,
         dilation_angle=3.0, eta_reg=1e-3, tension_pT=-0.5),      # cap, dilation
    dict(G=2.0, Kb=6.0, eta0=1.0, is_plastic=0.0),                # elastic
]


def _random_inputs(shape, nphase, seed):
    rng = np.random.default_rng(seed)
    eps = [rng.normal(0.0, 1.0, shape) for _ in range(3)]
    for e in eps:  # cells with ε̇II = 0
        e[:2, :3] = 0.0
    tau_o = [rng.normal(0.0, 0.5, shape) for _ in range(3)]
    for t in tau_o:
        t[:2, :2] = 0.0
    eta = rng.uniform(0.3, 3.0, shape)
    P = rng.normal(0.0, 1.0, shape)  # both signs: the cap acts where P < 0
    lam = rng.uniform(0.0, 0.1, shape)
    pr = rng.uniform(0.0, 1.0, shape + (nphase,))
    pr[::3] = np.eye(nphase)[rng.integers(0, nphase, shape)][::3]  # one-hot rows
    pr /= pr.sum(axis=-1, keepdims=True)
    return eps, tau_o, eta, P, lam, pr


@pytest.mark.parametrize("dt", [0.25, math.inf])
@pytest.mark.parametrize("lam_relax", [1.0, 0.7])
@pytest.mark.parametrize("phases", [(0, 1, 2), (2, 3), (1,)])
def test_local_stress_matches_jax(phases, lam_relax, dt):
    mats = [_PHASES[p] for p in phases]
    eps, tau_o, eta, P, lam, pr = _random_inputs((9, 7), len(mats), seed=len(phases))
    j = jd._local_stress(tuple(map(jnp.asarray, eps)), tuple(map(jnp.asarray, tau_o)),
                         jnp.asarray(eta), jnp.asarray(P), jnp.asarray(lam), lam_relax,
                         jm.MaterialStack.make([jm.Material(**m) for m in mats]),
                         jnp.asarray(pr), dt, None)
    t = torch.as_tensor
    p = pd._local_stress(tuple(map(t, eps)), tuple(map(t, tau_o)), t(eta), t(P), t(lam),
                         lam_relax, pm.MaterialStack.make([pm.Material(**m) for m in mats],
                                                          device="cpu"),
                         t(pr), dt, None)
    assert len(p) == len(j) == 11
    if dt == 0.25 and 1 in phases:
        assert float(jnp.max(j[7])) > 0.0  # plasticity acts
    for k, (a, b) in enumerate(zip(p, j)):
        assert _max_rel(a.numpy(), b) <= 1e-15, k


def test_penalty_and_gershgorin_match_jax():
    rng = np.random.default_rng(3)
    ni = (9, 7)
    mats = [_PHASES[0], _PHASES[1], _PHASES[2]]
    eta = rng.uniform(0.3, 3.0, ni)
    eta[2, 3] = np.inf  # an ∞ cell takes the mean of the finite ones
    eta_v = rng.uniform(0.3, 3.0, (10, 8))
    pr_c = rng.dirichlet(np.ones(3), ni)
    pr_v = rng.dirichlet(np.ones(3), (10, 8))
    jmat = jm.MaterialStack.make([jm.Material(**m) for m in mats])
    pmat = pm.MaterialStack.make([pm.Material(**m) for m in mats], device="cpu")
    t = torch.as_tensor
    for dt in (0.3, math.inf):
        jk, jg = jd.compute_bulk_viscosity_and_penalty(jmat, jnp.asarray(pr_c), jnp.asarray(eta),
                                                       20.0, dt)
        pk, pg = pd.compute_bulk_viscosity_and_penalty(pmat, t(pr_c), t(eta), 20.0, dt)
        assert _max_rel(pk.numpy(), jk) <= 1e-15 and _max_rel(pg.numpy(), jg) <= 1e-15
        eta_f = np.where(np.isinf(eta), 1.0, eta)
        j4 = jd.gershgorin_schur_2d(jnp.asarray(eta_f), jnp.asarray(eta_v), jg, jnp.asarray(pr_c),
                                    jnp.asarray(pr_v), jmat, (0.1, 0.125), dt)
        p4 = pd.gershgorin_schur_2d(t(eta_f), t(eta_v), pg, t(pr_c), t(pr_v), pmat,
                                    (0.1, 0.125), dt)
        for a, b in zip(p4, j4):
            assert _max_rel(a.numpy(), b) <= 1e-15
    lmax = rng.uniform(1.0, 50.0, (5, 4))
    for a, b in zip(pd._alpha_beta(t(lmax), torch.tensor(0.3, dtype=torch.float64), 0.99),
                    jd._alpha_beta(jnp.asarray(lmax), jnp.asarray(0.3), 0.99)):
        assert _max_rel(a.numpy(), b) <= 1e-15


def test_closed_forms():
    """tests/test_interpolations_units.py's closed forms on the port."""
    f64 = dict(dtype=torch.float64)
    dtau, alpha, beta = pd._alpha_beta(torch.tensor(16.0, **f64), torch.tensor(0.5, **f64), 0.99)
    d = 2.0 / 4.0 * 0.99
    assert float(dtau) == d
    np.testing.assert_allclose(float(alpha), (2.0 - 0.5 * d) / (2.0 + 0.5 * d))
    np.testing.assert_allclose(float(beta), 2.0 * d / (2.0 + 0.5 * d))

    ni = (4, 4)
    pr = torch.ones(ni + (1,), dtype=torch.float64)
    eta = torch.full(ni, 2.0, dtype=torch.float64)
    mat = pm.MaterialStack.make([pm.Material(Kb=8.0, G=1.0)], device="cpu")
    _, g_eff = pd.compute_bulk_viscosity_and_penalty(mat, pr, eta, gfact=10.0, dt=0.5)
    gn, gp = 10.0 * 2.0, 8.0 * 0.5
    np.testing.assert_allclose(g_eff.numpy(), gp * gn / (gp + gn))
    mat_i = pm.MaterialStack.make([pm.Material(Kb=math.inf, G=1.0)], device="cpu")
    _, g_inf = pd.compute_bulk_viscosity_and_penalty(mat_i, pr, eta, gfact=10.0, dt=0.5)
    np.testing.assert_allclose(g_inf.numpy(), gn / 2.0)

    ni = (6, 5)
    eta0, gamma0 = 2.0, 7.0
    f = dict(dtype=torch.float64)
    mat = pm.MaterialStack.make([pm.Material(G=math.inf, Kb=math.inf)], device="cpu")
    di = (0.25, 0.2)
    Dx, Dy, lx, ly = pd.gershgorin_schur_2d(
        torch.full(ni, eta0, **f), torch.full((7, 6), eta0, **f), torch.full(ni, gamma0, **f),
        torch.ones(ni + (1,), **f), torch.ones((7, 6, 1), **f), mat, di, dt=1.0)
    _dx, _dy = 1.0 / di[0], 1.0 / di[1]
    Dx_want = 2 * eta0 * _dy**2 + (2 * gamma0 + 8.0 / 3.0 * eta0) * _dx**2
    np.testing.assert_allclose(Dx.numpy(), Dx_want)
    Cxx = 2 * eta0 * _dy**2 + 2 * (gamma0 + 4.0 / 3.0 * eta0) * _dx**2 + Dx_want
    Cxy = 4 * abs(gamma0 - 2.0 / 3.0 * eta0 + eta0) * _dx * _dy
    np.testing.assert_allclose(lx.numpy(), (Cxx + Cxy) / Dx_want)
    Dy_want = (2 * gamma0 + 8.0 / 3.0 * eta0) * _dy**2 + 2 * eta0 * _dx**2
    np.testing.assert_allclose(Dy.numpy(), Dy_want)
    assert np.all(ly.numpy() > 1.0)


# --- set-ups of the solve -------------------------------------------------------
def _band_state(n, boundary_only=True):
    """The DYREL shear band's initial state (tests/test_dyrel.py)."""
    jg = JGeometry((n, n), (1.0, 1.0))
    st = JStokesState.make((n, n))
    xv, yv = jnp.asarray(jg.xvi[0]), jnp.asarray(jg.xvi[1])
    Vx = jnp.broadcast_to(xv[:, None], (n + 1, n + 2))
    Vy = jnp.broadcast_to(-yv[None, :], (n + 2, n + 1))
    if boundary_only:
        Vx, Vy = Vx.at[1:-1, 1:-1].set(0.0), Vy.at[1:-1, 1:-1].set(0.0)
    Vx, Vy = jbc.flow_bcs((Vx, Vy), jbc.VelocityBoundaryConditions(**_BC))
    pr_c = _circle_phase_ratios(jg.xci[0], jg.xci[1], (0.5, 0.5), 0.1)
    pr_v = _circle_phase_ratios(jg.xvi[0], jg.xvi[1], (0.5, 0.5), 0.1)
    return st.replace(V=st.V.replace(Vx=Vx, Vy=Vy)), pr_c, pr_v


def _band(n, cap=False, **extra):
    common = dict(_BAND, **extra)
    if cap:
        common.update(Kb=4.0, dilation_angle=3.0, eta_reg=1e-3, tension_pT=-0.5)
    st, pr_c, pr_v = _band_state(n, boundary_only=not cap)
    return dict(state=st, mats=[dict(G=1.0, **common), dict(G=0.5, **common)], pr=(pr_c, pr_v),
                dt=0.125 if cap else 0.25, n=n, kw=dict(eps=1e-6, nout=50, rel_drop=0.5))


def _nonlinear(n, T=None):
    """tests/test_dyrel_nonlinear.py's set-up (dislocation creep, n = 3)."""
    common = dict(rho0=0.0, Kb=4.0, is_plastic=1.0, C=_C, friction_angle=30.0, eta_reg=8e-3)
    E = {} if T is None else dict(disl_E=2.0e3)
    mats = [dict(G=1.0, disl_A=0.5, disl_n=3.0, **common, **E),
            dict(G=0.5, disl_A=5.0, disl_n=3.0, **common, **E)]
    st, _, _ = _band_state(n, boundary_only=False)
    jg = JGeometry((n, n), (1.0, 1.0))

    def circ(xs, ys):
        X, Y = np.meshgrid(np.asarray(xs), np.asarray(ys), indexing="ij")
        inside = (X - 0.5) ** 2 + (Y - 0.5) ** 2 < 0.01
        return np.stack([~inside, inside], axis=-1).astype(float)

    prc, prv = circ(jg.xci[0], jg.xci[1]), circ(jg.xvi[0], jg.xvi[1])
    jmat = jm.MaterialStack.make([jm.Material(**m) for m in mats])
    eta0 = j_phase_viscosity(jmat, jnp.ones((n, n)), None, jnp.asarray(prc), "eps")
    eta0v = j_phase_viscosity(jmat, jnp.ones((n + 1, n + 1)), None, jnp.asarray(prv), "eps")
    st = st.replace(viscosity=st.viscosity.replace(eta=eta0, eta_v=eta0v))
    kw = dict(linear_viscosity=False, viscosity_relaxation=0.5, viscosity_cutoff=(1e-3, 1e3),
              eps=1e-6, nout=100, iter_max=20_000, total_iter_max=200_000)
    if T is not None:
        kw["T"] = T
    return dict(state=st, mats=mats, pr=(prc, prv), dt=0.25, n=n, kw=kw)


def _sinking_block(n):
    """tests/test_sinking_block_dyrel.py's set-up (SI units, gravity)."""
    from justrelax_tpu.rheology.phases import phase_ratios_from_field

    ly = 500.0e3
    jg = JGeometry((n, n), (ly, ly), origin=(0.0, -ly))
    mats = [dict(rho0=3.2e3, eta0=1.0e21, gravity=9.81), dict(rho0=3.3e3, eta0=1.0e23, gravity=9.81)]
    X, Y = jg.cell_centers_mesh()
    block = (np.abs(X - 250.0e3) <= 50.0e3) & (np.abs(-Y - 100.0e3) <= 50.0e3)
    pr = phase_ratios_from_field(jnp.asarray(block.astype(int)), 2)
    jmat = jm.MaterialStack.make([jm.Material(**m) for m in mats])
    eta0_v = j_phase_viscosity(jmat, jnp.ones((n + 1, n + 1)), None, pr.vertex, "tau")
    rho = np.where(block, 3.3e3, 3.2e3)
    st = JStokesState.make((n, n))
    st = st.replace(P=jnp.asarray(rho * 9.81 * np.abs(Y)), viscosity=st.viscosity.replace(
        eta=jnp.asarray(np.where(block, 1.0e23, 1.0e21)), eta_v=eta0_v))
    return dict(state=st, mats=mats, pr=(np.asarray(pr.center), np.asarray(pr.vertex)), dt=1.0,
                n=n, geometry=dict(li=(ly, ly), origin=(0.0, -ly)),
                kw=dict(rho_g=(np.zeros((n, n)), rho * 9.81), eps=1.0e-7, nout=100))


def _run_both(c, port=True):
    """The JAX and (with ``port``) the port's ``solve_dyrel`` on the set-up
    ``c``."""
    n = c["n"]
    geo = c.get("geometry", dict(li=(1.0, 1.0), origin=(0.0, 0.0)))
    jg = JGeometry((n, n), geo["li"], origin=geo["origin"])
    g = Geometry((n, n), geo["li"], origin=geo["origin"])
    jkw, pkw = dict(c["kw"]), dict(c["kw"])
    for k in ("rho_g",):
        if k in jkw:
            jkw[k] = tuple(jnp.asarray(a) for a in jkw[k])
            pkw[k] = tuple(torch.as_tensor(np.asarray(a)) for a in pkw[k])
    for k in ("T", "alpha_dT"):
        if k in jkw:
            jkw[k], pkw[k] = jnp.asarray(jkw[k]), torch.as_tensor(np.asarray(pkw[k]))
    j_out, j_info = jd.solve_dyrel(
        c["state"], jg, jbc.VelocityBoundaryConditions(**_BC),
        jm.MaterialStack.make([jm.Material(**m) for m in c["mats"]]),
        jnp.asarray(c["pr"][0]), jnp.asarray(c["pr"][1]), c["dt"], **jkw)
    if not port:
        return j_out, j_info, None, None
    pst = convert.stokes_state_from_dict(serialization.to_state_dict(c["state"]), device="cpu")
    p_out, p_info = pd.solve_dyrel(
        pst, g, pbc.VelocityBoundaryConditions(**_BC),
        pm.MaterialStack.make([pm.Material(**m) for m in c["mats"]], device="cpu"),
        torch.as_tensor(np.array(c["pr"][0])), torch.as_tensor(np.array(c["pr"][1])),
        c["dt"], **pkw)
    return j_out, j_info, p_out, p_info


def _assert_solve_matches(j_out, j_info, p_out, p_info):
    assert p_info.iters == int(j_info.iters)
    je, pe = float(j_info.err), float(p_info.err)
    # err is the norm of a residual at convergence, where its relative
    # rounding is large (up to 5.3e-6 in these cases, the sinking block at
    # err 1.2e-9) while the absolute difference stays at 6.3e-15 or less:
    # held to 1e-13 absolute (PERF.md; ``-s`` prints the readings)
    print(f"err JAX {je!r} port {pe!r}: |diff| {abs(pe - je)!r}, relative "
          f"{abs(pe - je) / abs(je) if je else 0.0!r}")
    assert abs(pe - je) <= 1e-13, (pe, je)
    a = _flat(convert.to_state_dict(p_out))
    b = _flat(serialization.to_state_dict(j_out))
    assert a.keys() == b.keys()
    vmax = max(np.abs(b["V.Vx"]).max(), np.abs(b["V.Vy"]).max())
    divmax = np.abs(b["grad_V"]).max()
    scales = {"R.Rx": vmax, "R.Ry": vmax, "R.RP": divmax}
    for k in a:
        assert _max_rel(a[k], b[k], scales.get(k)) <= 1e-10, k


def _mid_step(c, solve_kw):
    """``c`` with its state advanced by one JAX solve (a state after a
    step: V, P, τ_o and η non-trivial)."""
    j_out, _, _, _ = _run_both(dict(c, kw=dict(c["kw"], **solve_kw)), port=False)
    return dict(c, state=j_out.replace(tau_o=j_out.tau))


@pytest.mark.parametrize("case", ["band", "cap", "nonlinear"])
def test_chunk_matches_jax(case):
    """The port's chunk (``_DyrelSolve.chunk``) from the state after a step
    against JAX's solve cut to its first chunk."""
    c = {"band": lambda: _band(10), "cap": lambda: _band(10, cap=True),
         "nonlinear": lambda: _nonlinear(10)}[case]()
    c = _mid_step(c, dict(total_iter_max=300, iter_max=300))
    if case != "nonlinear":  # old stresses near yield, so that the return mapping acts
        c["state"] = c["state"].replace(tau_o=c["state"].tau_o.replace(**{
            k: 8.0 * getattr(c["state"].tau_o, k) for k in ("xx", "yy", "xy", "xy_c", "xx_v",
                                                            "yy_v")}))
    nout = 40
    c["kw"] = dict(c["kw"], max_ph=1, iter_max=nout, nout=nout)
    j_out, j_info, _, _ = _run_both(c, port=False)
    assert int(j_info.iters) == nout
    n = c["n"]
    st = convert.stokes_state_from_dict(serialization.to_state_dict(c["state"]), device="cpu")
    kw = c["kw"]
    s = pd._DyrelSolve(
        st, Geometry((n, n), (1.0, 1.0)), pbc.VelocityBoundaryConditions(**_BC),
        pm.MaterialStack.make([pm.Material(**m) for m in c["mats"]], device="cpu"),
        torch.as_tensor(c["pr"][0]), torch.as_tensor(c["pr"][1]), c["dt"], None, 20.0, 1.0,
        kw.get("linear_viscosity", True), kw.get("viscosity_relaxation", 1e-2),
        kw.get("viscosity_cutoff", (-math.inf, math.inf)), None, None)
    s.set_P(st.P)
    s.set_tuning(torch.tensor(0.0, dtype=torch.float64), 0.99)
    s.chunk(nout)
    assert float(np.abs(np.asarray(j_out.lam)).max()) > 0.0 or case == "nonlinear"
    pairs = {"Vx": (s.Vx, j_out.V.Vx), "Vy": (s.Vy, j_out.V.Vy), "lam": (s.lam, j_out.lam),
             "lam_v": (s.lam_v, j_out.lam_v), "eta": (s.eta, j_out.viscosity.eta),
             "eta_v": (s.eta_v, j_out.viscosity.eta_v), "Rx": (s.Rx, j_out.R.Rx),
             "Ry": (s.Ry, j_out.R.Ry)}
    vmax = max(float(np.abs(np.asarray(j_out.V.Vx)).max()), float(np.abs(np.asarray(j_out.V.Vy)).max()))
    for k, (a, b) in pairs.items():
        assert _max_rel(a.numpy(), b, vmax if k in ("Rx", "Ry") else None) <= 1e-13, k


_SOLVES = {
    "band_nt2": lambda: [_band(12), _band(12)],
    "cap": lambda: [_band(12, cap=True)],
    "nonlinear_T": lambda: [_nonlinear(12, T=np.random.default_rng(5).uniform(800.0, 1200.0,
                                                                              (12, 12)))],
    "sinking_block_rho_g": lambda: [_sinking_block(12)],
    "alpha_dT": lambda: [dict(_band(10), kw=dict(_band(10)["kw"], alpha_dT=0.02 * np.random.
                                                  default_rng(6).normal(size=(10, 10))))],
    "max_ph": lambda: [dict(_band(12), kw=dict(_band(12)["kw"], max_ph=2))],
    "total_iter_max": lambda: [dict(_band(12), kw=dict(_band(12)["kw"], total_iter_max=200))],
}


@pytest.mark.parametrize("case", sorted(_SOLVES))
def test_solve_dyrel_matches_jax(case):
    cases = _SOLVES[case]()
    state = None
    for step, c in enumerate(cases):
        if state is not None:  # the next step from JAX's state
            c = dict(c, state=state.replace(tau_o=state.tau))
        j_out, j_info, p_out, p_info = _run_both(c)
        _assert_solve_matches(j_out, j_info, p_out, p_info)
        state = j_out
    if case == "total_iter_max":
        assert p_info.iters == 200 and float(p_info.err) > 1e-6  # stopped before converging
    if case == "max_ph":
        assert float(p_info.err) > 1e-6


def test_solve_dyrel_no_forcing():
    """A state at rest with no forcing: every residual is 0, so the first
    check passes and no DR iteration runs."""
    c = _band(8)
    st = JStokesState.make((8, 8))
    j_out, j_info, p_out, p_info = _run_both(dict(c, state=st))
    assert p_info.iters == int(j_info.iters) == 0
    _assert_solve_matches(j_out, j_info, p_out, p_info)


def test_nonuniform_raises():
    """A nonuniform grid, refused before ``NonuniformGeometry`` was ported:
    now the Gershgorin bound with a stretched grid's spacing families
    against JAX's (1e-15; its solve is held in
    tests/test_torch_nonuniform_stokes.py)."""
    rng = np.random.default_rng(4)
    ni = (9, 7)
    s = [np.linspace(-1.0, 1.0, n + 1) for n in ni]
    xv = [0.5 * (np.tanh(1.5 * v) / np.tanh(1.5) + 1.0) for v in s]
    dc = [np.diff(v) for v in xv]
    dv = [np.concatenate(([d[0]], np.diff(0.5 * (v[1:] + v[:-1])), [d[-1]])) for v, d in
          zip(xv, dc)]
    spacings = (dc[0][:, None], dc[1][None, :], dv[0][:, None], dv[1][None, :])
    mats = [_PHASES[0], _PHASES[2]]
    eta, eta_v = rng.uniform(0.3, 3.0, ni), rng.uniform(0.3, 3.0, (10, 8))
    gamma = rng.uniform(1.0, 20.0, ni)
    pr_c, pr_v = rng.dirichlet(np.ones(2), ni), rng.dirichlet(np.ones(2), (10, 8))
    jmat = jm.MaterialStack.make([jm.Material(**m) for m in mats])
    pmat = pm.MaterialStack.make([pm.Material(**m) for m in mats], device="cpu")
    t = torch.as_tensor
    j4 = jd.gershgorin_schur_2d(*map(jnp.asarray, (eta, eta_v, gamma, pr_c, pr_v)), jmat,
                                (0.1, 0.125), 0.3, spacings=tuple(map(jnp.asarray, spacings)))
    p4 = pd.gershgorin_schur_2d(*map(t, (eta, eta_v, gamma, pr_c, pr_v)), pmat, (0.1, 0.125),
                                0.3, spacings=spacings)
    for a, b in zip(p4, j4):
        assert a.shape == b.shape and _max_rel(a.numpy(), b) <= 1e-15
