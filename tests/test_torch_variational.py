"""PyTorch port, ``solve_variational`` (the 2D sticky-air Stokes solve)
against the JAX package on the CPU in float64, at 12²–16²:

- φ ≡ 1 (one phase, a density perturbation through T), which is also
  held to the port's own plain ``solve_vep``;
- the sticky-air blob (dt = ∞), with and without the free-surface
  stabilization (a finite dt, ``mask_step_floor`` 0.3, the air left out of
  the viscosity blend);
- a visco-elasto-plastic power-law crust under air with a
  pressure-dependent density (the nonlinear viscosity refresh, the plastic
  return mapping, no-slip at the bottom);
- ``iter_min`` above ``iter_max`` (the history keeps the last chunk in its
  last row).

Held: equal iterations; every field of the state within 1e-10 of its max
(the momentum residuals, rounding of their terms at convergence, within
1e-10 of max |ρg|, RP and ∇·V within 1e-10 of max |V|/dx); the err history within
1e-10 of its first value. A ``NonuniformGeometry`` of uniform vectors gives
the scalar grid's result.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from justrelax_tpu.core.coeffs import PTStokesCoeffs as JPT
from justrelax_tpu.core.grid import Geometry as JGeometry
from justrelax_tpu.core.state import StokesState as JStokesState
from justrelax_tpu.ops import bc as jbc
from justrelax_tpu.ops.rock_ratio import RockRatio as JRockRatio
from justrelax_tpu.ops.rock_ratio import update_rock_ratio as j_rock
from justrelax_tpu.rheology import materials as jm
from justrelax_tpu.rheology.phases import phase_ratios_from_field as j_ratios
from justrelax_tpu.solvers.stokes2d_variational import solve_variational as j_solve
from justrelax_tpu_torch import convert
from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs as PPT
from justrelax_tpu_torch.core.grid import Geometry as PGeometry
from justrelax_tpu_torch.core.grid import NonuniformGeometry as PNonuniformGeometry
from justrelax_tpu_torch.core.state import StokesState as PStokesState
from justrelax_tpu_torch.ops import bc as pbc
from justrelax_tpu_torch.ops.rock_ratio import RockRatio as PRockRatio
from justrelax_tpu_torch.ops.rock_ratio import update_rock_ratio as p_rock
from justrelax_tpu_torch.rheology import materials as pm
from justrelax_tpu_torch.rheology.phases import phase_ratios_from_field as p_ratios
from justrelax_tpu_torch.solvers.stokes2d_variational import solve_variational as p_solve
from justrelax_tpu_torch.solvers.stokes2d_vep import solve_vep as p_solve_vep
from test_torch_dyrel import _flat, _max_rel

torch.set_num_threads(1)

_FREE_SLIP = dict(left=True, right=True, top=True, bot=True)


def _blob_phases(n, radius=0.15):
    """0 fluid, 1 air (the top quarter), 2 a dense blob."""
    x = (np.arange(n) + 0.5) / n
    X, Y = np.meshgrid(x, x, indexing="ij")
    phase = np.zeros((n, n), dtype=int)
    phase[Y > 0.75] = 1
    phase[(X - 0.5) ** 2 + (Y - 0.4) ** 2 <= radius**2] = 2
    return phase


_BLOB = [dict(rho0=1.0, eta0=1.0, gravity=10.0), dict(rho0=0.0, eta0=1.0e-3, gravity=10.0),
         dict(rho0=2.0, eta0=1.0, gravity=10.0)]
_VEP = [
    dict(rho0=2.0, beta=1.0e-2, eta0=1.0, G=4.0, Kb=20.0, gravity=1.0, disl_A=0.5, disl_n=3.0,
         is_plastic=1.0, C=0.02, friction_angle=20.0, dilation_angle=5.0, eta_reg=1.0e-2),
    dict(rho0=0.0, eta0=1.0e-2, G=4.0, Kb=math.inf, gravity=1.0),
    dict(rho0=3.0, eta0=10.0, G=4.0, Kb=20.0, gravity=1.0),
]

# name → (n, phases, materials, air phase or None, dt, BC faces, solve kwargs, pt kwargs)
CASES = {
    "phi_one": (16, None, [dict(rho0=1.0, alpha=1.0, T0=0.0, eta0=1.0, gravity=1.0)], None,
                math.inf, dict(free_slip=_FREE_SLIP), dict(iter_max=4_000, nout=200), {}),
    "sticky_air": (16, _blob_phases(16), _BLOB, 1, math.inf, dict(free_slip=_FREE_SLIP),
                   dict(iter_max=3_000, nout=200), dict(eps_rel=1e-6)),
    "free_surface": (16, _blob_phases(16), _BLOB, 1, 0.1, dict(free_slip=_FREE_SLIP),
                     dict(iter_max=3_000, nout=200, free_surface=True, mask_step_floor=0.3,
                          air_phase=1), dict(eps_rel=1e-6)),
    "vep_powerlaw": (12, _blob_phases(12, 0.2), _VEP, 1, 0.05,
                     dict(free_slip=dict(left=True, right=True, top=True),
                          no_slip=dict(bot=True)),
                     dict(iter_max=1_000, nout=100, air_phase=1,
                          viscosity_cutoff=(1.0e-3, 1.0e3)), dict(eps_rel=1e-8)),
    "iter_min_over_max": (12, _blob_phases(12), _BLOB, 1, math.inf, dict(free_slip=_FREE_SLIP),
                          dict(iter_max=400, iter_min=600, nout=100), {}),
}


def _inputs(case, pkg):
    n, phases, mats, air, dt, faces, kw, ptkw = CASES[case]
    ni = (n, n)
    x = (np.arange(n) + 0.5) / n
    X, Y = np.meshgrid(x, x, indexing="ij")
    T = -0.1 * np.sin(np.pi * X) * np.sin(np.pi * Y)
    if pkg == "jax":
        geometry = JGeometry(ni, (1.0, 1.0))
        mat = jm.MaterialStack.make([jm.Material(**m) for m in mats])
        bc = jbc.VelocityBoundaryConditions(**{k: jbc.Faces(**v) for k, v in faces.items()})
        pt = JPT.make(geometry.li, geometry.di, CFL=1.0 / math.sqrt(2.1), **ptkw)
        st = JStokesState.make(ni)
        if phases is None:
            prc, prv = jnp.ones(ni + (1,)), jnp.ones((n + 1, n + 1, 1))
            phi = JRockRatio(center=jnp.ones(ni), vertex=jnp.ones((n + 1, n + 1)),
                             Vx=jnp.ones((n + 1, n)), Vy=jnp.ones((n, n + 1)))
        else:
            pr = j_ratios(jnp.asarray(phases), len(mats))
            prc, prv, phi = pr.center, pr.vertex, j_rock(pr, air)
        return st, pt, geometry, bc, mat, prc, prv, phi, dt, jnp.asarray(T), kw
    geometry = PGeometry(ni, (1.0, 1.0))
    mat = pm.MaterialStack.make([pm.Material(**m) for m in mats], device="cpu")
    bc = pbc.VelocityBoundaryConditions(**{k: pbc.Faces(**v) for k, v in faces.items()})
    pt = PPT.make(geometry.li, geometry.di, CFL=1.0 / math.sqrt(2.1), **ptkw)
    st = PStokesState.make(ni, device="cpu")
    f64 = torch.float64
    if phases is None:
        prc, prv = torch.ones(ni + (1,), dtype=f64), torch.ones((n + 1, n + 1, 1), dtype=f64)
        phi = PRockRatio(center=torch.ones(ni, dtype=f64),
                         vertex=torch.ones((n + 1, n + 1), dtype=f64),
                         Vx=torch.ones((n + 1, n), dtype=f64), Vy=torch.ones((n, n + 1), dtype=f64))
    else:
        pr = p_ratios(torch.as_tensor(phases), len(mats))
        prc, prv, phi = pr.center, pr.vertex, p_rock(pr, air)
    return st, pt, geometry, bc, mat, prc, prv, phi, dt, torch.as_tensor(T), kw


def _solve(case, pkg):
    st, pt, geometry, bc, mat, prc, prv, phi, dt, T, kw = _inputs(case, pkg)
    solve = j_solve if pkg == "jax" else p_solve
    return solve(st, pt, geometry, bc, mat, prc, prv, phi, dt, T=T, **kw)


def _held(p_state, j_state, rho_g_max, n):
    """Every field within 1e-10 of its max; the residuals and ∇·V
    (rounding of their terms at convergence) at their terms' scale."""
    p = _flat(convert.to_state_dict(p_state))
    j = _flat(serialization.to_state_dict(j_state))
    vmax = max(np.abs(j["V.Vx"]).max(), np.abs(j["V.Vy"]).max())
    scales = {"R.Rx": rho_g_max, "R.Ry": rho_g_max, "R.RP": vmax * n, "grad_V": vmax * n}
    worst = {k: _max_rel(p[k], j[k], scales.get(k)) for k in j if k in p}
    assert {k for k, v in worst.items() if v > 1e-10} == set(), worst
    return worst


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_variational_matches_jax(case):
    ps, pi = _solve(case, "port")
    js, ji = _solve(case, "jax")
    assert int(pi.iters) == int(ji.iters) > 0
    mats = CASES[case][2]
    rho_g_max = max(m["rho0"] * m["gravity"] for m in mats)
    _held(ps, js, rho_g_max, CASES[case][0])
    jh, ph = np.asarray(ji.err_history), pi.err_history.numpy()
    assert _max_rel(ph, jh, float(jh[0])) <= 1e-10
    for k in ("norm_Rx", "norm_Ry", "norm_RP"):
        assert _max_rel(getattr(pi, k).numpy(), np.asarray(getattr(ji, k)), float(jh[0])) <= 1e-10
    if case == "iter_min_over_max":
        assert int(pi.iters) == 600 and ph.shape == (4,) and np.isfinite(ph).all()
    if case == "vep_powerlaw":
        assert float(ps.lam.max()) > 0.0  # the return mapping acted


def test_phi_one_matches_plain_vep():
    """φ ≡ 1: the port's variational solve is the port's plain VEP solve
    (tests/test_variational.py's oracle, at its 1e-12)."""
    st, pt, geometry, bc, mat, prc, prv, phi, dt, T, kw = _inputs("phi_one", "port")
    sv, iv = p_solve(st, pt, geometry, bc, mat, prc, prv, phi, dt, T=T, **kw)
    sp, ip = p_solve_vep(st, pt, geometry, bc, mat, prc, prv, dt, T=T, use_kernel=False, **kw)
    assert int(iv.iters) == int(ip.iters)
    for a, b in ((sv.V.Vx, sp.V.Vx), (sv.V.Vy, sp.V.Vy), (sv.P, sp.P)):
        assert float((a - b).abs().max()) <= 1e-12


def test_nonuniform_geometry_raises():
    """A nonuniform grid, once refused: uniform vectors give the scalar
    grid's result (tests/test_nonuniform_stokes.py's 1e-12; stretched grids
    against JAX in tests/test_torch_nonuniform_stokes.py)."""
    st, pt, geometry, bc, mat, prc, prv, phi, dt, T, kw = _inputs("sticky_air", "port")
    nonuniform = PNonuniformGeometry(tuple(np.linspace(0.0, 1.0, n + 1) for n in geometry.ni))
    kw = dict(kw, iter_max=400, nout=200)
    a, ia = p_solve(st, pt, nonuniform, bc, mat, prc, prv, phi, dt, **kw)
    b, ib = p_solve(st, pt, geometry, bc, mat, prc, prv, phi, dt, **kw)
    assert int(ia.iters) == int(ib.iters)
    for u, v in ((a.V.Vy, b.V.Vy), (a.P, b.P)):
        assert float((u - v).abs().max()) <= 1e-12
