"""PyTorch port, the 3D masked solves against the JAX package on the CPU
in float64:

- ``solve_variational_3d`` at 8³: φ ≡ 1 (also held to the port's own plain
  ``solve_ve_3d``, tests/test_variational3d.py's oracle at its 1e-13), a
  dense sphere under sticky air (dt = ∞), and a visco-elastic one with a
  finite dt, no-slip at the bottom and a horizontal body force;
- the masked ``solve_vep_3d(phi=...)`` at 6³: a plastic crust, a stiff
  sphere and sticky air, elastic, with the return mapping acting.

Held: equal iterations; every field within 1e-10 of its max (the momentum
residuals, rounding of their terms at convergence, within 1e-10 of max
|ρg|; RP and ∇·V within 1e-10 of max |V|/dx); the err history within
1e-10 of its first value. Every kernel route of ``solve_vep_3d`` with
``phi`` raises ``ValueError`` naming ``use_kernel=False``, and so does the
default route as on the card.
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
from justrelax_tpu.ops.rock_ratio import update_rock_ratio_3d as j_rock
from justrelax_tpu.rheology import materials as jm
from justrelax_tpu.rheology.phases import phase_ratios_from_field as j_ratios
from justrelax_tpu.solvers.stokes3d_variational import solve_variational_3d as j_var3d
from justrelax_tpu.solvers.stokes3d_vep import solve_vep_3d as j_vep3d
from justrelax_tpu_torch import convert
from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs as PPT
from justrelax_tpu_torch.core.grid import Geometry as PGeometry
from justrelax_tpu_torch.core.state import StokesState as PStokesState
from justrelax_tpu_torch.ops import bc as pbc
from justrelax_tpu_torch.ops.rock_ratio import update_rock_ratio_3d as p_rock
from justrelax_tpu_torch.rheology import materials as pm
from justrelax_tpu_torch.rheology.phases import phase_ratios_from_field as p_ratios
from justrelax_tpu_torch.solvers import stokes3d_vep as p_vep3d_mod
from justrelax_tpu_torch.solvers.stokes3d import solve_ve_3d as p_ve3d
from justrelax_tpu_torch.solvers.stokes3d_variational import solve_variational_3d as p_var3d
from test_torch_dyrel import _flat, _max_rel

torch.set_num_threads(1)

_ALL = ("left", "right", "top", "bot", "front", "back")


def _mesh(ni):
    return np.meshgrid(*[(np.arange(n) + 0.5) / n for n in ni], indexing="ij")


def _sphere_phases(ni, air_z=0.7, r=0.25):
    """0 fluid, 1 a sphere, 2 air above ``air_z``."""
    x, y, z = _mesh(ni)
    sphere = (x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.4) ** 2 < r**2
    return np.where(z > air_z, 2, np.where(sphere, 1, 0))


def _bc(pkg, faces):
    b = jbc if pkg == "jax" else pbc
    return b.VelocityBoundaryConditions(**{k: b.Faces(**{f: True for f in v})
                                           for k, v in faces.items()})


# name → (phases or None, G, dt, BC faces, horizontal body force)
VAR_CASES = {
    "phi_one": (None, math.inf, math.inf, dict(free_slip=_ALL), False),
    "sticky_air": (_sphere_phases((8, 8, 8)), math.inf, math.inf, dict(free_slip=_ALL), False),
    "visco_elastic": (_sphere_phases((8, 8, 8)), 2.0, 0.3,
                      dict(free_slip=("left", "right", "top", "front", "back"),
                           no_slip=("bot",)), True),
}


def _var_inputs(case, pkg):
    ni = (8, 8, 8)
    phases, G, dt, faces, fxy = VAR_CASES[case]
    rng = np.random.default_rng(1)
    eta = np.exp(rng.normal(size=ni) * 0.3)
    rho = 1.0 + 0.1 * rng.normal(size=ni)
    fx = 0.05 * rng.normal(size=ni) if fxy else np.zeros(ni)
    if phases is not None:
        eta = np.where(phases == 1, 10.0, eta)
        rho = np.where(phases == 2, 0.0, np.where(phases == 1, 2.0, rho))
        fx = np.where(phases == 2, 0.0, fx)
    if pkg == "jax":
        a, geometry, Pt = jnp.asarray, JGeometry(ni, (1.0, 1.0, 1.0)), JPT
        st = JStokesState.make(ni)
        ratios, rock = j_ratios, j_rock
        Gf, K = jnp.full(ni, G), jnp.asarray(jnp.inf)
    else:
        a, geometry, st, Pt = torch.as_tensor, PGeometry(ni, (1.0, 1.0, 1.0)), \
            PStokesState.make(ni, device="cpu"), PPT
        ratios, rock = p_ratios, p_rock
        Gf, K = torch.full(ni, G, dtype=torch.float64), torch.tensor(math.inf, dtype=torch.float64)
    pr = ratios(a(np.zeros(ni, dtype=int) if phases is None else phases), 3)
    phi = rock(pr, 2)
    st = st.replace(viscosity=st.viscosity.replace(eta=a(eta)))
    pt = Pt.make(geometry.li, geometry.di, CFL=1.0 / math.sqrt(3.0), eps_rel=1.0e-6)
    return st, pt, geometry, _bc(pkg, faces), (a(fx), a(np.zeros(ni)), a(rho)), Gf, K, phi, dt


def _held(p_state, j_state, scale_R, n):
    p = _flat(convert.to_state_dict(p_state))
    j = _flat(serialization.to_state_dict(j_state))
    vmax = max(np.abs(j[f"V.{k}"]).max() for k in ("Vx", "Vy", "Vz"))
    scales = {"R.Rx": scale_R, "R.Ry": scale_R, "R.Rz": scale_R, "R.RP": vmax * n,
              "grad_V": vmax * n}
    worst = {k: _max_rel(p[k], j[k], scales.get(k)) for k in j if k in p}
    assert {k for k, v in worst.items() if v > 1e-10} == set(), worst


def _same_info(pi, ji):
    assert int(pi.iters) == int(ji.iters) > 0
    jh, ph = np.asarray(ji.err_history), pi.err_history.numpy()
    assert _max_rel(ph, jh, float(jh[0])) <= 1e-10


@pytest.mark.parametrize("case", sorted(VAR_CASES))
def test_solve_variational_3d_matches_jax(case):
    kw = dict(iter_max=2_000, nout=200)
    ps, pi = p_var3d(*_var_inputs(case, "port"), **kw)
    js, ji = j_var3d(*_var_inputs(case, "jax"), **kw)
    _same_info(pi, ji)
    _held(ps, js, 2.0, 8)
    assert float(ps.V.Vz.abs().max()) > 0.0


def test_phi_one_matches_plain_ve_3d():
    st, pt, geometry, bc, rho_g, G, K, phi, dt = _var_inputs("phi_one", "port")
    sv, _ = p_var3d(st, pt, geometry, bc, rho_g, G, K, phi, dt, iter_max=200, nout=100)
    sp, _ = p_ve3d(st, pt, geometry, bc, rho_g, G, K, dt, iter_max=200, nout=100,
                   use_kernel=False)
    for a, b in ((sv.V.Vz, sp.V.Vz), (sv.P, sp.P)):
        assert float((a - b).abs().max()) <= 1e-13


_VEP_MATS = [
    dict(rho0=1.0, eta0=1.0, gravity=1.0, G=1.0, Kb=10.0, is_plastic=1.0, C=0.05,
         friction_angle=30.0, eta_reg=1.0e-2),
    dict(rho0=2.0, eta0=10.0, gravity=1.0, G=1.0, Kb=10.0),
    dict(rho0=0.0, eta0=1.0e-2, gravity=1.0, G=1.0, Kb=10.0),
]


def _vep_inputs(pkg):
    ni = (6, 6, 6)
    phases = _sphere_phases(ni, r=0.3)
    eta = np.choose(phases, [1.0, 10.0, 1.0e-2])
    if pkg == "jax":
        a, geometry, Pt = jnp.asarray, JGeometry(ni, (1.0, 1.0, 1.0)), JPT
        st = JStokesState.make(ni)
        mat = jm.MaterialStack.make([jm.Material(**m) for m in _VEP_MATS])
        ratios, rock = j_ratios, j_rock
    else:
        a, geometry, st, Pt = torch.as_tensor, PGeometry(ni, (1.0, 1.0, 1.0)), \
            PStokesState.make(ni, device="cpu"), PPT
        mat = pm.MaterialStack.make([pm.Material(**m) for m in _VEP_MATS], device="cpu")
        ratios, rock = p_ratios, p_rock
    pr = ratios(a(phases), 3)
    st = st.replace(viscosity=st.viscosity.replace(eta=a(eta)))
    pt = Pt.make(geometry.li, geometry.di, CFL=0.9 / math.sqrt(3.1), eps_rel=1.0e-6)
    args = (st, pt, geometry, _bc(pkg, dict(free_slip=_ALL)), mat, pr.center,
            (pr.edge_yz, pr.edge_xz, pr.edge_xy), 0.5)
    return args, rock(pr, 2)


def test_masked_solve_vep_3d_matches_jax():
    kw = dict(iter_max=500, iter_min=100, nout=100)
    args, phi = _vep_inputs("port")
    ps, pi = p_vep3d_mod.solve_vep_3d(*args, phi=phi, use_kernel=False, **kw)
    args, phi = _vep_inputs("jax")
    js, ji = j_vep3d(*args, phi=phi, **kw)
    _same_info(pi, ji)
    _held(ps, js, 2.0, 6)
    assert float(ps.lam.max()) > 0.0  # the return mapping acted


@pytest.mark.parametrize("route", [True, "edges", "edges_split", "blocked", "canvas"])
def test_masked_kernel_routes_raise(route):
    args, phi = _vep_inputs("port")
    with pytest.raises(ValueError, match="use_kernel=False"):
        p_vep3d_mod.solve_vep_3d(*args, phi=phi, use_kernel=route)


def test_masked_default_route_as_on_the_card_raises(monkeypatch):
    """``use_kernel=None`` on the card takes the edge kernel's route, which
    refuses ``phi`` as JAX's ``use_pallas`` does."""
    from justrelax_tpu_torch.core import device

    def as_on_the_card(use_kernel, tensor, allowed):
        return device.resolve_use_kernel(True if use_kernel is None else use_kernel, tensor,
                                         allowed)

    monkeypatch.setattr(p_vep3d_mod, "resolve_use_kernel", as_on_the_card)
    args, phi = _vep_inputs("port")
    with pytest.raises(ValueError, match="use_kernel=False"):
        p_vep3d_mod.solve_vep_3d(*args, phi=phi)
