"""PyTorch port, the linear VE Stokes slice against the JAX package, in
float64 on the CPU:

- ``compute_P`` (with and without ``alpha_dT``, moduli finite and ∞),
  ``compute_tau_ve``, ``compute_tau_visc`` and ``pureshear_bc``, one call
  each (1e-15);
- the plain version of the Hopper chunk, ``stokes_chunk_reference``, against
  the JAX TPU kernels ``stokes_chunk_vmem`` and ``stokes_chunk_blocked`` in
  interpret mode at n=24, in the three configurations of
  ``chip_smoke.ve_case``: nout=1 within 1e-12, nout=40 within 1e-11;
- the wrapper's CPU route, ``nout=0``, and where the kernel is refused;
- ``solve_ve`` against the JAX ``solve_ve`` at a fixed iteration count, and
  the SolCx, SolKz and elastic build-up models against theirs.

Differences are relative to each field's max, with no floor (``_rel``):
SolCx velocities are far below 1. In the solves, a field that is zero in
the exact solution and carries rounding only (P under pure shear, ∇·V of an
incompressible flow) is held on the max of its family (stresses, strain
rates, velocities), and residuals (R.* and the residual norms) on the size of
the terms they sum (``_scales``).
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from chip_smoke import VE_CASES, ve_case
from justrelax_tpu.core.coeffs import PTStokesCoeffs as JCoeffs
from justrelax_tpu.core.grid import Geometry as JGeometry
from justrelax_tpu.core.state import StokesState as JStokesState
from justrelax_tpu.models import elastic_buildup as jbuildup
from justrelax_tpu.models import solcx as jsolcx
from justrelax_tpu.models import solkz as jsolkz
from justrelax_tpu.ops import bc as jbc
from justrelax_tpu.ops import pallas_stokes as jps
from justrelax_tpu.ops import stokes as jops
from justrelax_tpu.solvers.stokes2d import solve_ve as j_solve_ve
from justrelax_tpu_torch import convert
from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.models import elastic_buildup, solcx, solkz
from justrelax_tpu_torch.ops import bc as pbc
from justrelax_tpu_torch.ops import hopper_stokes as hs
from justrelax_tpu_torch.ops import stokes as pops
from justrelax_tpu_torch.solvers.stokes2d import solve_ve

torch.set_num_threads(1)

CPU = torch.device("cpu")
NAMES = ("Vx", "Vy", "P", "txx", "tyy", "txy")


def _t(x):
    return torch.tensor(np.asarray(x))


def _j(x):
    """A value for the JAX package: tensors and arrays to jax arrays, tuples
    element by element."""
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return jnp.asarray(np.asarray(x))
    if isinstance(x, tuple):
        return tuple(map(_j, x))
    return x


def _rel(a, b):
    """max |a − b| relative to max |b|, with no floor; 0 when both agree
    exactly (a field that is zero in both)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    d = np.max(np.abs(a - b), initial=0.0)
    return 0.0 if d == 0.0 else d / np.max(np.abs(b), initial=0.0)


# ---- ops --------------------------------------------------------------------
@pytest.mark.parametrize("moduli", ["finite", "infinite"])
@pytest.mark.parametrize("with_alpha", [False, True])
def test_compute_P(moduli, with_alpha):
    rng = np.random.default_rng(21)
    n = (7, 6)
    P, P0, Q, gv, aT = (rng.standard_normal(n) for _ in range(5))
    eta = rng.uniform(0.5, 2.0, n)
    K, G = ((rng.uniform(2.0, 9.0, n) for _ in range(2)) if moduli == "finite"
            else (np.full(n, np.inf), np.full(n, np.inf)))
    alpha = aT if with_alpha else None
    for dt in (0.25, math.inf):
        a = pops.compute_P(_t(P), _t(P0), _t(gv), _t(Q), _t(eta), _t(K), _t(G), dt, 0.7, 3.0,
                           alpha_dT=None if alpha is None else _t(alpha))
        b = jops.compute_P(_j(P), _j(P0), _j(gv), _j(Q), _j(eta), _j(K), _j(G), dt, 0.7, 3.0,
                           alpha_dT=None if alpha is None else _j(alpha))
        for x, y in zip(a, b):
            assert _rel(x, y) <= 1e-15


@pytest.mark.parametrize("G_kind", ["finite", "infinite"])
def test_compute_tau_ve_and_visc(G_kind):
    rng = np.random.default_rng(22)
    nx, ny = 7, 6
    c, v = (nx, ny), (nx + 1, ny + 1)
    txx, tyy, txx_o, tyy_o, exx, eyy = (rng.standard_normal(c) for _ in range(6))
    txy, txy_o, exy = (rng.standard_normal(v) for _ in range(3))
    eta = rng.uniform(0.5, 2.0, c)
    G = rng.uniform(1.0, 4.0, c) if G_kind == "finite" else np.full(c, np.inf)
    a = pops.compute_tau_ve(*map(_t, (txx, tyy, txy, txx_o, tyy_o, txy_o, exx, eyy, exy,
                                      eta, G)), 2.5, 0.3)
    b = jops.compute_tau_ve(*map(_j, (txx, tyy, txy, txx_o, tyy_o, txy_o, exx, eyy, exy,
                                      eta, G)), 2.5, 0.3)
    for x, y in zip(a, b):
        assert _rel(x, y) <= 1e-15
    assert torch.equal(a[2][0], _t(txy)[0])  # boundary vertices untouched
    a = pops.compute_tau_visc(*map(_t, (txx, tyy, txy, exx, eyy, exy, eta)), 2.5)
    b = jops.compute_tau_visc(*map(_j, (txx, tyy, txy, exx, eyy, exy, eta)), 2.5)
    for x, y in zip(a, b):
        assert _rel(x, y) <= 1e-15
    with pytest.raises(NotImplementedError):
        pops.compute_tau_ve(*map(_t, (txx, tyy, txy, txx_o, tyy_o, txy_o, exx, eyy, exy,
                                      eta, G)), 2.5, 0.3, eta_v=_t(txy), G_v=_t(txy))


def test_pureshear_bc():
    rng = np.random.default_rng(23)
    g = Geometry((6, 5), (2.0, 1.0))
    Vx, Vy = rng.standard_normal((7, 7)), rng.standard_normal((8, 6))
    a = pbc.pureshear_bc(_t(Vx), _t(Vy), g.xvi, 0.3)
    b = jbc.pureshear_bc(_j(Vx), _j(Vy), g.xvi, 0.3)
    for x, y in zip(a, b):
        assert _rel(x, y) <= 1e-15
    assert torch.equal(a[0][:, 0], _t(Vx)[:, 0])  # ghost rows untouched


# ---- the chunk: plain version against the TPU kernels ------------------------
def _case(name, n=24):
    args, kw = ve_case(name, n, torch.float64, CPU)
    return args, kw, tuple(map(_j, args)), {k: _j(v) for k, v in kw.items()}


@pytest.mark.parametrize("kernel", ["vmem", "blocked"])
@pytest.mark.parametrize("nout,tol", [(1, 1e-12), (40, 1e-11)])
@pytest.mark.parametrize("case", VE_CASES)
def test_chunk_reference_matches_tpu_kernel(case, nout, tol, kernel):
    pargs, pkw, jargs, jkw = _case(case)
    out = hs.stokes_chunk_reference(*pargs, nout=nout, **pkw)
    if kernel == "vmem":
        ref = jps.stokes_chunk_vmem(*jargs, nout=nout, interpret=True, **jkw)
    else:
        ref = jps.stokes_chunk_blocked(*jargs, nout=nout, interpret=True, pipeline=False,
                                       row_block=16, iters_per_pass=2, **jkw)
    for name, a, b in zip(NAMES, out, ref):
        assert float(np.abs(np.asarray(b)).max()) > 0.0, name  # every field moves
        assert _rel(a, b) <= tol, f"{name}: {_rel(a, b)} > {tol}"


def test_chunk_reference_without_free_slip_matches_tpu_kernel():
    """``free_slip=False`` leaves the ghosts as they are."""
    pargs, pkw, jargs, jkw = _case("ve_compressible")
    out = hs.stokes_chunk_reference(*pargs, nout=5, free_slip=False, **pkw)
    ref = jps.stokes_chunk_vmem(*jargs, nout=5, free_slip=False, interpret=True, **jkw)
    for name, a, b in zip(NAMES, out, ref):
        assert _rel(a, b) <= 1e-12, name
    assert torch.equal(out[0][:, 0], pargs[0][:, 0])


def test_chunk_cpu_route_and_nout_zero():
    pargs, pkw, _, _ = _case("ve_compressible", n=12)
    hs.stokes_chunk.launches = 0
    out = hs.stokes_chunk(*pargs, nout=3, **pkw)
    ref = hs.stokes_chunk_reference(*pargs, nout=3, **pkw)
    assert hs.stokes_chunk.launches == 0
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    same = hs.stokes_chunk(*pargs, nout=0, **pkw)
    assert all(a is b for a, b in zip(same, pargs[:6]))
    assert hs.stokes_chunk.launches == 0


def test_chunk_defaults_are_the_viscous_limit():
    """G, K, P0, Q, τ_o and dt left out are ∞, ∞, 0, 0, 0 and ∞."""
    pargs, pkw, _, _ = _case("solcx", n=12)
    n = 12
    inf = torch.full((n, n), math.inf, dtype=torch.float64)
    z = torch.zeros((n, n), dtype=torch.float64)
    full = dict(G=inf, K=inf, P0=z, Q=z, tau_o=(z, z, torch.zeros((n + 1, n + 1),
                                                                 dtype=torch.float64)),
                dt=math.inf)
    a = hs.stokes_chunk_reference(*pargs, nout=5)
    b = hs.stokes_chunk_reference(*pargs, nout=5, **full)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---- where the kernel is refused ----------------------------------------------
_FS = dict(free_slip=dict(left=True, right=True, top=True, bot=True))
_REFUSED = {
    "no_slip": (dict(no_slip=dict(left=True, right=True, top=True, bot=True)), {}),
    "mixed": (dict(free_slip=dict(left=True, right=True), no_slip=dict(top=True, bot=True)), {}),
    "free_surface": (_FS, dict(free_surface=True)),
    "alpha_dT": (_FS, dict(alpha_dT="field")),
}


def _solve_inputs(n, port):
    ni = (n, n)
    g = (Geometry if port else JGeometry)(ni, (1.0, 1.0))
    pt = (PTStokesCoeffs if port else JCoeffs).make(g.li, g.di)
    if port:
        st = convert.stokes_state_from_dict(serialization.to_state_dict(JStokesState.make(ni)),
                                            device="cpu")
        z, G = torch.zeros(ni, dtype=torch.float64), torch.full(ni, math.inf, dtype=torch.float64)
    else:
        st, z, G = JStokesState.make(ni), jnp.zeros(ni), jnp.full(ni, jnp.inf)
    return st, pt, g, z, G


@pytest.mark.parametrize("case", sorted(_REFUSED))
def test_kernel_refused_where_jax_refuses(case):
    bc_kw, kw = _REFUSED[case]
    n = 16
    for port in (False, True):
        st, pt, g, z, G = _solve_inputs(n, port)
        kw_ = {k: (z if v == "field" else v) for k, v in kw.items()}
        if port:
            bc = pbc.VelocityBoundaryConditions(**bc_kw)
            assert not hs.ve_chunk_supported(g, bc, kw_.get("free_surface", False),
                                             None, kw_.get("alpha_dT"))
            with pytest.raises(ValueError, match="use_kernel=False"):
                solve_ve(st, pt, g, bc, (z, z), G, G, 0.1, use_kernel=True, **kw_)
        else:
            bc = jbc.VelocityBoundaryConditions(**bc_kw)
            with pytest.raises(ValueError):
                j_solve_ve(st, pt, g, bc, (z, z), G, G, 0.1, use_pallas=True, **kw_)
    st, pt, g, z, G = _solve_inputs(n, True)
    assert hs.ve_chunk_supported(g, pbc.VelocityBoundaryConditions(**_FS))
    with pytest.raises(ValueError, match="free-slip"):
        solve_ve(st, pt, g, pbc.VelocityBoundaryConditions(**_REFUSED["no_slip"][0]),
                 (z, z), G, G, 0.1, use_kernel=True)


def test_solve_ve_not_ported_arguments():
    st, pt, g, z, G = _solve_inputs(8, True)
    bc = pbc.VelocityBoundaryConditions(**_FS)
    for kw in (dict(halo_exchange=lambda a: a), dict(reduce_norm=lambda a, s: a)):
        with pytest.raises(NotImplementedError):
            solve_ve(st, pt, g, bc, (z, z), G, G, 0.1, **kw)

    @dataclasses.dataclass(frozen=True)
    class Nonuniform:
        di = g.di
        di_center = g.xci

    with pytest.raises(NotImplementedError):
        solve_ve(st, pt, Nonuniform(), bc, (z, z), G, G, 0.1)
    with pytest.raises(ValueError):
        solve_ve(st, pt, g, bc, (z, z), G, G, 0.1, use_kernel="edges")


# ---- the solve and the models against the JAX package -------------------------
def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif v is not None:
            out[prefix + k] = np.asarray(v)
    return out


_FAMILIES = {"stress": ("P", "P0", "tau.", "tau_o."),
             "rate": ("eps.", "grad_V", "omega."), "velocity": ("V.",)}


def _family(key):
    return next((f for f, prefixes in _FAMILIES.items()
                 if any(key == p or (p.endswith(".") and key.startswith(p)) for p in prefixes)),
                None)


def _scales(b, di, rho_g):
    """Each family's largest value in the JAX state ``b``, and the size of
    the terms a residual sums (stress and pressure over the spacing, and
    ρg). A field that is zero in the exact solution (P under pure shear,
    ∇·V of an incompressible flow) carries rounding only, so it is held on
    its family's scale; a residual is a difference of its terms, so its
    rounding is absolute on their scale."""
    sc = {f: max(float(np.abs(v).max(initial=0.0)) for k, v in b.items() if _family(k) == f)
          for f in _FAMILIES}
    sc["residual"] = sc["stress"] / min(di) + float(np.max(np.abs(rho_g)))
    return sc


def _state_close(port_state, jax_state, di, rho_g=0.0, tol=1e-10, res_tol=1e-12):
    """Every field within ``tol`` of its family's max (its own max outside
    the families); the residuals R.* within ``res_tol`` of the residual
    scale. Returns the scales."""
    a = _flat(convert.to_state_dict(port_state))
    b = _flat(serialization.to_state_dict(jax_state))
    assert a.keys() == b.keys()
    sc = _scales(b, di, rho_g)
    for k in a:
        d = np.abs(a[k] - b[k]).max(initial=0.0)
        if k.startswith("R."):
            assert d <= res_tol * sc["residual"], k
        elif _family(k) is not None:
            assert d <= tol * sc[_family(k)], (k, d / sc[_family(k)])
        else:
            assert _rel(a[k], b[k]) <= tol, (k, _rel(a[k], b[k]))
    return sc


def _info_close(p_info, j_info, scale, res_tol=1e-12):
    """Iteration counts equal; the residual norms as the residuals."""
    assert p_info.iters == int(j_info.iters)
    for x, y in zip(p_info[1:], j_info[1:]):
        x, y = np.asarray(x), np.asarray(y)
        assert np.array_equal(np.isnan(x), np.isnan(y))
        assert np.nanmax(np.abs(x - y)) <= res_tol * scale


_SOLVES = {
    # the VE compressible set-up with variable η, all free slip (the kernel's case)
    "ve_compressible": (_FS, {}),
    # the plain path's own generality: no-slip sides, free surface, α·ΔT source
    "plain_general": (dict(free_slip=dict(left=True, right=True), no_slip=dict(top=True, bot=True)),
                      dict(free_surface=True, alpha_dT=True)),
}


@pytest.mark.parametrize("case,use_kernel", [("ve_compressible", False),
                                             ("ve_compressible", True),
                                             ("plain_general", False)])
def test_solve_ve_matches_jax(case, use_kernel):
    """On CPU tensors ``use_kernel=True`` runs the wrapper's CPU route."""
    bc_kw, extra = _SOLVES[case]
    n = 16
    ni = (n, n)
    rng = np.random.default_rng(31)
    jst = JStokesState.make(ni)
    jst = jst.replace(
        viscosity=jst.viscosity.replace(eta=jnp.asarray(np.exp(rng.uniform(0, 2, ni)))),
        P0=jnp.asarray(rng.standard_normal(ni)) * 0.1,
        Q=jnp.asarray(rng.standard_normal(ni)) * 0.05,
        tau_o=jst.tau_o.replace(
            xx=jnp.asarray(rng.standard_normal(ni)) * 0.1,
            yy=jnp.asarray(rng.standard_normal(ni)) * 0.1,
            xy=jnp.asarray(rng.standard_normal((n + 1, n + 1))) * 0.1,
        ),
    )
    rho_g = (rng.standard_normal(ni) * 0.3, 1.0 + rng.standard_normal(ni) * 0.2)
    G, K = np.full(ni, 4.0), np.full(ni, 9.0)
    alpha = rng.standard_normal(ni) * 0.01 if extra.get("alpha_dT") else None
    kw = dict(iter_max=1000, nout=500, free_surface=extra.get("free_surface", False))
    jg = JGeometry(ni, (1.0, 1.0))
    jpt = JCoeffs.make(jg.li, jg.di, CFL=1.0 / math.sqrt(2.1), eps_abs=0.0, eps_rel=0.0)
    j_out, j_info = j_solve_ve(jst, jpt, jg, jbc.VelocityBoundaryConditions(**bc_kw),
                               tuple(map(_j, rho_g)), _j(G), _j(K), 0.5,
                               alpha_dT=None if alpha is None else _j(alpha), **kw)
    pst = convert.stokes_state_from_dict(serialization.to_state_dict(jst), device="cpu")
    g = Geometry(ni, (1.0, 1.0))
    pt = PTStokesCoeffs.make(g.li, g.di, CFL=1.0 / math.sqrt(2.1), eps_abs=0.0, eps_rel=0.0)
    p_out, p_info = solve_ve(pst, pt, g, pbc.VelocityBoundaryConditions(**bc_kw),
                             tuple(map(_t, rho_g)), _t(G), _t(K), 0.5,
                             alpha_dT=None if alpha is None else _t(alpha),
                             use_kernel=use_kernel, **kw)
    assert p_info.iters == 1000
    sc = _state_close(p_out, j_out, g.di, rho_g)
    _info_close(p_info, j_info, sc["residual"])


def test_solcx_and_solkz_match_jax():
    kw = dict(nx=16, ny=16, iter_max=2_000, nout=500)
    g, p_st, p_info, p_rho = solcx.run(device="cpu", **kw)
    _, j_st, j_info, j_rho = jsolcx.run(**kw)
    assert float(p_info.err) < 1e-8
    np.testing.assert_array_equal(p_rho, j_rho)
    _info_close(p_info, j_info, _state_close(p_st, j_st, g.di, p_rho)["residual"])
    g, p_st, p_info = solkz.run(device="cpu", **kw)
    _, j_st, j_info = jsolkz.run(**kw)
    _info_close(p_info, j_info, _state_close(p_st, j_st, g.di, 1.0)["residual"])  # |ρ| ≤ 1


def test_elastic_buildup_matches_jax():
    p_st, p_av, p_sol, p_tt, p_info = elastic_buildup.run(nx=16, ny=16, endtime_kyr=0.15,
                                                          device="cpu")
    j_st, j_av, j_sol, j_tt, j_info = jbuildup.run(nx=16, ny=16, endtime_kyr=0.15)
    assert len(p_av) == len(j_av) == 3
    np.testing.assert_allclose(p_av, j_av, rtol=1e-10)
    assert p_sol == j_sol and p_tt == j_tt
    assert elastic_buildup.analytic_solution(1e-14, 1e3, 1e10, 1e21) == \
        jbuildup.analytic_solution(1e-14, 1e3, 1e10, 1e21)
    sc = _state_close(p_st, j_st, (100.0e3 / 16,) * 2)
    _info_close(p_info, j_info, sc["residual"])
