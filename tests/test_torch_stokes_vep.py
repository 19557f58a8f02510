"""PyTorch port, Stokes and VEP layer against the JAX package, in float64:

- the ``ops/stokes`` functions and ``update_stresses_center_vertex``, one call
  each (same operations in the same order: 1e-13);
- the plain version of the Hopper chunk, ``stokes_vep_chunk_reference``,
  against the JAX TPU kernel ``stokes_vep_chunk_vmem`` in interpret mode at
  n=24, in the four configurations of ``chip_smoke.chunk_case``: nout=1
  within 1e-13 (rounding only), nout=40 within 2e-6 (the yield-branch-flip
  bound of tests/test_pallas_vep.py);
- the kernel's chunk-invariant stacks (``_vep_prepare``) against the TPU
  kernel's canvases;
- the wrapper's CPU route, ``nout=0``, and the state conversion.

Differences are taken relative to each field's max, floored at 1 (``_rel``).
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from chip_smoke import chunk_case
from justrelax_tpu.core.state import StokesState as JStokesState
from justrelax_tpu.ops import bc as jbc
from justrelax_tpu.ops import pallas_stokes_vep as jpv
from justrelax_tpu.ops import stokes as jops
from justrelax_tpu.ops.stokes_vep import update_stresses_center_vertex as j_update
from justrelax_tpu.rheology import materials as jm
from justrelax_tpu_torch import convert
from justrelax_tpu_torch.ops import bc as pbc
from justrelax_tpu_torch.ops import hopper_stokes_vep as hv
from justrelax_tpu_torch.ops import stokes as pops
from justrelax_tpu_torch.ops.stokes_vep import update_stresses_center_vertex as p_update
from justrelax_tpu_torch.rheology import materials as pm

torch.set_num_threads(1)

CASES = ("shearband", "dpcap", "powerlaw_noslip", "buoyancy")


def _t(x):
    return torch.tensor(np.asarray(x))


def _j(x):
    """A value for the JAX package: tensors and arrays to jax arrays, the
    material stack through its state dict."""
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return jnp.asarray(np.asarray(x))
    if isinstance(x, pm.MaterialStack):
        template = jm.MaterialStack.make([jm.Material()] * x.nphase)
        return serialization.from_state_dict(template, convert.to_state_dict(x))
    return x


def _rel(a, b):
    """max |a − b| relative to the field's max, floored at 1: the
    configurations are non-dimensional with O(1) fields, and a field that is
    zero up to rounding (θ under pure shear) has no relative error."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return np.max(np.abs(a - b), initial=0.0) / max(np.max(np.abs(b), initial=0.0), 1.0)


def _case(name, n=24):
    """One chunk call's inputs (the shear band class with old stresses near
    yield), for the port and for the JAX package."""
    pargs, pkw = chunk_case(name, n, torch.float64, torch.device("cpu"))
    bc = pkw["flow_bc"]
    jkw = dict(T_v=_j(pkw["T_v"]), flow_bc=jbc.VelocityBoundaryConditions(
        no_slip=dataclasses.asdict(bc.no_slip), free_slip=dataclasses.asdict(bc.free_slip)))
    return pargs, pkw, tuple(map(_j, pargs)), jkw


NAMES = ("Vx", "Vy", "theta", "P", "txx", "tyy", "txy_c", "txy_v", "eta", "eta_v", "lam", "lam_v")


@pytest.mark.parametrize("nout,tol", [(1, 1e-13), (40, 2e-6)])
@pytest.mark.parametrize("case", CASES)
def test_chunk_reference_matches_tpu_kernel(case, nout, tol):
    pargs, pkw, jargs, jkw = _case(case)
    out = hv.stokes_vep_chunk_reference(*pargs, nout=nout, **pkw)
    ref = jpv.stokes_vep_chunk_vmem(*jargs, nout=nout, interpret=True, **jkw)
    if case == "buoyancy":
        assert float(np.abs(np.asarray(ref[1])).max()) > 1e-6  # driven by ρ(T)·g
    else:
        assert float(np.asarray(ref[10]).max()) > 0.0  # plasticity acts
    for name, a, b in zip(NAMES, out, ref):
        assert _rel(a, b) <= tol, f"{name}: {_rel(a, b)} > {tol}"


@pytest.mark.parametrize("case", CASES)
def test_vep_prepare_matches_tpu_canvases(case):
    pargs, pkw, jargs, jkw = _case(case, n=12)
    has_cap, visc_m = hv._resolve_static(pargs[19], None, "auto")
    cinv, vinv = hv._vep_prepare(pargs[2], *pargs[12:23], pkw["T_v"], pargs[23],
                                 visc_m, torch.float64)
    prep = jpv._vep_prepare(*jargs, has_cap=None, flow_bc=jkw["flow_bc"],
                            T_v=jkw["T_v"], visc_m="auto")
    _, jcinv, jvinv, cnames, vnames, _, _, jvisc_m, jcap = prep
    assert (has_cap, visc_m) == (jcap, jvisc_m)
    alias = {"eta_tab": "visc_a", "visc_A": "visc_a", "visc_B": "visc_b"}
    for k, name in enumerate(cnames):
        if name in ("gxf", "gyf"):
            continue
        got = cinv[hv.CINV_SLOTS.index(alias.get(name, name))]
        assert _rel(got, np.asarray(jcinv[k])[1:-1, 1:-1]) <= 1e-15, name
    for k, name in enumerate(vnames):
        got = vinv[hv.VINV_SLOTS.index(alias.get(name, name))]
        assert _rel(got, np.asarray(jvinv[k])[:-1, :-1]) <= 1e-15, name
    # buoyancy: the kernel averages the cell ρg onto the faces it updates
    g = cinv[hv.CINV_SLOTS.index("rho_gy")]
    gyf = np.asarray(jcinv[cnames.index("gyf")])[1:-1, 1:-2]
    assert _rel(0.5 * (g[:, 1:] + g[:, :-1]), gyf) <= 1e-15


def test_chunk_cpu_route_and_nout_zero():
    pargs, pkw, _, _ = _case("shearband", n=12)
    hv.stokes_vep_chunk.launches = 0
    out = hv.stokes_vep_chunk(*pargs, nout=3, **pkw)
    ref = hv.stokes_vep_chunk_reference(*pargs, nout=3, **pkw)
    assert hv.stokes_vep_chunk.launches == 0
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    same = hv.stokes_vep_chunk(*pargs, nout=0, **pkw)
    assert all(a is b for a, b in zip(same, pargs[:12]))
    assert hv.stokes_vep_chunk.launches == 0


def test_chunk_bc_modes_and_support():
    from justrelax_tpu_torch.core.grid import Geometry

    bc = pbc.VelocityBoundaryConditions(free_slip=dict(left=True, right=True),
                                        no_slip=dict(top=True, bot=True))
    assert hv.vep_chunk_bc_modes(bc) == ("free_slip", "free_slip", "no_slip", "no_slip")
    assert hv.vep_chunk_bc_modes(pbc.VelocityBoundaryConditions(
        free_slip=dict(left=True, right=True, top=True))) is None
    g = Geometry((8, 8), (1.0, 1.0))
    lin = pm.MaterialStack.make([pm.Material(G=1.0)], device="cpu")
    assert hv.vep_chunk_supported(lin, g, bc, False)
    assert not hv.vep_chunk_supported(lin, g, bc, True)
    assert not hv.vep_chunk_supported(pm.MaterialStack.make([pm.Material(beta=0.1)], device="cpu"), g, bc, False)
    assert not hv.vep_chunk_supported(
        pm.MaterialStack.make([pm.Material(dqdtau_alt=1.0)], device="cpu"), g, bc, False)
    assert not hv.vep_chunk_supported(
        pm.MaterialStack.make([pm.Material(peierls_A=1.0)], device="cpu"), g, bc, False)
    with pytest.raises(ValueError):
        hv._resolve_static(pm.MaterialStack.make(
            [pm.Material(disl_A=0.5, disl_n=3.0), pm.Material(disl_A=0.5, disl_n=2.0)],
            device="cpu"),
            None, "auto")


def test_ops_stokes_one_call_each():
    rng = np.random.default_rng(11)
    nx, ny = 7, 6
    Vx, Vy = rng.standard_normal((nx + 1, ny + 2)), rng.standard_normal((nx + 2, ny + 1))
    P, P0, Q, txx, tyy = (rng.standard_normal((nx, ny)) for _ in range(5))
    eta, K, G = (rng.uniform(0.5, 2.0, (nx, ny)) for _ in range(3))
    txy = rng.standard_normal((nx + 1, ny + 1))
    rgx, rgy = rng.standard_normal((nx, ny)), rng.standard_normal((nx, ny))
    T, J = _t, _j
    pairs = [
        (pops.compute_grad_V(T(Vx), T(Vy), 3.0, 4.0), jops.compute_grad_V(J(Vx), J(Vy), 3.0, 4.0)),
        (pops.tensor_invariant_2d(T(txx), T(tyy), T(P)), jops.tensor_invariant_2d(J(txx), J(tyy), J(P))),
        (pops.tensor_invariant_staggered_2d(T(txx), T(tyy), T(txy)),
         jops.tensor_invariant_staggered_2d(J(txx), J(tyy), J(txy))),
        (pops.compute_vorticity(T(Vx), T(Vy), 3.0, 4.0), jops.compute_vorticity(J(Vx), J(Vy), 3.0, 4.0)),
    ]
    gv = pops.compute_grad_V(T(Vx), T(Vy), 3.0, 4.0)
    pairs += list(zip(pops.compute_strain_rate(gv, T(Vx), T(Vy), 3.0, 4.0),
                      jops.compute_strain_rate(J(np.asarray(gv)), J(Vx), J(Vy), 3.0, 4.0)))
    for dt in (0.25, math.inf):
        pairs += list(zip(
            pops.compute_P(T(P), T(P0), gv, T(Q), T(eta), T(K), T(G), dt, 0.7, 3.0),
            jops.compute_P(J(P), J(P0), J(np.asarray(gv)), J(Q), J(eta), J(K), J(G), dt, 0.7, 3.0)))
    for fs in (None, 0.1):
        pairs += list(zip(
            pops.compute_V(T(Vx), T(Vy), T(P), T(txx), T(tyy), T(txy), 0.05, T(rgx), T(rgy),
                           T(eta), 3.0, 4.0, free_surface_dt=fs),
            jops.compute_V(J(Vx), J(Vy), J(P), J(txx), J(tyy), J(txy), 0.05, J(rgx), J(rgy),
                           J(eta), 3.0, 4.0, free_surface_dt=fs)))
        pairs += list(zip(
            pops.compute_Res(T(P), T(txx), T(tyy), T(txy), T(rgx), T(rgy), 3.0, 4.0,
                             Vy=T(Vy), free_surface_dt=fs),
            jops.compute_Res(J(P), J(txx), J(tyy), J(txy), J(rgx), J(rgy), 3.0, 4.0,
                             Vy=J(Vy), free_surface_dt=fs)))
    for a, b in pairs:
        assert _rel(a, b) <= 1e-13


@pytest.mark.parametrize("case", ["shearband", "dpcap", "powerlaw_noslip"])
def test_update_stresses_center_vertex(case):
    n = 10
    pargs, _, jargs, _ = _case(case, n=n)
    rng = np.random.default_rng(12)
    exx, eyy = rng.standard_normal((n, n)), rng.standard_normal((n, n))
    exy = rng.standard_normal((n + 1, n + 1))
    txx, tyy, txy_c = (1.5 * rng.standard_normal((n, n)) for _ in range(3))
    txy_v = 1.5 * rng.standard_normal((n + 1, n + 1))
    Pr = rng.uniform(-0.4, 0.4, (n, n))
    lam, lam_v = rng.uniform(0, 1, (n, n)), rng.uniform(0, 1, (n + 1, n + 1))

    def inputs(args, conv):
        # chunk arguments: old stresses 4-7, η 8, EII 18, material and ratios 19-21
        return (tuple(map(conv, (exx, eyy, exy, txx, tyy, txy_c, txy_v))) + args[4:8]
                + (conv(Pr), args[8], conv(lam), conv(lam_v), args[18]) + args[19:22]
                + (0.2, 0.25, 3.1))

    a = p_update(*inputs(pargs, _t))
    b = j_update(*inputs(jargs, _j))
    assert float(np.asarray(b.lam).max()) > 0.0
    for name, x, y in zip(b._fields, a, b):
        assert _rel(x, y) <= 1e-13, name


def test_convert_round_trip():
    ni = (5, 4)
    rng = np.random.default_rng(13)
    jstate = JStokesState.make(ni)
    d = serialization.to_state_dict(jstate)

    def fill(x):
        if isinstance(x, dict):
            return {k: fill(v) for k, v in x.items()}
        return None if x is None else rng.standard_normal(np.shape(x))

    d = fill(d)
    jstate = serialization.from_state_dict(jstate, d)
    port = convert.stokes_state_from_dict(serialization.to_state_dict(jstate), device="cpu")
    assert port.P.dtype == torch.float64 and port.V.Vz is None
    back = convert.to_state_dict(port)

    def same(x, y):
        if isinstance(x, dict):
            assert x.keys() == y.keys()
            for k in x:
                same(x[k], y[k])
        elif x is None:
            assert y is None
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    same(back, d)
    # and back into the JAX container
    again = serialization.from_state_dict(JStokesState.make(ni), back)
    np.testing.assert_array_equal(np.asarray(again.tau.xy), d["tau"]["xy"])
    f32 = convert.stokes_state_from_dict(d, dtype=torch.float32, device="cpu")
    assert f32.tau.xx.dtype == torch.float32

    jmat = jm.MaterialStack.make([jm.Material(G=1.0, C=2.0), jm.Material(G=0.5, tension_pT=-0.5)])
    pmat = convert.material_from_dict(serialization.to_state_dict(jmat), device="cpu")
    assert pmat.nphase == 2
    same(convert.to_state_dict(pmat), serialization.to_state_dict(jmat))
