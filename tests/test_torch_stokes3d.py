"""PyTorch port, the 3D VE Stokes ops and chunk against the JAX package, in
float64 on the CPU:

- each function of ``ops/stokes3d.py`` at (6, 5, 4) cells, one call each,
  within 1e-15 of each field's max (``boundary_shear`` both ways);
- 3D ``flow_bcs`` (free slip, no slip, both) exactly;
- ``ve3d_canvas_coefficients`` in both forms, field by field (1e-15);
- the plain chunk, ``stokes3d_chunk_reference``, against JAX's XLA canvas
  chunk ``stokes3d_chunk_canvas`` and against the TPU kernel
  ``stokes3d_chunk_blocked`` in interpret mode, at (22, 9, 7), nout 5, in
  the configurations of ``chip_smoke.ve3d_case`` and on the
  ``viscous_consts`` route: rtol 1e-12, atol 1e-14, as
  tests/test_pallas3d_blocked.py holds the TPU kernel to the canvas chunk;
- ``pack_carry``/``unpack_carry`` round trips, and the wrapper's CPU route
  and refusals;
- ``pack_coeffs``' slot table: uniform canvases go in as scalars or absent
  terms, and the plain chunk on the coefficients as the kernel reads them
  from that table equals the plain chunk on the full canvases.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import VE3D_CASES, ve3d_case, ve3d_numpy
from justrelax_tpu.core.coeffs import PTStokesCoeffs as JCoeffs
from justrelax_tpu.core.grid import Geometry as JGeometry
from justrelax_tpu.core.grid import NonuniformGeometry as JNonuniformGeometry
from justrelax_tpu.ops import bc as jbc
from justrelax_tpu.ops import stokes3d as jk3
from justrelax_tpu.ops import stokes3d_canvas as jcv
from justrelax_tpu.ops.pallas_stokes3d_blocked import stokes3d_chunk_blocked
from justrelax_tpu.ops.stencil import maxloc as jmaxloc
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.core.grid import NonuniformGeometry as PNonuniformGeometry
from justrelax_tpu_torch.models import solvi3d
from justrelax_tpu_torch.ops import bc as pbc
from justrelax_tpu_torch.ops import hopper_stokes3d as h3
from justrelax_tpu_torch.ops import stokes3d as pk3
from justrelax_tpu_torch.ops import stokes3d_canvas as pcv
from justrelax_tpu_torch.ops.stencil import maxloc
from justrelax_tpu_torch.solvers.stokes3d import kernel_chunk_inputs

torch.set_num_threads(1)

CPU = torch.device("cpu")
NAMES = ("Vx", "Vy", "Vz", "P", "txx", "tyy", "tzz", "tyz", "txz", "txy")
NI = (22, 9, 7)


def _t(x):
    if isinstance(x, tuple):
        return tuple(map(_t, x))
    return torch.tensor(np.asarray(x)) if isinstance(x, (np.ndarray, jnp.ndarray)) else x


def _j(x):
    if isinstance(x, tuple):
        return tuple(map(_j, x))
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return jnp.asarray(np.asarray(x))
    return x


def _rel(a, b):
    """max |a − b| relative to max |b|, with no floor; 0 when both agree
    exactly."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    d = np.max(np.abs(a - b), initial=0.0)
    return 0.0 if d == 0.0 else d / np.max(np.abs(b), initial=0.0)


# ---- ops/stokes3d.py --------------------------------------------------------
N3 = (6, 5, 4)


def _ops_inputs():
    nx, ny, nz = N3
    rng = np.random.default_rng(41)

    def r(*shape):
        return rng.standard_normal(shape)

    V = (r(nx + 1, ny + 2, nz + 2), r(nx + 2, ny + 1, nz + 2), r(nx + 2, ny + 2, nz + 1))
    P = r(*N3)
    tau = (r(*N3), r(*N3), r(*N3), r(nx, ny + 1, nz + 1), r(nx + 1, ny, nz + 1),
           r(nx + 1, ny + 1, nz))
    tau_o = tuple(0.1 * r(*t.shape) for t in tau)
    eta = rng.uniform(0.5, 2.0, N3)
    G = rng.uniform(1.0, 4.0, N3)
    f = (r(*N3), r(*N3), r(*N3))
    return V, P, tau, tau_o, eta, G, f


INV_DI = (1.0 / 0.25, 1.0 / 0.3, 1.0 / 0.2)


def _grad_and_eps(mod, conv, V):
    gv = mod.compute_grad_V_3d(*conv(V), INV_DI)
    return gv, mod.compute_strain_rate_3d(gv, *conv(V), INV_DI)


@pytest.mark.parametrize("name", ["grad_V", "strain_rate", "tau_ve", "tau_ve_boundary_shear",
                                  "tau_ve_viscous", "V", "invariant"])
def test_ops_3d_match_jax(name):
    V, P, tau, tau_o, eta, G, f = _ops_inputs()
    if name == "grad_V":
        a = (pk3.compute_grad_V_3d(*_t(V), INV_DI),)
        b = (jk3.compute_grad_V_3d(*_j(V), INV_DI),)
    elif name == "strain_rate":
        a = _grad_and_eps(pk3, _t, V)[1]
        b = _grad_and_eps(jk3, _j, V)[1]
    elif name.startswith("tau_ve"):
        bs = name == "tau_ve_boundary_shear"
        Gv = np.full(N3, np.inf) if name == "tau_ve_viscous" else G
        a = pk3.compute_tau_ve_3d(_t(tau), _t(tau_o), _grad_and_eps(pk3, _t, V)[1], _t(eta),
                                  _t(Gv), 2.5, 0.3, boundary_shear=bs)
        b = jk3.compute_tau_ve_3d(_j(tau), _j(tau_o), _grad_and_eps(jk3, _j, V)[1], _j(eta),
                                  _j(Gv), 2.5, 0.3, boundary_shear=bs)
        if not bs:
            assert torch.equal(a[3][:, 0], _t(tau[3])[:, 0])  # boundary edges untouched
    elif name == "V":
        eta_tau = np.maximum(eta, 0.7)
        a = pk3.compute_V_3d(*_t(V), _t(P), _t(tau), *_t(f), _t(eta_tau), 0.4, INV_DI)
        b = jk3.compute_V_3d(*_j(V), _j(P), _j(tau), *_j(f), _j(eta_tau), 0.4, INV_DI)
        assert all(torch.equal(x, y) for x, y in zip(
            a[3:], pk3.momentum_residuals_3d(_t(P), _t(tau), *_t(f), INV_DI)))
    else:
        a = (pk3.tensor_invariant_staggered_3d(*_t(tau)),)
        b = (jk3.tensor_invariant_staggered_3d(*_j(tau)),)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert _rel(x, y) <= 1e-15


def test_spacing_families_3d():
    g, jg = Geometry((6, 5, 4), (1.5, 1.0, 0.8)), JGeometry((6, 5, 4), (1.5, 1.0, 0.8))
    like = torch.zeros((), dtype=torch.float64)
    assert pk3.spacing_families_3d(g, like) == jk3.spacing_families_3d(jg)
    # a nonuniform grid's families, once refused: now JAX's, bit for bit
    # (compute_V_3d with them in tests/test_torch_nonuniform_stokes3d.py)
    vectors = tuple(np.cumsum(np.r_[0.0, np.linspace(1.0, 2.0, n)]) for n in (6, 5, 4))
    p = pk3.spacing_families_3d(PNonuniformGeometry(vectors), like)
    j = jk3.spacing_families_3d(JNonuniformGeometry(vectors))
    for a, b in zip(p[0] + p[1] + p[2][0] + p[2][1], j[0] + j[1] + j[2][0] + j[2][1]):
        assert a.shape == b.shape and np.array_equal(a.numpy(), np.asarray(b))


_BCS3 = {
    "free_slip": dict(free_slip=dict(left=True, right=True, top=True, bot=True, front=True,
                                     back=True)),
    "no_slip": dict(no_slip=dict(left=True, right=True, top=True, bot=True, front=True,
                                 back=True)),
    "both": dict(free_slip=dict(left=True, right=True, front=True),
                 no_slip=dict(top=True, bot=True, back=True)),
}


@pytest.mark.parametrize("case", sorted(_BCS3))
def test_flow_bcs_3d(case):
    V, *_ = _ops_inputs()
    kw = _BCS3[case]
    p = pbc.flow_bcs(_t(V), pbc.VelocityBoundaryConditions(**kw))
    j = jbc.flow_bcs(_j(V), jbc.VelocityBoundaryConditions(**kw))
    assert len(p) == 3
    for a, b in zip(p, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert all(torch.equal(a, b) for a, b in zip(_t(V), _t(V)))  # inputs left as they were


# ---- the canvas coefficients and the chunk ------------------------------------
def _coeffs_both(name, ni=NI):
    """The port's and JAX's CanvasCoeffs3D for a chip_smoke 3D case."""
    fields, (eta, fx, fy, fz), phys, li, _ = ve3d_numpy(name, ni)
    g = JGeometry(ni, li)
    pt = JCoeffs.make(g.li, g.di, CFL=0.9 / math.sqrt(3.1))
    args = (pt.r, pt.theta_dtau, pt.etadtau)
    j = jcv.ve3d_canvas_coefficients(_j(eta), jmaxloc(_j(eta), 1), *args, fx=_j(fx),
                                     fy=_j(fy), fz=_j(fz), **{k: _j(v) for k, v in phys.items()})
    p = pcv.ve3d_canvas_coefficients(_t(eta), maxloc(_t(eta), 1), *args, fx=_t(fx),
                                     fy=_t(fy), fz=_t(fz), **{k: _t(v) for k, v in phys.items()})
    return p, j


@pytest.mark.parametrize("name", ["viscous", "ve_general", "ve_dt_inf"])
def test_canvas_coefficients_match_jax(name):
    p, j = _coeffs_both(name)
    for field in pcv.CanvasCoeffs3D._fields:
        a, b = getattr(p, field), getattr(j, field)
        if b is None:
            assert a is None, field
            continue
        for x, y in zip(a if isinstance(b, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            if np.ndim(y) == 0:
                assert not isinstance(x, torch.Tensor) or x.ndim == 0, field
                assert float(x) == float(y), field
            else:
                assert _rel(x, y) <= 1e-15, field
    if name == "viscous":
        assert p.c1 is None and p.c2 is None and p.d_c is None and p.d_e is None
        assert isinstance(p.a_c, float)


def _carries(name, ni=NI):
    fields = ve3d_numpy(name, ni)[0]
    return tuple(pcv.pack_carry(*_t(fields))), tuple(jcv.pack_carry(*_j(fields)))


def _assert_chunks_close(got, want, ni, what):
    got = pcv.unpack_carry(torch.stack(tuple(got)), *ni)
    want = jcv.unpack_carry(jnp.stack(tuple(want)), *ni)
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-14,
                                   err_msg=f"{name} ({what})")


@pytest.mark.parametrize("name", VE3D_CASES)
def test_chunk_reference_matches_canvas_chunk(name):
    pco, jco = _coeffs_both(name)
    pc, jc = _carries(name)
    free_slip = ve3d_numpy(name, NI)[4]
    inv_di = tuple(1.0 / d for d in Geometry(NI, (1.0, 1.3, 0.8)).di)
    got = h3.stokes3d_chunk_reference(pc, pco, inv_di, 5, free_slip=free_slip)
    want = jcv.stokes3d_chunk_canvas(jc, jco, inv_di, 5, free_slip=free_slip)
    _assert_chunks_close(got, want, NI, name)
    if not free_slip:  # the ghosts keep their values
        assert torch.equal(got[0][:, 0], pc[0][:, 0])


@pytest.mark.parametrize("route", ["viscous", "ve_general", "viscous_consts"])
def test_chunk_reference_matches_tpu_kernel(route):
    """The plain chunk against B7 in interpret mode, two iterations per pass
    over three plane blocks (nout 5 exercises the remainder)."""
    name = "viscous" if route == "viscous_consts" else route
    pc, jc = _carries(name)
    inv_di = tuple(1.0 / d for d in Geometry(NI, (1.0, 1.3, 0.8)).di)
    blocking = dict(interpret=True, plane_block=8, iters_per_pass=2, pipeline=False)
    if route == "viscous_consts":
        _, _, _, _, (consts, scalars) = ve3d_case(name, NI, torch.float64, CPU)
        got = h3.stokes3d_chunk_reference(pc, None, inv_di, 5, viscous_consts=consts,
                                          pt_scalars=scalars)
        want = stokes3d_chunk_blocked(jc, None, inv_di, 5, viscous_consts=_j(consts),
                                      pt_scalars=scalars, **blocking)
    else:
        pco, jco = _coeffs_both(name)
        got = h3.stokes3d_chunk_reference(pc, pco, inv_di, 5)
        want = stokes3d_chunk_blocked(jc, jco, inv_di, 5, **blocking)
    _assert_chunks_close(got, want, NI, route)


def test_chip_smoke_case_is_the_test_set_up():
    """chip_smoke's torch case equals the numpy set-up it is built from."""
    carry, co, inv_di, free_slip, _ = ve3d_case("ve_general", NI, torch.float64, CPU)
    pco, _ = _coeffs_both("ve_general")
    pc, _ = _carries("ve_general")
    assert free_slip and all(torch.equal(a, b) for a, b in zip(carry, pc))
    assert torch.equal(co.c2, pco.c2) and torch.equal(co.d_e[2], pco.d_e[2])


def test_pack_unpack_round_trip():
    fields = _t(ve3d_numpy("viscous", NI)[0])
    C = pcv.pack_carry(*fields)
    assert tuple(C.shape) == (10, NI[0] + 2, NI[1] + 2, NI[2] + 2)
    for a, b in zip(pcv.unpack_carry(C, *NI), fields):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(C.numpy(), np.asarray(jcv.pack_carry(*_j(fields))))
    assert torch.equal(pcv.pack_carry(*pcv.unpack_carry(C, *NI)), C)


# ---- the wrapper ------------------------------------------------------------
def test_chunk_cpu_route_and_nout_zero():
    carry, co, inv_di, free_slip, derive = ve3d_case("ve_general", NI, torch.float64, CPU)
    h3.stokes3d_chunk.launches = 0
    out = h3.stokes3d_chunk(carry, co, inv_di, 3)
    ref = h3.stokes3d_chunk_reference(carry, co, inv_di, 3)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    packed = h3.pack_coeffs(co)
    assert all(torch.equal(a, b) for a, b in zip(h3.stokes3d_chunk(carry, packed, inv_di, 3), ref))
    same = h3.stokes3d_chunk(carry, co, inv_di, 0)
    assert all(a is b for a, b in zip(same, carry))
    stacked = h3.stokes3d_chunk(torch.stack(carry), co, inv_di, 3)
    assert all(torch.equal(a, b) for a, b in zip(stacked, ref))
    assert h3.stokes3d_chunk.launches == 0


@pytest.mark.parametrize("name", ["viscous", "ve_general", "ve_dt_inf"])
def test_pack_coeffs_slots(name):
    _, co, _, _, _ = ve3d_case(name, NI, torch.float64, CPU)
    p = h3.pack_coeffs(co)
    slots = dict(zip(h3.COEF_NAMES, p.slots))
    values = dict(zip(h3.COEF_NAMES, p.values))
    n_canvas = 23 if name == "ve_general" else 11
    assert p.stack.shape == (n_canvas, NI[0] + 2, NI[1] + 2, NI[2] + 2) and p.stack.is_contiguous()
    if name != "ve_general":
        for k in ("c1", "c2", "d_c0", "d_c1", "d_c2", "d_e0", "d_e1", "d_e2"):
            assert slots[k] == -2, k
        a = co.a_c if name == "viscous" else float(co.a_c[1, 1, 1])
        for k in ("a_c", "a_e0", "a_e1", "a_e2"):
            assert slots[k] == -1 and values[k] == a, k
    assert torch.equal(p.stack[slots["c3"]], co.c3)
    assert torch.equal(p.stack[slots["f2"]], co.f[2])
    assert h3.pack_coeffs(p) is p
    with pytest.raises(ValueError, match="c3"):
        h3.pack_coeffs(co._replace(c3=1.0))


def _slot_view(p):
    """The coefficients as the kernel reads them from the slot table of the
    PackedCoeffs3D ``p``: a canvas of the stack, a scalar, or absent."""
    v = [p.stack[s] if s >= 0 else (p.values[k] if s == -1 else None)
         for k, s in enumerate(p.slots)]
    return pcv.CanvasCoeffs3D(*v[:5], tuple(v[5:8]), tuple(v[8:11]), tuple(v[11:14]),
                              tuple(v[14:17]), tuple(v[17:20]), tuple(v[20:23]))


@pytest.mark.parametrize("name", VE3D_CASES + ("uniform", "solvi3d"))
def test_packed_slots_compute_the_same(name):
    """Uniform canvases taken as scalars, and neutral ones left out, give the
    plain chunk's values exactly: the chip_smoke cases, a viscous form whose
    every canvas is uniform (an empty stack), and SolVi's first chunk at 8³
    as solve_ve_3d's kernel path builds it (dt = ∞, ρg = 0: 8 canvases)."""
    if name == "solvi3d":
        geometry, st, pt, _, rho_g, G, K, dt = solvi3d._setup(
            nx=8, ny=8, nz=8, rc=2.0, dtype=torch.float64, device="cpu")
        carry, packed, inv_di = kernel_chunk_inputs(st, pt, geometry, rho_g, G, K, dt)
        free_slip, n_canvas = True, 8
    else:
        case = "viscous" if name == "uniform" else name
        carry, co, inv_di, free_slip, (_, (r_theta, theta_dtau, etadtau)) = ve3d_case(
            case, NI, torch.float64, CPU)
        if name == "uniform":
            one = torch.ones(NI, dtype=torch.float64)
            co = pcv.ve3d_canvas_coefficients(one, one, r_theta * theta_dtau, theta_dtau,
                                              etadtau)
        packed = h3.pack_coeffs(co)
        n_canvas = {"uniform": 0, "ve_general": 23}.get(name, 11)
    assert packed.stack.shape[0] == n_canvas
    want = h3.stokes3d_chunk_reference(carry, packed, inv_di, 5, free_slip=free_slip)
    got = pcv.stokes3d_chunk_canvas(tuple(carry), _slot_view(packed), inv_di, 5,
                                    free_slip=free_slip)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_chunk_refusals():
    carry, co, inv_di, _, (consts, _) = ve3d_case("viscous", (6, 5, 4), torch.float64, CPU)
    with pytest.raises(ValueError, match="10"):
        h3.stokes3d_chunk(carry[:9], co, inv_di, 1)
    with pytest.raises(ValueError, match="pt_scalars"):
        h3.stokes3d_chunk(carry, None, inv_di, 1, viscous_consts=consts)
    with pytest.raises(ValueError, match="viscous_consts"):
        h3.stokes3d_chunk(carry, None, inv_di, 1)
    meta = tuple(t.to("meta") for t in carry)
    with pytest.raises(ValueError, match="device"):
        h3.stokes3d_chunk(meta, co, inv_di, 1)
    with pytest.raises(ValueError, match="dtype"):
        h3._check_carry(tuple(t.half() for t in carry))
    with pytest.raises(ValueError, match="shape"):
        h3._check_carry(carry[:3] + (carry[3][:-1].contiguous(),) + carry[4:])
    with pytest.raises(ValueError, match="canvas 0"):
        h3._check_carry((carry[0].float(),) + carry[1:])
    with pytest.raises(ValueError, match="contiguous"):
        h3._check_carry((carry[0].transpose(1, 2).contiguous().transpose(1, 2),) + carry[1:])
    packed = h3.pack_coeffs(co)
    with pytest.raises(ValueError, match="coefficients"):
        h3._check_coeffs(packed, carry[3].float())
    with pytest.raises(ValueError, match="stack"):
        h3._check_coeffs(packed._replace(stack=packed.stack[:, :-1].contiguous()), carry[3])


def test_guard():
    g = Geometry((8, 8, 8), (1.0, 1.0, 1.0))
    fs = pbc.VelocityBoundaryConditions(**_BCS3["free_slip"])
    assert h3.ve3d_chunk_unsupported(g, fs) is None
    assert "free-slip" in h3.ve3d_chunk_unsupported(g, pbc.VelocityBoundaryConditions(
        free_slip=dict(left=True, right=True, top=True, bot=True, front=True)))
    assert "free-slip" in h3.ve3d_chunk_unsupported(g, pbc.VelocityBoundaryConditions(
        **_BCS3["free_slip"], no_slip=dict(top=True)))
    for kw in (dict(mean_free_RP=True), dict(boundary_shear=True), dict(alpha_dT=1.0)):
        assert "default" in h3.ve3d_chunk_unsupported(g, fs, **kw)

    @dataclasses.dataclass(frozen=True)
    class Nonuniform:
        di = g.di
        di_center = g.xci

    assert h3.ve3d_chunk_unsupported(Nonuniform(), fs) == "needs a uniform grid"
