"""The Hopper chunk kernels on the card: each kernel against its plain
PyTorch version, and the solves through them. These tests need a CUDA device
and an nvcc toolchain; elsewhere they skip. Run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: the suite's conftest configures JAX, which a machine with
the card need not have.)
"""

import dataclasses
import itertools
import math

import numpy as np
import pytest
import torch

from chip_smoke import (
    FACE_MODES,
    GOLDENS_MOVED,
    TH_CASES,
    TOL_F32_1024,
    TOL_VEP3D_CALL,
    TOL_VEP3D_NOUT50,
    VEP3D_CASES,
    VEP3D_CHUNK_CASES,
    VEP3D_EDGE_RAGGED,
    TOL_NOUT1,
    TOL_NOUT50,
    TOL_TH_NOUT1,
    TOL_VE3D_NOUT1,
    TOL_VE3D_NOUT200,
    TOL_VE_NOUT1,
    VARIATIONAL_MOVED,
    VE3D_CASES,
    VE_CASES,
    chunk_case,
    edge_args,
    as_f64,
    f32_gaps,
    flat_vep_carry,
    fused_chunk,
    hybrid_chunk,
    pallas_thermal_setup,
    rel_diffs,
    rel_diffs_edges,
    rel_diffs_th,
    rel_diffs_ve,
    rel_diffs_ve3d,
    rel_diffs_vep3d,
    thermal_case,
    ve3d_case,
    ve_case,
    ve_random_case,
    vep3d_case,
    vep_random_case,
)
from justrelax_tpu_torch.core.coeffs import PTThermalCoeffs
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.core.state import ThermalState
from justrelax_tpu_torch.models import shearband, shearband3d, solcx, solvi3d
from justrelax_tpu_torch.ops import hopper_stokes as hs
from justrelax_tpu_torch.ops import hopper_stokes3d as h3
from justrelax_tpu_torch.ops import hopper_stokes3d_vep as hc
from justrelax_tpu_torch.ops import hopper_stokes_vep as hv
from justrelax_tpu_torch.ops import hopper_thermal as ht
from justrelax_tpu_torch.ops import hopper_vep3d_edges as he
from justrelax_tpu_torch.ops import hopper_window_copy as hw
from justrelax_tpu_torch.ops.bc import Faces, TemperatureBoundaryConditions, thermal_bcs
from justrelax_tpu_torch.ops.stokes3d_canvas import ve3d_canvas_coefficients
from justrelax_tpu_torch.ops.stokes3d_vep_canvas import (
    VEP3DCanvasCarry,
    edge_masks,
    vep3d_canvas_consts,
)
from justrelax_tpu_torch.rheology import materials as pm
from justrelax_tpu_torch.rheology.phases import phase_ratios_from_field
from justrelax_tpu_torch.solvers.thermal import heatdiffusion_PT

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


CASES = ["shearband", "dpcap", "powerlaw_noslip", "buoyancy"]


@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_f64(cuda, case):
    args, kw = chunk_case(case, 48, torch.float64, cuda)
    for nout, tol in ((1, TOL_NOUT1), (50, TOL_NOUT50)):
        before = hv.stokes_vep_chunk.launches
        out = hv.stokes_vep_chunk(*args, nout=nout, **kw)
        assert hv.stokes_vep_chunk.launches == before + 1
        ref = hv.stokes_vep_chunk_reference(*args, nout=nout, **kw)
        worst = max(rel_diffs(out, ref).values())
        assert worst <= tol, (case, nout, worst)


@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_f32(cuda, case):
    """f32: within 1e-4 of the plain version, or within twice the plain
    version's own f32 rounding error against f64 where that is larger."""
    args, kw = chunk_case(case, 48, torch.float32, cuda)
    for nout in (1, 50):
        _, gap, _, p_vs_64, _ = f32_gaps(
            hv.stokes_vep_chunk, hv.stokes_vep_chunk_reference, rel_diffs, args, kw, nout)
        assert gap <= max(TOL_F32_1024, 2.0 * p_vs_64), (case, nout, gap, p_vs_64)


def test_kernel_rejects_bad_inputs(cuda):
    args, kw = chunk_case("shearband", 16, torch.float64, cuda)
    bad = (args[0].t().contiguous().t(),) + args[1:]  # non-contiguous Vx
    with pytest.raises(ValueError):
        hv.stokes_vep_chunk(*bad, nout=1, **kw)
    mixed = (args[0].float(),) + args[1:]
    with pytest.raises(ValueError):
        hv.stokes_vep_chunk(*mixed, nout=1, **kw)


def test_solve_through_kernel_matches_plain(cuda):
    a = shearband.run(n=24, nt=2, use_kernel=True, device=cuda)
    b = shearband.run(n=24, nt=2, use_kernel=False, device=cuda)
    assert a[1].iters == b[1].iters
    assert math.isclose(a[2][-1], b[2][-1], rel_tol=1e-9)
    assert float((a[4] - b[4]).abs().max()) <= 1e-9


@pytest.mark.parametrize("case", VE_CASES)
def test_ve_kernel_matches_plain_f64(cuda, case):
    args, kw = ve_case(case, 48, torch.float64, cuda)
    for nout, tol in ((1, TOL_VE_NOUT1), (100, 1e-10)):
        before = hs.stokes_chunk.launches
        out = hs.stokes_chunk(*args, nout=nout, **kw)
        assert hs.stokes_chunk.launches == before + 1
        ref = hs.stokes_chunk_reference(*args, nout=nout, **kw)
        worst = max(rel_diffs_ve(out, ref).values())
        assert worst <= tol, (case, nout, worst)
    out = hs.stokes_chunk(*args, nout=10, free_slip=False, **kw)
    ref = hs.stokes_chunk_reference(*args, nout=10, free_slip=False, **kw)
    assert max(rel_diffs_ve(out, ref).values()) <= 1e-12
    assert torch.equal(out[0][:, 0], args[0][:, 0])  # ghosts left as they were


@pytest.mark.parametrize("case", VE_CASES)
def test_ve_kernel_matches_plain_f32(cuda, case):
    """f32: as the VEP kernel's f32 test."""
    args, kw = ve_case(case, 48, torch.float32, cuda)
    for nout in (1, 100):
        _, gap, _, p_vs_64, _ = f32_gaps(
            hs.stokes_chunk, hs.stokes_chunk_reference, rel_diffs_ve, args, kw, nout)
        assert gap <= max(TOL_F32_1024, 2.0 * p_vs_64), (case, nout, gap, p_vs_64)


def test_ve_kernel_rejects_bad_inputs(cuda):
    args, kw = ve_case("ve_compressible", 16, torch.float64, cuda)
    bad = (args[0].t().contiguous().t(),) + args[1:]  # non-contiguous Vx
    with pytest.raises(ValueError):
        hs.stokes_chunk(*bad, nout=1, **kw)
    mixed = (args[0].float(),) + args[1:]
    with pytest.raises(ValueError):
        hs.stokes_chunk(*mixed, nout=1, **kw)
    short = (args[0][:-1].contiguous(),) + args[1:]  # wrong Vx shape
    with pytest.raises(ValueError):
        hs.stokes_chunk(*short, nout=1, **kw)


def test_solve_ve_through_kernel_matches_plain(cuda):
    kw = dict(nx=24, ny=24, iter_max=2_000, nout=500, device=cuda)
    _, a, info_a, _ = solcx.run(use_kernel=True, **kw)
    _, b, info_b, _ = solcx.run(use_kernel=False, **kw)
    assert info_a.iters == info_b.iters
    for x, y in ((a.V.Vx, b.V.Vx), (a.V.Vy, b.V.Vy), (a.P, b.P), (a.tau.xy, b.tau.xy)):
        assert float((x - y).abs().max()) <= 1e-10 * float(y.abs().max())


def test_default_launches_the_kernels(cuda):
    """With no use_kernel argument the entry points launch their kernels on
    the card; the default device is the card."""
    hs.stokes_chunk.launches = 0
    _, st, _, _ = solcx.run(nx=16, ny=16, iter_max=1_000, nout=500)
    assert st.P.device.type == "cuda"
    assert hs.stokes_chunk.launches > 0
    hv.stokes_vep_chunk.launches = 0
    shearband.run(n=16, nt=1, iter_max=200, nout=100)
    assert hv.stokes_vep_chunk.launches > 0


@pytest.mark.parametrize("case", TH_CASES)
def test_thermal_kernel_matches_plain_f64(cuda, case):
    args, kw = thermal_case(case, 48, torch.float64, cuda)
    for nout, tol in ((1, TOL_TH_NOUT1), (100, 1e-10)):
        before = ht.thermal_chunk.launches
        out = ht.thermal_chunk(*args, nout=nout, **kw)
        assert ht.thermal_chunk.launches == before + 1
        ref = ht.thermal_chunk_reference(*args, nout=nout, **kw)
        worst = max(rel_diffs_th(out, ref).values())
        assert worst <= tol, (case, nout, worst)  # the whole ghosted T, corners included


@pytest.mark.parametrize("case", TH_CASES)
def test_thermal_kernel_matches_plain_f32(cuda, case):
    """f32: as the VEP kernel's f32 test."""
    args, kw = thermal_case(case, 48, torch.float32, cuda)
    for nout in (1, 100):
        _, gap, _, p_vs_64, _ = f32_gaps(
            ht.thermal_chunk, ht.thermal_chunk_reference, rel_diffs_th, args, kw, nout)
        assert gap <= max(TOL_F32_1024, 2.0 * p_vs_64), (case, nout, gap, p_vs_64)


def test_thermal_kernel_rejects_bad_inputs(cuda):
    args, kw = thermal_case("pallas_setup", 16, torch.float64, cuda)
    bad = (args[0].t().contiguous().t(),) + args[1:]  # non-contiguous T
    mixed = (args[0].float(),) + args[1:]
    short = args[:1] + (args[1][:-1].contiguous(),) + args[2:]  # wrong qx shape
    periodic = args[:-1] + (TemperatureBoundaryConditions(periodic=Faces(left=True, right=True)),)
    for a in (bad, mixed, short, periodic):
        with pytest.raises(ValueError):
            ht.thermal_chunk(*a, nout=1, **kw)
    tiny, tkw = thermal_case("insulated", 1, torch.float64, cuda)
    with pytest.raises(ValueError):
        ht.thermal_chunk(*tiny, nout=1, **tkw)


def _thermal_solve_inputs(n, dev):
    """The 32² golden set-up of chip_smoke at n²; ``dev=None`` is the
    default device."""
    th = ThermalState.make((n, n), device=dev)
    g, K, rc, bc, Tg = pallas_thermal_setup(n, torch.float64, th.T.device)
    th = th.replace(T=Tg, Told=Tg)
    return th, PTThermalCoeffs.make(K, rc, 0.3, g.di, g.li), bc, g, K, rc


def test_heatdiffusion_through_kernel_matches_plain(cuda):
    th, pt, bc, g, K, rc = _thermal_solve_inputs(24, cuda)
    th = th.replace(adiabatic=torch.full_like(th.adiabatic, 0.01))
    kw = dict(K=K, rho_Cp=rc, iter_max=4000, nout=200)
    a, ia = heatdiffusion_PT(th, pt, bc, 0.3, g, use_kernel=True, **kw)
    b, ib = heatdiffusion_PT(th, pt, bc, 0.3, g, use_kernel=False, **kw)
    assert ia.iters == ib.iters
    for x, y in ((a.T, b.T), (a.qTx, b.qTx), (a.qTy, b.qTy), (a.qTx2, b.qTx2)):
        assert float((x - y).abs().max()) <= 1e-10 * float(y.abs().max())


def test_default_launches_the_thermal_kernel(cuda):
    """With no use_kernel argument heatdiffusion_PT launches the thermal
    kernel on the card for K/ρCp, and raises for a material."""
    th, pt, bc, g, K, rc = _thermal_solve_inputs(16, None)
    assert th.T.device.type == "cuda"
    ht.thermal_chunk.launches = 0
    heatdiffusion_PT(th, pt, bc, 0.3, g, K=K, rho_Cp=rc, iter_max=400, nout=200)
    assert ht.thermal_chunk.launches > 0
    with pytest.raises(ValueError, match="use_kernel=False"):
        heatdiffusion_PT(th, pt, bc, 0.3, g, material=pm.Material(k=1.0, rho0=1.0, Cp=1.0),
                         P=torch.zeros_like(K), iter_max=400, nout=200)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bare_material_follows_cuda_fields(cuda, dtype):
    T = torch.linspace(300.0, 1600.0, 20, dtype=dtype, device=cuda).reshape(5, 4)
    bare = pm.Material(rho0=3.1e3, alpha=1.5e-5, Cp=1.2e3, k=3.0, G=3e10)
    stack = pm.MaterialStack.make([bare], dtype=dtype, device=cuda)
    for fn in (pm.compute_density, pm.compute_rhoCp, pm.compute_conductivity):
        a, b = fn(bare, T=T), fn(stack, T=T)
        assert a.device.type == "cuda" and a.dtype == dtype
        assert torch.equal(a, b)
    G = pm.get_shear_modulus(bare, like=T)
    assert G.device.type == "cuda" and G.dtype == dtype


@pytest.mark.parametrize("route", ["viscous_consts_vs_G_none", "viscous_consts"])
def test_ve3d_viscous_consts_route(cuda, route):
    """The derive route against its plain version, and against the kernel
    with the coefficients of ``ve3d_canvas_coefficients(G=None)`` (the same
    values up to the order of one product)."""
    carry, _, inv_di, _, (consts, scalars) = ve3d_case("viscous", (32, 32, 32),
                                                       torch.float64, cuda)
    out = h3.stokes3d_chunk(carry, None, inv_di, 20, viscous_consts=consts, pt_scalars=scalars)
    if route == "viscous_consts":
        ref = h3.stokes3d_chunk_reference(carry, None, inv_di, 20, viscous_consts=consts,
                                          pt_scalars=scalars)
    else:
        eta, eta_tau, fx, fy, fz = consts
        r_theta, theta_dtau, etadtau = scalars
        co = ve3d_canvas_coefficients(eta, eta_tau, r_theta * theta_dtau, theta_dtau, etadtau,
                                      fx=fx, fy=fy, fz=fz)
        ref = h3.stokes3d_chunk(carry, co, inv_di, 20)
    assert max(rel_diffs_ve3d(out, ref).values()) <= 1e-12


def _ve3d_ni(case):
    return (22, 9, 7) if case == "ve_general" else (32, 32, 32)


@pytest.mark.parametrize("case", VE3D_CASES)
def test_ve3d_kernel_matches_plain_f64(cuda, case):
    carry, co, inv_di, free_slip, _ = ve3d_case(case, _ve3d_ni(case), torch.float64, cuda)
    for nout, tol in ((1, TOL_VE3D_NOUT1), (200, TOL_VE3D_NOUT200)):
        before = h3.stokes3d_chunk.launches
        out = h3.stokes3d_chunk(carry, co, inv_di, nout, free_slip=free_slip)
        assert h3.stokes3d_chunk.launches == before + 1
        ref = h3.stokes3d_chunk_reference(carry, co, inv_di, nout, free_slip=free_slip)
        worst = max(rel_diffs_ve3d(out, ref).values())
        assert worst <= tol, (case, nout, worst)
    if not free_slip:  # the ghosts keep their values
        assert torch.equal(out[0][:, 0], carry[0][:, 0])


def test_ve3d_kernel_uniform_coefficients(cuda):
    """Every coefficient canvas uniform (η = 1, f = 0): the kernel runs on
    an empty canvas stack, all coefficients scalars or absent."""
    carry, _, inv_di, _, (_, (r_theta, theta_dtau, etadtau)) = ve3d_case(
        "viscous", (16, 16, 16), torch.float64, cuda)
    one = torch.ones((16, 16, 16), dtype=torch.float64, device=cuda)
    co = ve3d_canvas_coefficients(one, one, r_theta * theta_dtau, theta_dtau, etadtau)
    assert h3.pack_coeffs(co).stack.shape[0] == 0
    for nout, tol in ((1, TOL_VE3D_NOUT1), (200, TOL_VE3D_NOUT200)):
        out = h3.stokes3d_chunk(carry, co, inv_di, nout)
        ref = h3.stokes3d_chunk_reference(carry, co, inv_di, nout)
        assert max(rel_diffs_ve3d(out, ref).values()) <= tol, nout


@pytest.mark.parametrize("case", VE3D_CASES)
def test_ve3d_kernel_matches_plain_f32(cuda, case):
    """f32: as the VEP kernel's f32 test, the plain version's f64 result on
    the same seed as the yardstick."""
    ni = _ve3d_ni(case)
    carry, co, inv_di, free_slip, _ = ve3d_case(case, ni, torch.float32, cuda)
    carry64, co64, _, _, _ = ve3d_case(case, ni, torch.float64, cuda)
    for nout in (1, 100):
        out = h3.stokes3d_chunk(carry, co, inv_di, nout, free_slip=free_slip)
        ref = h3.stokes3d_chunk_reference(carry, co, inv_di, nout, free_slip=free_slip)
        ref64 = h3.stokes3d_chunk_reference(carry64, co64, inv_di, nout, free_slip=free_slip)
        gap = max(rel_diffs_ve3d(out, ref).values())
        p_vs_64 = max(rel_diffs_ve3d(ref, ref64).values())
        assert gap <= max(TOL_F32_1024, 2.0 * p_vs_64), (case, nout, gap, p_vs_64)


def test_ve3d_kernel_rejects_bad_inputs(cuda):
    carry, co, inv_di, _, _ = ve3d_case("viscous", (6, 5, 4), torch.float64, cuda)
    bad = (carry[0].transpose(1, 2).contiguous().transpose(1, 2),) + carry[1:]
    mixed = (carry[0].float(),) + carry[1:]
    short = carry[:3] + (carry[3][:-1].contiguous(),) + carry[4:]
    for c in (bad, mixed, short):
        with pytest.raises(ValueError):
            h3.stokes3d_chunk(c, co, inv_di, 1)
    packed = h3.pack_coeffs(co)
    with pytest.raises(ValueError):
        h3.stokes3d_chunk(carry, packed._replace(stack=packed.stack.float()), inv_di, 1)


def test_solve_ve_3d_through_kernel_matches_plain(cuda):
    """SolVi at 12³ with the inclusion resolved (rc = 2), a fixed 400
    iterations: the kernel path against the plain path on the card. The
    iteration counts are equal (ϵ is not reached), the fields agree to
    rounding."""
    kw = dict(nx=12, ny=12, nz=12, rc=2.0, iter_max=400, nout=200, device=cuda)
    _, a, ia = solvi3d.run(use_kernel=True, **kw)
    _, b, ib = solvi3d.run(use_kernel=False, **kw)
    assert ia.iters == ib.iters == 400
    for x, y in ((a.V.Vx, b.V.Vx), (a.V.Vz, b.V.Vz), (a.P, b.P), (a.tau.xy, b.tau.xy),
                 (a.tau.II, b.tau.II)):
        assert float((x - y).abs().max()) <= 1e-10 * float(y.abs().max())


def test_default_launches_the_3d_kernel(cuda):
    """With no use_kernel argument solvi3d runs on the card through B7."""
    h3.stokes3d_chunk.launches = 0
    _, st, _ = solvi3d.run(nx=8, ny=8, nz=8, rc=2.0, iter_max=200, nout=100)
    assert st.P.device.type == "cuda"
    assert h3.stokes3d_chunk.launches > 0


# The four options of a face in the thermal kernel's BC recipe
_TH_OPTIONS = ("none", "constant_value", "no_flux", "both")
_TH_FACES = ("bot", "top", "left", "right")


def _thermal_bc(combo):
    cv = {f: 0.25 + 0.5 * k for k, (f, o) in enumerate(zip(_TH_FACES, combo))
          if o in ("constant_value", "both")}
    nf = {f: True for f, o in zip(_TH_FACES, combo) if o in ("no_flux", "both")}
    return TemperatureBoundaryConditions(constant_value=Faces(**cv), no_flux=Faces(**nf))


@pytest.mark.parametrize("nx,ny", [(2, 2), (3, 5), (6, 4)])
def test_thermal_kernel_every_face_combination(cuda, nx, ny):
    """B5's owner-write and corner-replay rule (csrc/thermal.cu) against the
    plain chunk for all 256 combinations of none, constant_value, no_flux or
    both on the four faces, f64, nout 1 and 3, the whole ghosted T (corners
    included) from a random, BC-inconsistent start."""
    kw = dict(dtype=torch.float64, device=cuda)
    rng = np.random.default_rng(nx * 10 + ny)
    g = Geometry((nx, ny), (1.0, 1.3))
    K = torch.as_tensor(np.exp(0.3 * rng.normal(size=(nx, ny))), **kw)
    rc = torch.as_tensor(1.0 + 0.2 * rng.random((nx, ny)), **kw)
    T = torch.as_tensor(rng.normal(size=(nx + 2, ny + 2)), **kw)
    qx = torch.as_tensor(0.1 * rng.normal(size=(nx + 1, ny)), **kw)
    qy = torch.as_tensor(0.1 * rng.normal(size=(nx, ny + 1)), **kw)
    H = torch.as_tensor(rng.random((nx, ny)), **kw)
    dt = 0.3
    pt = PTThermalCoeffs.make(K, rc, dt, g.di, g.li)
    worst = 0.0
    for combo in itertools.product(_TH_OPTIONS, repeat=4):
        bc = _thermal_bc(combo)
        args = (T, qx, qy, thermal_bcs(T, bc), K, rc, H, pt.dtau_rho, pt.theta_r_dtau,
                1.0 / dt, 1.0 / g.di[0], 1.0 / g.di[1], bc)
        for nout in (1, 3):
            out = ht.thermal_chunk(*args, nout=nout)
            ref = ht.thermal_chunk_reference(*args, nout=nout)
            d = max(rel_diffs_th(out, ref).values())
            worst = max(worst, d)
            assert d <= TOL_TH_NOUT1, (combo, nout, d)
    assert worst <= TOL_TH_NOUT1


# ---- the 3D VEP edge kernel (B6, and B9 per family) -------------------------
def _edge_call(case, dtype, dev, split, fn):
    carry, co6, co9, _, inv_di, kw = vep3d_case(case, dtype, dev)
    args, ekw = edge_args(carry, co9 if split else co6, inv_di, kw)
    tau, lam = fn(*args, split=split, **ekw)
    return carry, (*tau, *lam)


@pytest.mark.parametrize("split", [False, True], ids=["B6", "B9"])
@pytest.mark.parametrize("case", VEP3D_CASES)
def test_vep3d_edges_match_plain_f64(cuda, case, split):
    """One call against the plain version (≤ 1e-12 of each field's max), the
    launch counted on its route, and the slots a family does not own
    bit-equal to the input."""
    counter = "split_launches" if split else "launches"
    before = getattr(he.vep3d_edges, counter)
    carry, out = _edge_call(case, torch.float64, cuda, split, he.vep3d_edges)
    assert getattr(he.vep3d_edges, counter) == before + 1
    _, ref = _edge_call(case, torch.float64, cuda, split, he.vep3d_edges_reference)
    worst = max(rel_diffs_edges(out, ref).values())
    assert worst <= TOL_VEP3D_CALL, (case, split, worst)
    _, Me = edge_masks(tuple(carry.P.shape), cuda)
    for k, (o, b) in enumerate(zip(out, (*carry.tau_e, *carry.lam_e))):
        off = ~Me[k % 3].expand(o.shape)
        assert torch.equal(o[off], b[off]), (case, k)


@pytest.mark.parametrize("split", [False, True], ids=["B6", "B9"])
@pytest.mark.parametrize("case", VEP3D_CASES)
def test_vep3d_edges_match_plain_f32(cuda, case, split):
    """f32: within 1e-4 of the plain version, or twice the plain version's
    own f32 error against f64."""
    _, out = _edge_call(case, torch.float32, cuda, split, he.vep3d_edges)
    _, ref = _edge_call(case, torch.float32, cuda, split, he.vep3d_edges_reference)
    _, ref64 = _edge_call(case, torch.float64, cuda, split, he.vep3d_edges_reference)
    gap = max(rel_diffs_edges(out, ref).values())
    p_vs_64 = max(rel_diffs_edges(tuple(x.double() for x in ref), ref64).values())
    assert gap <= max(TOL_F32_1024, 2.0 * p_vs_64), (case, split, gap, p_vs_64)


@pytest.mark.parametrize("split", [False, True], ids=["B6", "B9"])
@pytest.mark.parametrize("case", ["blocked_plastic", "noncubic_near_yield",
                                  "shearband3d_kb_inf"])
def test_vep3d_hybrid_chunk_matches_plain(cuda, case, split):
    """The hybrid iteration through the kernel against the same iteration
    with the plain edge passes: 1 iteration to rounding, 50 within the
    yield-flip gate, the plastic branch active."""
    carry, co6, co9, material, inv_di, kw = vep3d_case(case, torch.float64, cuda)
    co = co9 if split else co6
    for nit, tol in ((1, TOL_VEP3D_CALL), (50, TOL_VEP3D_NOUT50)):
        out = hybrid_chunk(carry, co, material, inv_di, kw, nit, split)
        ref = hybrid_chunk(carry, co, material, inv_di, kw, nit, split, plain=True)
        worst = max(rel_diffs_vep3d(out, ref).values())
        assert worst <= tol, (case, split, nit, worst)
    assert max(float(x.max()) for x in ref.lam_e) > 0.0


@pytest.mark.parametrize("ni", [(5, 4, 3), (3, 7, 4), (4, 3, 9)])
def test_vep3d_edges_random_carries_noncubic(cuda, ni):
    """Random canvases everywhere, the ghost and padding slots included, on
    small non-cubic grids with unequal spacings, near yield with dilatancy
    and a tension cap: B6 and B9 against the plain version, f64, so that a
    swapped axis, a clamp off by one or a read of a slot the plain version
    never reads shows."""
    gen = torch.Generator(device="cpu").manual_seed(sum(ni))
    nx, ny, nz = ni
    canvas = (nx + 2, ny + 2, nz + 2)

    def rand(shape=canvas, scale=0.3):
        return (scale * torch.randn(shape, generator=gen, dtype=torch.float64)).to(cuda)

    common = dict(Kb=6.0, is_plastic=1.0, C=0.35, friction_angle=30.0, dilation_angle=10.0,
                  eta_reg=1e-2, tension_pT=-0.6)
    mat = pm.MaterialStack.make([pm.Material(G=1.0, eta0=1.0, **common),
                                 pm.Material(G=0.6, eta0=0.2, **common)],
                                dtype=torch.float64, device=cuda)
    pr = phase_ratios_from_field((torch.rand(ni, generator=gen) < 0.4).long().to(cuda), 2)
    z = torch.zeros(ni, dtype=torch.float64, device=cuda)
    ckw = dict(tau_o_c6=tuple(rand(ni) for _ in range(6)),
               tau_o_e3=(rand((nx, ny + 1, nz + 1)), rand((nx + 1, ny, nz + 1)),
                         rand((nx + 1, ny + 1, nz))),
               EII_pl=z, P0=z, Q=z, phase_ratios_center=pr.center,
               phase_ratios_edges=(pr.edge_yz, pr.edge_xz, pr.edge_xy),
               scalar_plastic=True, scalar_K=True)
    dyn = ((rand(scale=1.0), rand(scale=1.0), rand(scale=1.0)), rand(scale=0.2), rand().exp(),
           (rand(), rand(), rand()), (rand(), rand(), rand()),
           (rand(scale=0.05).abs(), rand(scale=0.05).abs(), rand(scale=0.05).abs()))
    kw = dict(dt=0.2, theta_dtau=0.7, lambda_relaxation=0.2)
    inv_di = (1.0 / 0.3, 1.0 / 0.2, 1.0 / 0.45)
    for split in (False, True):
        co = vep3d_canvas_consts(mat, hoist_tau_o=split, **ckw)
        out = he.vep3d_edges(*dyn, co, inv_di, split=split, **kw)
        ref = he.vep3d_edges_reference(*dyn, co, inv_di, split=split, **kw)
        worst = max(rel_diffs_edges((*out[0], *out[1]), (*ref[0], *ref[1])).values())
        assert worst <= TOL_VEP3D_CALL, (ni, split, worst)


@pytest.mark.parametrize("split", [False, True], ids=["B6", "B9"])
@pytest.mark.parametrize("ni", VEP3D_EDGE_RAGGED)
def test_vep3d_edges_ragged_grids(cuda, ni, split):
    """Phase 18's random near-yield configuration on grids that leave the
    kernel's (y, z) tile unfilled, span two tiles and split x into ranges
    of one or two planes: f64 within 1e-12 of the plain version, f32 within
    1e-4 or twice the plain version's own f32 error, and the slots a family
    does not own bit-equal to the input."""
    res = {}
    for dtype in (torch.float64, torch.float32):
        carry, co6, co9, _, inv_di, kw = vep3d_case("noncubic_near_yield", dtype, cuda, ni=ni)
        args, ekw = edge_args(carry, co9 if split else co6, inv_di, kw)
        out = he.vep3d_edges(*args, split=split, **ekw)
        ref = he.vep3d_edges_reference(*args, split=split, **ekw)
        out, ref = (*out[0], *out[1]), (*ref[0], *ref[1])
        _, Me = edge_masks(tuple(carry.P.shape), cuda)
        for k, (o, b) in enumerate(zip(out, (*carry.tau_e, *carry.lam_e))):
            off = ~Me[k % 3].expand(o.shape)
            assert torch.equal(o[off], b[off]), (dtype, k)
        res[dtype] = (out, ref)
    (o64, r64), (o32, r32) = res[torch.float64], res[torch.float32]
    assert max(rel_diffs_edges(o64, r64).values()) <= TOL_VEP3D_CALL
    p32 = max(rel_diffs_edges(tuple(x.double() for x in r32), r64).values())
    assert max(rel_diffs_edges(o32, r32).values()) <= max(TOL_F32_1024, 2.0 * p32)


def test_vep3d_edges_rejects_bad_inputs(cuda):
    carry, co6, _, _, inv_di, kw = vep3d_case("blocked_plastic", torch.float64, cuda)
    args, ekw = edge_args(carry, co6, inv_di, kw)
    V, theta = args[0], args[1]
    for bad in ((V[0].float(), V[1], V[2]), (V[0].transpose(0, 2).contiguous().transpose(0, 2),
                                             V[1], V[2])):
        with pytest.raises(ValueError):
            he.vep3d_edges(bad, *args[1:], **ekw)
    with pytest.raises(ValueError):  # B9 needs the hoisted interpolants
        he.vep3d_edges(*args, split=True, **ekw)
    with pytest.raises(ValueError):
        he.vep3d_edges(V, theta[:-1].contiguous(), *args[2:], **ekw)


def test_solve_vep_3d_routes_on_the_card(cuda):
    """ShearBand3D at 8³, a fixed 200 iterations: the default route (B6),
    "edges_split" (B9), "blocked" (B8) and "canvas" against the serial path
    on the card; B6 launched on the default route, B9 and B8 on their own;
    equal iteration counts, fields within 1e-9 of their max."""
    kw = dict(n=8, nt=1, dtype=torch.float64, device=cuda, iter_max=200, nout=100)
    he.vep3d_edges.launches = he.vep3d_edges.split_launches = 0
    hc.stokes3d_vep_chunk.launches = 0
    a, ia, _, _ = shearband3d.run(**kw)
    assert he.vep3d_edges.launches > 0 and he.vep3d_edges.split_launches == 0
    b, ib, _, _ = shearband3d.run(use_kernel="edges_split", **kw)
    assert he.vep3d_edges.split_launches > 0 and hc.stokes3d_vep_chunk.launches == 0
    e, ie, _, _ = shearband3d.run(use_kernel="blocked", **kw)
    assert hc.stokes3d_vep_chunk.launches > 0
    c, ic, _, _ = shearband3d.run(use_kernel="canvas", **kw)
    d, id_, _, _ = shearband3d.run(use_kernel=False, **kw)
    assert ia.iters == ib.iters == ic.iters == id_.iters == ie.iters
    for s in (a, b, c, e):
        for x, y in ((s.V.Vx, d.V.Vx), (s.P, d.P), (s.tau.II, d.tau.II), (s.tau.xz, d.tau.xz)):
            assert float((x - y).abs().max()) <= 1e-9 * max(float(y.abs().max()), 1.0)


def test_solve_vep_3d_refuses_on_the_card(cuda):
    """On the card the default route and "blocked" (B8) raise for a material
    the kernels do not take."""
    from justrelax_tpu_torch.solvers.stokes3d_vep import solve_vep_3d

    geometry, st, material, (pr_c, pr_e), bc, pt, dt = shearband3d._setup(6, torch.float64, cuda)
    soft = pm.MaterialStack(params=dataclasses.replace(
        material.params, soft_C_active=torch.ones(2, dtype=torch.float64, device=cuda)))
    with pytest.raises(ValueError, match="canvas"):
        solve_vep_3d(st, pt, geometry, bc, soft, pr_c, pr_e, dt, iter_max=10, nout=5)
    with pytest.raises(ValueError, match="canvas"):
        solve_vep_3d(st, pt, geometry, bc, soft, pr_c, pr_e, dt, use_kernel="blocked")


@pytest.mark.slow
def test_shearband3d_golden_f64(cuda):
    """tests/test_shearband3d.py's goldens through the default route (B6)."""
    he.vep3d_edges.launches = 0
    st, info, tau, _ = shearband3d.run(n=12, nt=14, dtype=torch.float64)
    assert he.vep3d_edges.launches > 0
    assert abs(tau[-1] - 1.625106) <= 1e-4
    assert abs(float(st.EII_pl.max()) - 0.3258544082022995) <= 1e-5 * 0.3258544082022995


# ---- the fused 3D VEP chunk (B8) -------------------------------------------
@pytest.mark.parametrize("case", VEP3D_CHUNK_CASES)
def test_vep3d_chunk_matches_plain_f64(cuda, case):
    """B8 against its plain version: 1 iteration to rounding, 50 within the
    yield-flip gate; the input carry is not written."""
    carry, co, _, _, inv_di, kw = vep3d_case(case, torch.float64, cuda)
    before = [t.clone() for t in flat_vep_carry(carry)]
    for nit, tol in ((1, TOL_VEP3D_CALL), (50, TOL_VEP3D_NOUT50)):
        out = fused_chunk(carry, co, inv_di, kw, nit)
        ref = fused_chunk(carry, co, inv_di, kw, nit, plain=True)
        worst = max(rel_diffs_vep3d(out, ref).values())
        assert worst <= tol, (case, nit, worst)
    assert all(torch.equal(a, b) for a, b in zip(before, flat_vep_carry(carry)))
    if case != "blocked_elastic":
        assert float(ref.lam.max()) > 0.0 and max(float(x.max()) for x in ref.lam_e) > 0.0


@pytest.mark.parametrize("case", VEP3D_CHUNK_CASES)
def test_vep3d_chunk_matches_plain_f32(cuda, case):
    """f32, 50 iterations: within 1e-4, or twice the plain version's own f32
    error against f64."""
    c32, co32, _, _, inv_di, kw32 = vep3d_case(case, torch.float32, cuda)
    c64, co64, _, _, _, kw64 = vep3d_case(case, torch.float64, cuda)
    out = fused_chunk(c32, co32, inv_di, kw32, 50)
    ref = fused_chunk(c32, co32, inv_di, kw32, 50, plain=True)
    ref64 = fused_chunk(c64, co64, inv_di, kw64, 50, plain=True)
    gap = max(rel_diffs_vep3d(out, ref).values())
    p32 = max(rel_diffs_vep3d(as_f64(ref), ref64).values())
    assert gap <= max(TOL_F32_1024, 2.0 * p32), (case, gap, p32)


@pytest.mark.parametrize("ni", [(5, 4, 3), (3, 7, 4), (4, 3, 9)])
def test_vep3d_chunk_random_carries_noncubic(cuda, ni):
    """Random canvases everywhere, the ghost and padding slots included, on
    small non-cubic grids with unequal spacings, near yield with dilatancy,
    a tension cap, buoyancy and a power-law creep table: B8 against the plain
    chunk for 0 to 3 iterations (both work sets of the kernel), f64, so that
    a swapped axis, a clamp off by one or a ghost the mirrors miss shows."""
    gen = torch.Generator(device="cpu").manual_seed(7 * sum(ni))
    nx, ny, nz = ni
    canvas = (nx + 2, ny + 2, nz + 2)

    def rand(shape=canvas, scale=0.3):
        return (scale * torch.randn(shape, generator=gen, dtype=torch.float64)).to(cuda)

    common = dict(Kb=6.0, is_plastic=1.0, C=0.35, friction_angle=30.0, dilation_angle=10.0,
                  eta_reg=1e-2, tension_pT=-0.6, alpha=0.1, T0=0.5, beta=0.01,
                  gravity=1.0, disl_A=0.5, disl_n=3.0)
    mat = pm.MaterialStack.make([pm.Material(G=1.0, eta0=1.0, rho0=1.0, **common),
                                 pm.Material(G=0.6, eta0=0.2, rho0=2.0, **common)],
                                dtype=torch.float64, device=cuda)
    pr = phase_ratios_from_field((torch.rand(ni, generator=gen) < 0.4).long().to(cuda), 2)
    z = torch.zeros(ni, dtype=torch.float64, device=cuda)
    co = vep3d_canvas_consts(
        mat, tuple(rand(ni) for _ in range(6)),
        (rand((nx, ny + 1, nz + 1)), rand((nx + 1, ny, nz + 1)), rand((nx + 1, ny + 1, nz))),
        z, rand(ni, scale=0.15), z, pr.center, (pr.edge_yz, pr.edge_xz, pr.edge_xy),
        T=0.5 + rand(ni, scale=0.1), hoist_tau_o=False, scalar_plastic=True, scalar_K=True)
    carry = VEP3DCanvasCarry(
        V=(rand(scale=1.0), rand(scale=1.0), rand(scale=1.0)), P=rand(scale=0.2),
        theta=rand(scale=0.2), tau_c=tuple(rand() for _ in range(6)),
        tau_e=tuple(rand() for _ in range(3)), eta=rand().exp(), lam=rand(scale=0.05).abs(),
        lam_e=tuple(rand(scale=0.05).abs() for _ in range(3)))
    kw = dict(dt=0.2, r=0.6, theta_dtau=0.7, etadtau=0.05, lambda_relaxation=0.2,
              viscosity_relaxation=0.3, viscosity_cutoff=(0.2, 5.0))
    inv_di = (1.0 / 0.3, 1.0 / 0.2, 1.0 / 0.45)
    hc.stokes3d_vep_chunk.launches = 0
    assert hc.stokes3d_vep_chunk(carry, co, inv_di, 0, **kw) is carry
    for nit in (1, 2, 3):
        out = fused_chunk(carry, co, inv_di, kw, nit)
        ref = fused_chunk(carry, co, inv_di, kw, nit, plain=True)
        worst = max(rel_diffs_vep3d(out, ref).values())
        assert worst <= TOL_VEP3D_CALL, (ni, nit, worst)
    assert hc.stokes3d_vep_chunk.launches == 3 * (1 + 2 + 3)


def test_vep3d_chunk_rejects_bad_inputs(cuda):
    carry, co, _, _, inv_di, kw = vep3d_case("blocked_plastic", torch.float64, cuda)
    bad_dtype = carry._replace(P=carry.P.float())
    bad_layout = carry._replace(P=carry.P.transpose(0, 2).contiguous().transpose(0, 2))
    bad_shape = carry._replace(P=carry.P[:-1].contiguous())
    for bad in (bad_dtype, bad_layout, bad_shape):
        with pytest.raises(ValueError):
            hc.stokes3d_vep_chunk(bad, co, inv_di, 1, **kw)
    with pytest.raises(ValueError):   # plastic parameters as canvases
        hc.stokes3d_vep_chunk(carry, co._replace(params=co.params._replace(
            ppc=type(co.params.ppc)(*(torch.full_like(carry.P, float(v))
                                      for v in co.params.ppc)))), inv_di, 1, **kw)


RAGGED = [(2, 2), (3, 5), (33, 31), (70, 45)]


def _vep_against_plain(args, kw, nouts=((1, TOL_NOUT1), (50, TOL_NOUT50))):
    before = [t.clone() for t in args[:12]]
    for nout, tol in nouts:
        out = hv.stokes_vep_chunk(*args, nout=nout, **kw)
        ref = hv.stokes_vep_chunk_reference(*args, nout=nout, **kw)
        worst = max(rel_diffs(out, ref).values())
        assert worst <= tol, (nout, worst, rel_diffs(out, ref))
    assert all(torch.equal(a, b) for a, b in zip(before, args[:12]))  # input not written


@pytest.mark.parametrize("vary", [True, False])
@pytest.mark.parametrize("ni", RAGGED)
def test_vep_kernel_ragged_tiles_f64(cuda, ni, vary):
    """Grids that the tiles do not divide, from a random state with ghosts;
    ``vary``: every slot family varies (a tension cap among them), or nearly
    every slot is a scalar."""
    modes = ("free_slip", "no_slip", "no_slip", "free_slip")
    args, kw = vep_random_case(ni, modes, torch.float64, cuda, vary=vary, seed=ni[0])
    _vep_against_plain(args, kw)


@pytest.mark.parametrize("vary", [True, False])
@pytest.mark.parametrize("ni", RAGGED)
def test_vep_kernel_ragged_tiles_f32(cuda, ni, vary):
    modes = ("no_slip", "free_slip", "free_slip", "no_slip")
    args, kw = vep_random_case(ni, modes, torch.float32, cuda, vary=vary, seed=ni[1])
    for nout in (1, 50):
        _, gap, _, p_vs_64, _ = f32_gaps(
            hv.stokes_vep_chunk, hv.stokes_vep_chunk_reference, rel_diffs, args, kw, nout)
        assert gap <= max(TOL_F32_1024, 2.0 * p_vs_64), (ni, nout, gap, p_vs_64)


@pytest.mark.parametrize("modes", FACE_MODES, ids=["-".join(m[:2] for m in ms)
                                                   for ms in FACE_MODES])
def test_vep_kernel_every_face_combination(cuda, modes):
    """Each of the 16 free-slip/no-slip face combinations from a random
    start, ghosts and corners included, on a grid of several ragged tiles."""
    args, kw = vep_random_case((21, 70), modes, torch.float64, cuda, seed=5)
    _vep_against_plain(args, kw, ((1, TOL_NOUT1), (20, TOL_NOUT50)))


@pytest.mark.parametrize("vary", [True, False])
@pytest.mark.parametrize("ni", RAGGED)
def test_ve_kernel_ragged_tiles(cuda, ni, vary):
    """Ragged grids from a random state with ghosts, with and without the
    free-slip ghosts; ``vary``: every slot varies and η_τ is read, or every
    slot is a scalar or derived from η."""
    args, kw = ve_random_case(ni, torch.float64, cuda, vary=vary, seed=ni[0])
    before = [t.clone() for t in args[:6]]
    for free_slip in (True, False):
        for nout, tol in ((1, TOL_VE_NOUT1), (100, 1e-10)):
            out = hs.stokes_chunk(*args, nout=nout, free_slip=free_slip, **kw)
            ref = hs.stokes_chunk_reference(*args, nout=nout, free_slip=free_slip, **kw)
            worst = max(rel_diffs_ve(out, ref).values())
            assert worst <= tol, (free_slip, nout, worst)
    assert all(torch.equal(a, b) for a, b in zip(before, args[:6]))
    for nout in (1, 100):
        a32 = tuple(a.float() if torch.is_tensor(a) else a for a in args)
        k32 = {k: (tuple(x.float() for x in v) if isinstance(v, tuple) else
                   v.float() if torch.is_tensor(v) else v) for k, v in kw.items()}
        _, gap, _, p_vs_64, _ = f32_gaps(
            hs.stokes_chunk, hs.stokes_chunk_reference, rel_diffs_ve, a32, k32, nout)
        assert gap <= max(TOL_F32_1024, 2.0 * p_vs_64), (ni, nout, gap, p_vs_64)


@pytest.mark.parametrize("mode", hw.MODES)
def test_window_copy_matches_plain(cuda, mode):
    src = torch.as_tensor(np.random.default_rng(3).standard_normal((4, 64, 64, 128)),
                          dtype=torch.float32, device=cuda)
    before = hw.window_copy.launches
    out = hw.window_copy(src, mode)
    assert hw.window_copy.launches == before + 1
    assert torch.equal(out, hw.window_copy_reference(src, mode))
    small = src[:2, :24, :30, :8].contiguous()
    params = dict(W=12, Wy=10, R=8, Ry=6)
    assert torch.equal(hw.window_copy(small, mode, **params),
                       hw.window_copy_reference(small, mode, **params))
    # two TMA boxes along z; a 16-byte inner box
    for shape, params in (((1, 128, 64, 512), dict(W=64, Wy=40, R=32, Ry=16)),
                          ((3, 20, 24, 4), dict(W=10, Wy=9, R=5, Ry=6))):
        s = torch.as_tensor(np.random.default_rng(4).standard_normal(shape),
                            dtype=torch.float32, device=cuda)
        assert torch.equal(hw.window_copy(s, mode, **params),
                           hw.window_copy_reference(s, mode, **params))


def test_window_copy_rejects_bad_inputs(cuda):
    src = torch.zeros((4, 64, 64, 128), device=cuda)
    misaligned = torch.zeros(src.numel() + 1, device=cuda)[1:].view(src.shape)
    for bad in (src.double(), src.transpose(1, 2), src[..., :126], misaligned):
        with pytest.raises(ValueError):
            hw.window_copy(bad)


def test_window_copy_script_on_the_card(cuda, capsys):
    from justrelax_tpu_torch.scripts import repro_2d_dma

    out = repro_2d_dma.main(["2d"])
    text = capsys.readouterr().out.splitlines()
    assert text[-1] == "PASS" and all("finite=True" in ln for ln in text[1:4])
    # the card divides arange by 1e6 through a reciprocal, so the input, and
    # with it the sum, differs from the CPU's 128244.781 in the last bits
    assert abs(float(out.sum()) - 128244.781) <= 0.05


@pytest.mark.parametrize("linear", [True, False])
def test_dyrel_graph_replay_matches_eager_chunk(cuda, linear):
    """A DYREL chunk's graph replay is bit-equal to the chunk run eagerly
    from the same mid-solve state, with and without the viscosity
    refresh."""
    from chip_smoke import DYREL_CARRIED, dyrel_chunks, dyrel_nonlinear_setup
    from justrelax_tpu_torch.models import shearband_dyrel
    from justrelax_tpu_torch.solvers.dyrel import solve_dyrel

    with dyrel_chunks() as rec:
        if linear:
            shearband_dyrel.run(n=24, nt=1, dtype=torch.float64, iter_max=200,
                                total_iter_max=200)
        else:
            st, geometry, bc, mat, prc, prv, _, kw = dyrel_nonlinear_setup(24, torch.float64,
                                                                           cuda)
            solve_dyrel(st, geometry, bc, mat, prc, prv, 0.25,
                        **dict(kw, iter_max=200, total_iter_max=200))
    s = rec["solves"][-1]
    nout = rec["replays"][-1][2]
    fields = [getattr(s, k) for k in DYREL_CARRIED]
    saved = [t.clone() for t in fields]
    s.chunk(nout)
    eager = [t.clone() for t in fields]
    for t, v in zip(fields, saved):
        t.copy_(v)
    s.replay()
    torch.cuda.synchronize()
    for k, a, b in zip(DYREL_CARRIED, fields, eager):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("ndim,n,mx", [(2, 16, 8), (3, 6, 8)])
def test_particle_ops_card_match_cpu(cuda, ndim, n, mx):
    """Every particle operation on the card against the CPU from the same
    numpy inputs (phase 34 at a small size): selections, gathers and
    elementwise arithmetic bit for bit, the sums and scatter-adds within
    PARTICLE_TOL of each field's max; the x-slab move equals the whole-grid
    move on the card."""
    from chip_smoke import PARTICLE_BIT_EQUAL, PARTICLE_TOL, particle_diffs, particle_ops, \
        particles_numpy

    case = particles_numpy(ndim, n, mx)
    card, cpu = particle_ops(case, cuda), particle_ops(case, torch.device("cpu"))
    for name, (eq, rel) in particle_diffs(card, cpu).items():
        if name in PARTICLE_BIT_EQUAL:
            assert eq, name
        else:
            assert rel <= PARTICLE_TOL, (name, rel)
    assert all(torch.equal(a, b) for a, b in zip(card["move"], card["move_slab"]))
    assert card["starved"] > 0 and card["min_count"] >= case["min_xcell"]


def test_particle_models_route_on_the_card(cuda):
    """The particle models' solves take their routes on the card with
    use_kernel left to its default: Van Keken's Stokes solve through B2/B3,
    the rising blob's through B7, the layered model's thermal solve through
    B5 (its Stokes solve is plain by contract)."""
    from chip_smoke import counts, reset_counts
    from justrelax_tpu_torch.models import layered_convection_nondim, rising_blob3d, vankeken

    runs = {
        "stokes_vep_chunk": lambda: vankeken.run(nx=16, ny=16, nt=1, nxcell=8, max_xcell=16,
                                                 min_xcell=4),
        "stokes3d_chunk": lambda: rising_blob3d.run(n=8, nt=1),
        "thermal_chunk": lambda: layered_convection_nondim.run(nx=8, ny=8, nt=1, nxcell=4,
                                                               max_xcell=8, min_xcell=2),
    }
    for kernel, run in runs.items():
        reset_counts()
        run()
        c = counts()
        assert c.pop(kernel) > 0, kernel
        assert sum(c.values()) == 0, (kernel, c)


@pytest.mark.slow
def test_layered_convection3d_golden_f64(cuda):
    """tests/test_layered_convection3d.py's golden on the card through the
    default entry point (12³, 2 steps; plain by contract, no kernel
    launched): phase 33's case, moved here for its time (the serial 3D VEP
    iteration's host dispatch, 6–8 min on an H100)."""
    from chip_smoke import golden_result, particle_golden_cases

    run, checks = particle_golden_cases()["layered_convection3d"]
    g = golden_result("layered_convection3d", run)
    for key, ok in checks(g):
        assert ok, (key, g)
    assert g["other_launches"] == 0


@pytest.mark.slow
@pytest.mark.parametrize("label", VARIATIONAL_MOVED)
def test_variational_golden_f64(cuda, label):
    """Phase 36's goldens that run here for their time (chip_smoke.py's
    VARIATIONAL_MOVED: the 3D subduction at 48×8×16 and the plume at 32²,
    whose masked 3D VEP and plain VEP solves dispatch each iteration's
    operations from the host; the 2D subduction at 64×24, whose solves run
    to their 80 000 cap; Crameri's relaxation at 32², 130 000 graphed
    iterations), on the card through the default entry points, on the JAX
    tests' assertions; no kernel of the port launched."""
    from chip_smoke import golden_result, variational_golden_cases

    run, checks = variational_golden_cases()[label]
    g = golden_result(label, run)
    for key, ok in checks(g):
        assert ok, (key, g)
    assert g["other_launches"] == 0


@pytest.mark.parametrize("label", ["vep", "vep3d"])
def test_nonuniform_card_matches_cpu(cuda, label):
    """A 2D and a 3D solve on a tanh-stretched grid (chip_smoke.py's phase
    39 set-ups, f64, a fixed count of iterations): the card against the
    CPU, equal iterations, fields within 1e-12 of their max; no kernel of
    the port launched."""
    from chip_smoke import (
        NONUNIFORM_CARD_VS_CPU,
        counts,
        nonuniform_field_diffs,
        nonuniform_solve,
        reset_counts,
    )

    reset_counts()
    sc, ic, res_scale = nonuniform_solve(label, cuda)
    assert sum(counts().values()) == 0
    sh, ih, _ = nonuniform_solve(label, torch.device("cpu"))
    assert int(ic.iters) == int(ih.iters)
    worst = nonuniform_field_diffs(sc, sh, res_scale)
    assert max(worst.values()) <= NONUNIFORM_CARD_VS_CPU, worst


def test_nonuniform_kernel_refusals(cuda):
    """Every kernel route asked for on a stretched grid (the default on the
    card among them) raises ValueError naming use_kernel=False."""
    from chip_smoke import stretched_refusals

    for key, msg in stretched_refusals(cuda).items():
        assert msg is not None and "use_kernel=False" in msg, (key, msg)


@pytest.mark.slow
def test_shearband_refined_golden_f64(cuda):
    """tests/test_shearband_refined.py's golden (n=32, nt=10) on the card
    through the model's entry point (plain by contract): phase 39's case,
    moved here for its time (~10^5 plain iterations, each the host's
    dispatch); no kernel of the port launched."""
    from chip_smoke import golden_result, nonuniform_golden_cases

    run, checks = nonuniform_golden_cases()["shearband_refined"]
    g = golden_result("shearband_refined", run)
    for key, ok in checks(g):
        assert ok, (key, g)
    assert g["other_launches"] == 0


def test_checkpoint_roundtrip_on_the_card(cuda, tmp_path):
    """A 64² f32 state of seeded fields written from the card and read back
    into fresh states on the card and on the CPU: every field bit-equal, in
    its dtype, on the template's device; the particle loader's default
    device is the card."""
    from chip_smoke import flat_state
    from justrelax_tpu_torch.core.state import StokesState
    from justrelax_tpu_torch.io.checkpoint import (
        checkpointing,
        checkpointing_particles,
        load_checkpoint,
        load_checkpoint_particles,
    )
    from justrelax_tpu_torch.particles.particles import init_particles

    gen = torch.Generator(device=cuda).manual_seed(0)
    st = StokesState.make((64, 64), dtype=torch.float32, device=cuda)
    for _, a, _ in flat_state(st, st):
        a.copy_(torch.randn(a.shape, generator=gen, device=cuda))
    path = checkpointing(str(tmp_path), st, None, 1.0, 0.5)
    for dev in (cuda, torch.device("cpu")):
        back, _, t, dt = load_checkpoint(path, StokesState.make((64, 64), device=dev))
        assert (t, dt) == (1.0, 0.5)
        for name, a, b in flat_state(st, back):
            assert b.dtype == torch.float32 and b.device.type == dev.type, name
            assert torch.equal(a.cpu(), b.cpu()), name
    particles = init_particles(Geometry((8, 8), (1.0, 1.0)), 4, 8, 2, device=cuda)
    p_path = checkpointing_particles(str(tmp_path), particles, {"T": particles.px * 2.0})
    back, fields, *_ = load_checkpoint_particles(p_path)
    assert back.px.device.type == "cuda" and torch.equal(back.px, particles.px)
    assert torch.equal(back.active, particles.active)
    assert torch.equal(fields["T"], particles.px * 2.0)


def test_ve_restart_through_b1(cuda, tmp_path):
    """Phase 41 (a): tests/test_restart_equivalence.py's VE loop on the card
    through B1/B4, checkpointed after 2 of 4 steps and restarted, bit for
    bit equal to the straight run."""
    from chip_smoke import bit_equal, counts, flat_state, reset_counts, ve_restart

    reset_counts()
    straight, restarted, it_a, it_b, _, _ = ve_restart(cuda, str(tmp_path))
    assert counts()["stokes_chunk"] > 0
    assert it_a == it_b
    for name, a, b in flat_state(straight, restarted):
        assert bit_equal(a, b), name


def test_ve_restart_setup_f32_on_the_card(cuda):
    """tests/test_restart_equivalence.py::test_f32_ve_solver_behavior with
    its 20 000-iteration steps, through B1/B4: the residual below 5e-4 and
    τyy on the analytic Maxwell curve within 1 % after 5 steps."""
    from chip_smoke import VE_RESTART_DT, ve_restart_setup, ve_restart_step
    from justrelax_tpu_torch.models.elastic_buildup import analytic_solution

    stokes, pt, *problem, (eta0, G, eps_bg) = ve_restart_setup(torch.float32, cuda)
    pt = dataclasses.replace(pt, eps_abs=1.0e-5, eps_rel=1.0e-5)
    for _ in range(5):
        stokes, info = ve_restart_step(stokes, pt, *problem)
    assert float(info.err) < 5.0e-4
    want = analytic_solution(eps_bg, 5 * VE_RESTART_DT, G, eta0)
    assert abs(float(stokes.tau.yy.abs().max()) - want) / want < 1.0e-2


def test_profiling_on_the_card(cuda, tmp_path):
    """utils/profiling.py on the card: ``trace`` records the card's kernels,
    ``timed`` waits for the card's queued work, ``report_env`` names it."""
    import json

    from justrelax_tpu_torch.utils import profiling

    a = torch.ones(2048, 2048, device=cuda)
    with profiling.trace(str(tmp_path)):
        (a @ a).sum()
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)
    out = {}
    with profiling.timed(out):
        torch.cuda._sleep(int(2e8))  # ~0.1 s of the card's time
    assert out["wall_s"] > 0.05
    assert profiling.report_env()["devices"] == torch.cuda.get_device_name(0)


@pytest.mark.slow
def test_run_particles_restart_golden_f64(cuda, tmp_path):
    """tests/test_subduction2d.py's restart equivalence on the card at
    48×16 over 4 steps with the model's 80 000-iteration caps: a 2-step run
    checkpointing at step 2, a restart from it to step 4, held to a straight
    4-step run within PARTICLES_RESTART_TOL (the phase ratios sum with
    index_add_'s atomics on the card), and the JAX test's frozen slab
    descent rates."""
    import os

    from chip_smoke import PARTICLES_RESTART, PARTICLES_RESTART_TOL, particles_run_diffs
    from justrelax_tpu_torch.io.checkpoint import load_checkpoint_particles
    from justrelax_tpu_torch.models import subduction2d

    d_full, d_restart = str(tmp_path / "full"), str(tmp_path / "restart")
    s2, _, _, _, info2 = subduction2d.run_particles(**PARTICLES_RESTART, nt=2, out_dir=d_full,
                                                    checkpoint_every=2)
    assert float(info2.err) < 1.0e-4
    restarted = subduction2d.run_particles(**PARTICLES_RESTART, nt=4, out_dir=d_restart,
                                           checkpoint_every=2, restart_from=d_full)
    s4, _, p4, (_, pT4), info4 = restarted
    assert float(info4.err) < 1.0e-4
    pr, pf, _, _, it4 = load_checkpoint_particles(os.path.join(d_restart, "particles.npz"))
    assert it4 == 4 and torch.equal(pr.px, p4.px) and torch.equal(pf["T"], pT4)
    straight = subduction2d.run_particles(**PARTICLES_RESTART, nt=4)
    diffs = particles_run_diffs(straight, restarted)
    assert max(diffs.values()) <= PARTICLES_RESTART_TOL, diffs
    yr = 3.15576e7
    assert float(s2.V.Vy.min()) * 100 * yr == pytest.approx(-4.1227, rel=2e-2)
    assert float(s4.V.Vy.min()) * 100 * yr == pytest.approx(-5.6428, rel=2e-2)


@pytest.mark.slow
@pytest.mark.parametrize("label", GOLDENS_MOVED)
def test_model_golden_f64(cuda, label):
    """Phase 28's goldens that run here for their time (chip_smoke.py's
    GOLDENS_MOVED: the thermal stresses at 48², shear heating at 32² and the
    visc_plastic_tau shear band at 32², 220–300 s each of the host's
    dispatch of plain PyTorch iterations on an H100), through the default
    entry points on the JAX tests' assertions, with the launches of the
    kernel each routes through (> 0) and of no other."""
    from chip_smoke import MODEL_KERNEL, golden_cases, golden_result

    run, checks = golden_cases()[label]
    g = golden_result(label, run)
    for key, ok in checks(g):
        assert ok, (key, g)
    if MODEL_KERNEL[label] is not None:
        assert g["launches"] > 0
    assert g["other_launches"] == 0


# ---- the distributed layer (parallel/) on the card: phase 42 at the CPU
# tests' sizes
@pytest.mark.parametrize("label", ["ve_full_terms", "thermal3d_xy", "vep_2x2", "variational"])
def test_distributed_world_of_one_nccl(cuda, label):
    """A world of one on NCCL in this process: the sharded solve on the
    card, its serial plain solve on the card, equal iterations, fields
    within 1e-12 of their max (chip_smoke.py phase 42 a)."""
    import dist_cases as dc
    from justrelax_tpu_torch.parallel import launch, multihost
    from justrelax_tpu_torch.parallel.mesh import make_grid_mesh

    case = dc.suite_cases("test")[label]
    one = dataclasses.replace(case, mesh=(1,) * len(case.mesh))
    multihost.initialize(f"127.0.0.1:{launch.free_port()}", 1, 0, backend="nccl", device=cuda,
                         timeout=120)
    try:
        assert torch.distributed.get_backend() == "nccl"
        got = dc.sharded_solve(one, make_grid_mesh(one.mesh, device=cuda))
    finally:
        multihost.shutdown()
    worst, tol, iters_ok, err_ok = dc.case_gate(one, got, dc.serial_solve(case, cuda))
    assert iters_ok and err_ok and worst <= tol, (label, worst)


def test_distributed_gloo_four_on_the_card(cuda):
    """Four ranks on the one card over gloo, each halo slab staged through
    host memory: the VE cases against the serial solve on the card, and
    ``overlap=True`` bit-equal to ``overlap=False`` (phase 42 b)."""
    import dist_cases as dc

    got = dc.world("ve", device="cuda", backend="gloo", timeout=300).result()
    assert not any(got["launches"].values()), got["launches"]
    for label, case in dc.suite_cases("test").items():
        if case.kind != "ve":
            continue
        worst, tol, iters_ok, err_ok = dc.case_gate(case, got[label],
                                                    dc.serial_solve(case, cuda))
        assert iters_ok and err_ok and worst <= tol, (label, worst)
    for setup in ("ve_solcx", "ve_full_terms"):
        for k in dc.VE_FIELDS:
            assert np.array_equal(got[setup][k], got[setup + "_no_overlap"][k])


NEW_KINDS = ("ve3d", "vep3d", "dyrel", "particles", "particles3d")


@pytest.mark.parametrize("label", ["ve3d_free_slip_xy", "ve3d_no_slip_xy", "vep3d_xy",
                                   "dyrel_2x2", "particles_2x2", "particles3d_xy"])
def test_distributed_world_of_one_nccl_new_kinds(cuda, label):
    """The 3D VE and VEP, DYREL and particle cases on a world of one on
    NCCL in this process, against their serial plain solves on the card,
    each with its gate (``dist_cases.case_gate``; phase 42 a)."""
    import dist_cases as dc
    from justrelax_tpu_torch.parallel import launch, multihost
    from justrelax_tpu_torch.parallel.mesh import make_grid_mesh

    case = dc.suite_cases("test")[label]
    one = dataclasses.replace(case, mesh=(1,) * len(case.mesh))
    multihost.initialize(f"127.0.0.1:{launch.free_port()}", 1, 0, backend="nccl", device=cuda,
                         timeout=120)
    try:
        got = dc.sharded_solve(one, make_grid_mesh(one.mesh, device=cuda))
    finally:
        multihost.shutdown()
    worst, tol, iters_ok, err_ok = dc.case_gate(one, got, dc.serial_solve(case, cuda))
    assert iters_ok and err_ok and worst <= tol, (label, worst, tol)


@pytest.mark.parametrize("suite", NEW_KINDS)
def test_distributed_gloo_four_on_the_card_new_kinds(cuda, suite):
    """Four ranks on the one card over gloo, each batch staged through host
    memory: every case of the kind against its serial solve on the card
    (phase 42 b); no kernel launched."""
    import dist_cases as dc

    got = dc.world(suite, device="cuda", backend="gloo", timeout=600).result()
    assert not any(got["launches"].values()), got["launches"]
    refs = {}
    for label, case in dc.suite_cases("test").items():
        if case.kind != suite:
            continue
        key = dc.setup_key(case)
        refs.setdefault(key, dc.serial_solve(case, cuda))
        worst, tol, iters_ok, err_ok = dc.case_gate(case, got[label], refs[key])
        assert iters_ok and err_ok and worst <= tol, (label, worst, tol)


def test_dyrel_without_a_hook_replays_its_graphs(cuda):
    """With no halo hook ``solve_dyrel`` on the card captures its chunk once
    and replays it, as before the hook existed, and its 16² solve matches
    the CPU's within phase 31's limits with equal iterations."""
    import dist_cases as dc
    from chip_smoke import DYREL_CARD_VS_CPU_LIMITS, dyrel_chunks, dyrel_field_diffs
    from justrelax_tpu_torch.core.grid import Geometry
    from justrelax_tpu_torch.ops.bc import VelocityBoundaryConditions
    from justrelax_tpu_torch.solvers.dyrel import solve_dyrel

    d = dc.dyrel_inputs(16)

    def run(dev):
        f = dict(dtype=torch.float64, device=dev)
        return solve_dyrel(dc.dyrel_state(d, dev, torch.float64), Geometry((16, 16), (1.0, 1.0)),
                           VelocityBoundaryConditions(**dc.FREE_SLIP),
                           dc.dyrel_material(dev, torch.float64),
                           torch.as_tensor(d["pr_c"], **f), torch.as_tensor(d["pr_v"], **f),
                           d["dt"], **dc.DYREL_KW)

    with dyrel_chunks() as rec:
        sc, ic = run(cuda)
    assert len(rec["solves"]) == 1 and len(rec["replays"]) == ic.iters // dc.DYREL_KW["nout"]
    sh, ih = run(torch.device("cpu"))
    assert ic.iters == ih.iters
    worst = dyrel_field_diffs(sc, sh)
    over = {k: v for k, v in worst.items() if v > DYREL_CARD_VS_CPU_LIMITS.get(k, 1e-10)}
    assert not over, over


def test_dyrel_hooked_chunk_runs_eagerly_on_the_card(cuda):
    """A hooked solve's chunk runs eagerly on the card: no graph is
    captured, and asking for one raises."""
    import dist_cases as dc
    from justrelax_tpu_torch.core.grid import Geometry
    from justrelax_tpu_torch.ops.bc import VelocityBoundaryConditions
    from justrelax_tpu_torch.parallel.dyrel import DyrelWindow
    from justrelax_tpu_torch.parallel.mesh import make_grid_mesh
    from justrelax_tpu_torch.solvers import dyrel

    d = dc.dyrel_inputs(8)
    f = dict(dtype=torch.float64, device=cuda)
    win = DyrelWindow(make_grid_mesh((1, 1), device=cuda), (8, 8))
    s = dyrel._DyrelSolve(dc.dyrel_state(d, cuda, torch.float64), Geometry((8, 8), (1.0, 1.0)),
                          VelocityBoundaryConditions(**dc.FREE_SLIP),
                          dc.dyrel_material(cuda, torch.float64), torch.as_tensor(d["pr_c"], **f),
                          torch.as_tensor(d["pr_v"], **f), d["dt"], None, 20.0, 1.0, True, 1e-2,
                          (-math.inf, math.inf), None, None, halo=win)
    s.set_P(s.P0)
    s.set_tuning(torch.tensor(0.0, **f), 0.99)
    s.run_chunk(3)
    assert s.graphs is None and bool(torch.isfinite(s.Vx).all())
    with pytest.raises(RuntimeError, match="eagerly"):
        s.capture(3)


def test_nccl_refuses_two_ranks_on_one_card(cuda):
    """NCCL asked for by two ranks on one card fails the world; it never
    turns into gloo."""
    from chip_smoke import nccl_two_ranks_one_card

    if torch.cuda.device_count() > 1:
        pytest.skip("two cards: NCCL may serve two ranks")
    msg = nccl_two_ranks_one_card()
    assert msg is not None and "NCCL" in msg.upper(), msg
