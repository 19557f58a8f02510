"""The Hopper chunk kernels on the card: each kernel against its plain
PyTorch version, and the solves through them. These tests need a CUDA device
and an nvcc toolchain; elsewhere they skip. Run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: the suite's conftest configures JAX, which a machine with
the card need not have.)
"""

import itertools
import math

import numpy as np
import pytest
import torch

from chip_smoke import (
    TH_CASES,
    TOL_F32_1024,
    TOL_NOUT1,
    TOL_NOUT50,
    TOL_TH_NOUT1,
    TOL_VE3D_NOUT1,
    TOL_VE3D_NOUT200,
    TOL_VE_NOUT1,
    VE3D_CASES,
    VE_CASES,
    chunk_case,
    f32_gaps,
    pallas_thermal_setup,
    rel_diffs,
    rel_diffs_th,
    rel_diffs_ve,
    rel_diffs_ve3d,
    thermal_case,
    ve3d_case,
    ve_case,
)
from justrelax_tpu_torch.core.coeffs import PTThermalCoeffs
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.core.state import ThermalState
from justrelax_tpu_torch.models import shearband, solcx, solvi3d
from justrelax_tpu_torch.ops import hopper_stokes as hs
from justrelax_tpu_torch.ops import hopper_stokes3d as h3
from justrelax_tpu_torch.ops import hopper_stokes_vep as hv
from justrelax_tpu_torch.ops import hopper_thermal as ht
from justrelax_tpu_torch.ops.bc import Faces, TemperatureBoundaryConditions, thermal_bcs
from justrelax_tpu_torch.ops.stokes3d_canvas import ve3d_canvas_coefficients
from justrelax_tpu_torch.rheology import materials as pm
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
