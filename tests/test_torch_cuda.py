"""The Hopper chunk kernels on the card: each kernel against its plain
PyTorch version, and the solves through them. These tests need a CUDA device
and an nvcc toolchain; elsewhere they skip. Run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: the suite's conftest configures JAX, which a machine with
the card need not have.)
"""

import math

import pytest
import torch

from chip_smoke import (
    TOL_F32_1024,
    TOL_NOUT1,
    TOL_NOUT50,
    TOL_VE_NOUT1,
    VE_CASES,
    chunk_case,
    f32_gaps,
    rel_diffs,
    rel_diffs_ve,
    ve_case,
)
from justrelax_tpu_torch.models import shearband, solcx
from justrelax_tpu_torch.ops import hopper_stokes as hs
from justrelax_tpu_torch.ops import hopper_stokes_vep as hv

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
