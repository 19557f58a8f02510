"""The Hopper VEP chunk kernel on the card: kernel against its plain PyTorch
version, and the flagship solve through it. These tests need a CUDA device
and an nvcc toolchain; elsewhere they skip. Run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: the suite's conftest configures JAX, which a machine with
the card need not have.)
"""

import math

import pytest
import torch

from chip_smoke import TOL_F32_1024, TOL_NOUT1, TOL_NOUT50, chunk_case, f32_gaps, rel_diffs
from justrelax_tpu_torch.models import shearband
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
        _, gap, _, p_vs_64, _ = f32_gaps(args, kw, nout)
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
