"""The tiled 2D chunk kernels' CUDA sources run on the CPU under a host
emulation (``tests/cuda_emu.h``: a block's threads as std::threads meeting at
a barrier, shared memory starting as NaN), built with the host's C++
compiler, against their plain PyTorch versions:

- ``csrc/stokes_vep.cu`` (B2/B3): the four configurations of
  ``chip_smoke.chunk_case``, ragged grids from random states with ghosts
  (every slot family varying, or nearly every slot a scalar), and every one
  of the 16 free-slip/no-slip face combinations;
- ``csrc/stokes_ve.cu`` (B1/B4): the three configurations of
  ``chip_smoke.ve_case`` and ragged random states, with and without the
  free-slip ghosts;
- ``csrc/window_copy.cu`` (R): the three modes, with ``cp.async`` as a copy.

Each call goes through the wrapper's own ``_launch`` (argument checks, slot
packing, work sets). This checks the kernels' index arithmetic, halos, tile
ownership, ghost rules and operation order; the compiler and the card are
checked by ``tests/test_torch_cuda.py`` on the card. The host's arithmetic
is IEEE as the card's, without the card's FMA contractions, so f64 is held
to 1e-13 here. Skips where no C++20 compiler exists.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import (
    FACE_MODES,
    chunk_case,
    rel_diffs,
    rel_diffs_ve,
    ve_case,
    ve_random_case,
    vep_random_case,
)
from justrelax_tpu_torch.ops import hopper_stokes as hs
from justrelax_tpu_torch.ops import hopper_stokes_vep as hv
from justrelax_tpu_torch.ops import hopper_window_copy as hw

torch.set_num_threads(1)

HERE = Path(__file__).resolve().parent
TOL = {torch.float64: 1e-13, torch.float32: 1e-5}
RAGGED = [(2, 2), (3, 5), (33, 31), (17, 70)]


def _emulated(source: Path, out: Path, bind):
    """Build ``source`` against the emulation header and bind it."""
    text = source.read_text().replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
    text = re.sub(r"extern __shared__ __align__\(16\) (\w+ ?\w*) (\w+)\[\];",
                  r"\1* \2 = reinterpret_cast<\1*>(emu_smem);", text)
    text = re.sub(r"(\w+)<<<([^>]*)>>>\(", r"emu_launch(\1, \2, ", text)
    # cp.async: a plain copy; commit and wait have nothing to do
    for name, body in (("cp_async16", "std::memcpy(smem, gmem, 16);"),
                       ("cp_async_elem", "*smem = *gmem;"),
                       ("cp_async_commit", ""), ("cp_async_wait_all", "")):
        text = re.sub(r"__device__ __forceinline__ void " + name + r"\((.*?)\) \{.*?\n\}",
                      "inline void " + name + r"(\1) { " + body + " }", text, flags=re.S)
    assert "asm volatile" not in text
    cpp = out.with_suffix(".cpp")
    cpp.write_text(text)
    cxx = shutil.which("g++") or shutil.which("c++")
    proc = subprocess.run([cxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
                           "-I", str(HERE), "-o", str(out), str(cpp)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return bind(ctypes.CDLL(str(out)))


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if not (shutil.which("g++") or shutil.which("c++")):
        pytest.skip("needs a C++20 compiler on the host")
    d = tmp_path_factory.mktemp("emulated")
    return {mod: _emulated(mod.SOURCE, d / f"lib{mod.SOURCE.stem}.so", mod._bind)
            for mod in (hv, hs, hw)}


def _vep(libs, args, kw, nout):
    before = [t.clone() for t in args[:12]]
    out = hv._launch(libs[hv], None, args, nout, None, kw.get("flow_bc"), kw.get("T_v"),
                     "auto")
    assert all(torch.equal(a, b) for a, b in zip(before, args[:12]))  # input not written
    return out


@pytest.mark.parametrize("case", ["shearband", "dpcap", "powerlaw_noslip", "buoyancy"])
def test_vep_kernel_parity_cases(libs, case):
    args, kw = chunk_case(case, 37, torch.float64, "cpu")
    for nout in (1, 3):
        out = _vep(libs, args, kw, nout)
        ref = hv.stokes_vep_chunk_reference(*args, nout=nout, **kw)
        assert max(rel_diffs(out, ref).values()) <= TOL[torch.float64], (case, nout)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("vary", [True, False])
@pytest.mark.parametrize("ni", RAGGED)
def test_vep_kernel_ragged_tiles(libs, ni, vary, dtype):
    modes = ("free_slip", "no_slip", "no_slip", "free_slip")
    args, kw = vep_random_case(ni, modes, dtype, "cpu", vary=vary, seed=ni[0])
    out = _vep(libs, args, kw, 2)
    ref = hv.stokes_vep_chunk_reference(*args, nout=2, **kw)
    assert max(rel_diffs(out, ref).values()) <= TOL[dtype]


@pytest.mark.parametrize("modes", FACE_MODES, ids=["-".join(m[:2] for m in ms)
                                                   for ms in FACE_MODES])
def test_vep_kernel_every_face_combination(libs, modes):
    args, kw = vep_random_case((21, 40), modes, torch.float64, "cpu", seed=5)
    out = _vep(libs, args, kw, 2)
    ref = hv.stokes_vep_chunk_reference(*args, nout=2, **kw)
    assert max(rel_diffs(out, ref).values()) <= TOL[torch.float64]


def _ve(libs, args, kw, nout, free_slip):
    before = [t.clone() for t in args[:6]]
    out = hs._launch(libs[hs], None, args, nout, free_slip, kw.get("G"), kw.get("K"),
                     kw.get("P0"), kw.get("Q"), kw.get("tau_o"), kw.get("dt"))
    assert all(torch.equal(a, b) for a, b in zip(before, args[:6]))
    return out


@pytest.mark.parametrize("case", ["solcx", "ve_compressible", "elastic_buildup"])
def test_ve_kernel_parity_cases(libs, case):
    args, kw = ve_case(case, 37, torch.float64, "cpu")
    for nout, free_slip in ((1, True), (3, True), (2, False)):
        out = _ve(libs, args, kw, nout, free_slip)
        ref = hs.stokes_chunk_reference(*args, nout=nout, free_slip=free_slip, **kw)
        assert max(rel_diffs_ve(out, ref).values()) <= TOL[torch.float64]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("vary", [True, False])
@pytest.mark.parametrize("ni", RAGGED)
def test_ve_kernel_ragged_tiles(libs, ni, vary, dtype):
    args, kw = ve_random_case(ni, dtype, "cpu", vary=vary, seed=ni[1])
    for free_slip in (True, False):
        out = _ve(libs, args, kw, 2, free_slip)
        ref = hs.stokes_chunk_reference(*args, nout=2, free_slip=free_slip, **kw)
        assert max(rel_diffs_ve(out, ref).values()) <= TOL[dtype], free_slip


@pytest.mark.parametrize("mode", hw.MODES)
@pytest.mark.parametrize("shape,params", [((4, 64, 64, 128), (32, 40, 32, 16)),
                                          ((2, 24, 30, 8), (12, 10, 8, 6)),
                                          ((1, 128, 64, 512), (64, 40, 32, 16))])
def test_window_copy_kernel(libs, mode, shape, params):
    src = torch.as_tensor(np.random.default_rng(7).standard_normal(shape), dtype=torch.float32)
    out = hw._launch(libs[hw], None, src, mode, *params)
    assert torch.equal(out, hw.window_copy_reference(src, mode, *params))
