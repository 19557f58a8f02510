"""The tiled chunk kernels' CUDA sources run on the CPU under a host
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
- ``csrc/window_copy.cu`` (R): the three modes at five shapes and four cuts,
  its TMA copies as strided copies checked against the emulated
  tensor map, shared memory and mbarrier;
- ``csrc/stokes3d_ve.cu`` (B7): ragged grids that do not fill the (y, z)
  tile, in the viscous form, the general form with dt = ∞ (its varying
  coefficients derived from η and ητ) and with a finite dt (streamed, but
  for the face coefficients), on the ``viscous_consts`` route, with and
  without the free-slip ghosts, and with the x extent split over blocks;
- ``csrc/stokes3d_vep.cu``: B8 (the fused 3D VEP chunk, its stress pass
  tiled) in the five configurations of ``chip_smoke.py``'s phase 22 at
  8³–11³, and B6 and B9 (the edge passes' x-march, which shares its
  return mapping) in the four of phase 18 and on ragged grids that leave
  the (y, z) tile unfilled, span two tiles and split x into ranges, f64
  and f32, every input in a NaN-padded buffer.

Each call goes through the wrapper's own ``_launch`` (argument checks, slot
packing, work sets). This checks the kernels' index arithmetic, halos, tile
ownership, ghost rules and operation order; the compiler and the card are
checked by ``tests/test_torch_cuda.py`` on the card. The host's arithmetic
is IEEE as the card's, without the card's FMA contractions, so f64 is held
to 1e-13 here. Skips where no C++20 compiler exists.
"""

import ctypes
import math
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import (
    FACE_MODES,
    VEP3D_CASES,
    VEP3D_CHUNK_CASES,
    chunk_case,
    flat_vep_carry,
    rel_diffs,
    rel_diffs_ve,
    rel_diffs_edges,
    rel_diffs_ve3d,
    rel_diffs_vep3d,
    ve3d_case,
    ve_case,
    ve_random_case,
    vep3d_case,
    vep_random_case,
)
from justrelax_tpu_torch.ops import hopper_stokes as hs
from justrelax_tpu_torch.ops import hopper_stokes3d as h3
from justrelax_tpu_torch.ops import hopper_stokes3d_vep as hc
from justrelax_tpu_torch.ops import hopper_vep3d_edges as he
from justrelax_tpu_torch.ops import hopper_stokes_vep as hv
from justrelax_tpu_torch.ops import hopper_window_copy as hw
from justrelax_tpu_torch.ops.stokes3d_vep_canvas import edge_masks

torch.set_num_threads(1)

HERE = Path(__file__).resolve().parent
TOL = {torch.float64: 1e-13, torch.float32: 1e-5}
RAGGED = [(2, 2), (3, 5), (33, 31), (17, 70)]


def _emulated(source: Path, out: Path, bind):
    """Build ``source`` against the emulation header and bind it."""
    text = source.read_text().replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
    text = text.replace("#include <cuda.h>\n", "").replace("#include <cudaTypedefs.h>\n", "")
    text = re.sub(r"extern __shared__ __align__\(16\) (\w+ ?\w*) (\w+)\[\];",
                  r"\1* \2 = reinterpret_cast<\1*>(emu_smem);", text)
    text = re.sub(r"(\w+)<<<([^>]*)>>>\(", r"emu_launch(\1, \2, ", text)
    # cp.async: a plain copy; commit and wait have nothing to do. TMA: a
    # strided copy of the box, its bytes counted on the emulated mbarrier;
    # the proxy fence and the bulk group's commit and wait have nothing to do
    for name, body in (("cp_async16", "std::memcpy(smem, gmem, 16);"),
                       ("cp_async_elem", "*smem = *gmem;"),
                       ("cp_async_commit", ""), ("cp_async_wait_all", ""),
                       ("cp_async_wait_group", ""),
                       ("mbar_init", "emu_mbar_init(bar, 1);"),
                       ("mbar_expect_tx", "emu_mbar_add(bar, -1, bytes);"),
                       ("mbar_wait", "emu_mbar_wait(bar, parity);"),
                       ("tma_load_4d", "emu_tma_4d(smem, map, bar, c0, c1, c2, c3);"),
                       ("tma_store_4d",
                        "emu_tma_4d(const_cast<void*>(smem), map, nullptr, c0, c1, c2, c3);"),
                       ("fence_proxy_async", ""), ("bulk_commit_and_wait_read", "")):
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
            for mod in (hv, hs, hw, h3, he)}


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


def _window_copy(lib, src, mode, params, rows=None):
    """R's kernel under the emulation; no TMA box off its shared memory, no
    barrier wait that would not complete on the card."""
    faults = lib.emu_fault_count()
    out = hw._launch(lib, None, src, mode, *params, rows=rows)
    assert lib.emu_fault_count() == faults
    return out


@pytest.mark.parametrize("mode", hw.MODES)
@pytest.mark.parametrize("shape,params", [((4, 64, 64, 128), (32, 40, 32, 16)),
                                          ((2, 24, 30, 8), (12, 10, 8, 6)),
                                          ((1, 128, 64, 512), (64, 40, 32, 16)),
                                          ((3, 20, 24, 4), (10, 9, 5, 6)),
                                          ((2, 16, 32, 256), (8, 20, 8, 16))],
                         ids=["script", "small", "z512", "z4", "box256"])
def test_window_copy_kernel(libs, mode, shape, params):
    """At the script's shape, a small one, Z = 512 (two TMA boxes along z),
    Z = 4 (a box's inner 16 bytes) and Z = 256 (a box of 256 elements)."""
    src = torch.as_tensor(np.random.default_rng(7).standard_normal(shape), dtype=torch.float32)
    out = _window_copy(libs[hw], src, mode, params)
    assert torch.equal(out, hw.window_copy_reference(src, mode, *params))


@pytest.mark.parametrize("mode", hw.MODES)
@pytest.mark.parametrize("rows", [2, 4, 32])
def test_window_copy_kernel_rows(libs, mode, rows):
    """Other cuts of the script's shape than ``plan``'s one x row a block,
    up to a whole window (256 KiB of shared memory in mode "loop" is
    refused)."""
    shape, params = (4, 64, 64, 128), (32, 40, 32, 16)
    src = torch.as_tensor(np.random.default_rng(8).standard_normal(shape), dtype=torch.float32)
    if hw.plan(128, 32, 16, mode, rows)[3] > hw._SMEM_MAX:
        with pytest.raises(ValueError, match="shared memory"):
            hw._launch(libs[hw], None, src, mode, *params, rows=rows)
        return
    out = _window_copy(libs[hw], src, mode, params, rows)
    assert torch.equal(out, hw.window_copy_reference(src, mode, *params))


def test_window_copy_kernel_rejects_misaligned_and_strided(libs):
    shape, params = (4, 64, 64, 128), (32, 40, 32, 16)
    buf = torch.zeros(int(np.prod(shape)) + 1)
    misaligned = buf[1:].view(shape)
    assert misaligned.is_contiguous() and misaligned.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        hw._launch(libs[hw], None, misaligned, "2d", *params)
    with pytest.raises(ValueError, match="contiguous"):
        hw._launch(libs[hw], None, torch.zeros(shape).transpose(1, 2), "2d", *params)


def test_window_copy_encode_failure_raises(libs, monkeypatch):
    """Past the wrapper's checks, a misaligned base fails the tensor map's
    encode, and the wrapper raises with its CUresult."""
    shape, params = (4, 64, 64, 128), (32, 40, 32, 16)
    misaligned = torch.zeros(int(np.prod(shape)) + 1)[1:].view(shape)
    monkeypatch.setattr(hw, "_kernel_check",
                        lambda src, mode, R, Ry, rows: hw.plan(shape[3], R, Ry, mode, rows))
    with pytest.raises(RuntimeError, match="CUresult 1"):
        hw._launch(libs[hw], None, misaligned, "2d", *params)


def _guarded(t):
    """``t`` copied into the middle of a NaN buffer two x planes longer at
    each end: a kernel that reads past the canvas reads NaN."""
    pad = 2 * t[0].numel()
    buf = torch.full((t.numel() + 2 * pad,), math.nan, dtype=t.dtype)
    buf[pad:pad + t.numel()] = t.reshape(-1)
    return buf[pad:pad + t.numel()].view(t.shape)


def _ve3d(libs, carry, co, inv_di, nout, free_slip, derive_from, x_planes=None):
    carry = tuple(_guarded(t) for t in carry)
    before = [t.clone() for t in carry]
    out = h3._launch(libs[h3], None, carry, co, inv_di, nout, free_slip, derive_from,
                     x_planes)
    assert all(torch.equal(a, b) for a, b in zip(before, carry))  # input not written
    return out


RAGGED_3D = [(5, 4, 3), (11, 8, 6), (22, 9, 7), (4, 10, 35), (3, 5, 70)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["viscous", "ve_dt_inf", "ve_general", "viscous_consts",
                                  "viscous_no_free_slip"])
@pytest.mark.parametrize("ni", RAGGED_3D)
def test_ve3d_kernel_ragged_tiles(libs, ni, case, dtype):
    """B7 against its plain version after 1 and 3 iterations, the second with
    the x extent split into ranges of 2 planes; the slot table derives what
    it should (all 8 varying canvases where dt = ∞, the face coefficients
    with a finite dt)."""
    form = "viscous" if case == "viscous_consts" else case
    carry, co, inv_di, free_slip, (consts, scalars) = ve3d_case(form, ni, dtype, "cpu")
    derive_from = (consts[0], consts[1], scalars)
    if case == "viscous_consts":
        co, derive_from = h3._coefficients(None, consts, scalars)
    packed = h3.pack_coeffs(co, dtype, derive_from)
    names = packed.derived.names
    want = h3.DERIVABLE[5:] if case == "ve_general" else h3.DERIVABLE
    assert names == want, names
    for nout, x_planes in ((1, None), (3, 2)):
        out = _ve3d(libs, carry, packed, inv_di, nout, free_slip, None, x_planes)
        ref = h3.stokes3d_chunk_reference(carry, co, inv_di, nout, free_slip=free_slip)
        worst = max(rel_diffs_ve3d(out, ref).values())
        assert worst <= TOL[dtype], (nout, worst)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", VEP3D_CHUNK_CASES)
def test_vep3d_chunk_kernel(libs, case, dtype):
    """B8 against its plain version after 1 and 3 iterations; the input
    carry is not written."""
    n = {"blocked_plastic": 8, "blocked_elastic": 9}.get(case, 10)
    carry, co, _, _, inv_di, kw = vep3d_case(case, dtype, "cpu", n=n)
    kw = dict(kw, viscosity_cutoff=kw.get("viscosity_cutoff", (-math.inf, math.inf)))
    carry = carry._replace(**{
        k: tuple(map(_guarded, v)) if isinstance(v, tuple) else _guarded(v)
        for k, v in carry._asdict().items()})
    before = [t.clone() for t in flat_vep_carry(carry)]
    for nit in (1, 3):
        out = hc._launch(libs[he], None, carry, co, inv_di, nit, kw)
        ref = hc.stokes3d_vep_chunk_reference(carry, co, inv_di, nit, **kw)
        worst = max(rel_diffs_vep3d(out, ref).values())
        assert worst <= TOL[dtype], (nit, worst)
    assert all(torch.equal(a, b) for a, b in zip(before, flat_vep_carry(carry)))


# the edge kernel (B6/B9) on phase 18's random near-yield configuration on
# grids that leave its 4 x 32 (y, z) tile unfilled, span three y and two z
# tiles, and (the emulated card holds four blocks, so two (y, z) tiles take
# two x ranges each) split x into ranges
EDGE_RAGGED = {"ragged_5_4_3": (5, 4, 3), "ragged_3_9_33": (3, 9, 33),
               "x_ranges_9_5_4": (9, 5, 4)}


def _guard_consts(packed):
    """``packed`` with each G_e and τ_o canvas in a NaN-padded buffer (one
    buffer per source)."""
    memo = {}

    def guard(t):
        if t is None:
            return None
        return memo.setdefault(id(t), _guarded(t))
    return packed._replace(G=tuple(map(guard, packed.G)),
                           tau_o=tuple(tuple(map(guard, fam)) for fam in packed.tau_o))


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("case", VEP3D_CASES + tuple(EDGE_RAGGED))
def test_vep3d_edges_kernel(libs, case, split):
    """B6 (B9 with ``split``) against their plain version after one call, f64
    and f32, every input in a NaN-padded buffer: the inputs are not written
    and the slots a family does not own come back bit-equal."""
    for dtype in (torch.float64, torch.float32):
        ni = EDGE_RAGGED.get(case)
        carry, co6, co9, _, inv_di, kw = (
            vep3d_case("noncubic_near_yield", dtype, "cpu", ni=ni) if ni
            else vep3d_case(case, dtype, "cpu", n=8))
        packed = _guard_consts(he.pack_edge_consts(co9 if split else co6, split))
        dyn = tuple(map(_guarded, (*carry.V, carry.theta, carry.eta, *carry.tau_c[:3],
                                   *carry.tau_e, *carry.lam_e)))
        before = [t.clone() for t in dyn]
        ekw = dict(dt=kw["dt"], theta_dtau=kw["theta_dtau"],
                   lambda_relaxation=kw["lambda_relaxation"])
        out = he._launch(libs[he], None, dyn, packed, inv_di, *ekw.values(), split)
        assert all(torch.equal(a, b) for a, b in zip(before, dyn))  # input not written
        ref = he.vep3d_edges_reference(dyn[:3], dyn[3], dyn[4], dyn[5:8], dyn[8:11], dyn[11:],
                                       packed, inv_di, split=split, **ekw)
        out, ref = (*out[0], *out[1]), (*ref[0], *ref[1])
        worst = max(rel_diffs_edges(out, ref).values())
        assert worst <= TOL[dtype], (dtype, worst)
        _, Me = edge_masks(tuple(carry.P.shape), "cpu")
        for k, (o, b) in enumerate(zip(out, dyn[8:])):
            off = ~Me[k % 3].expand(o.shape)
            assert torch.equal(o[off], b[off]), (dtype, k)
