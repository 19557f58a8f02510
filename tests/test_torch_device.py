"""PyTorch port, the default device and the default path: entry points build
their tensors on the card unless asked for the CPU, and raise where there is
no card; ``use_kernel=None`` launches the kernels on the card and runs the
plain path on the CPU. Whether a card exists is decided inside each test."""

import math

import pytest
import torch

from justrelax_tpu_torch import convert
from justrelax_tpu_torch.core.device import resolve_device, resolve_use_kernel
from justrelax_tpu_torch.core.state import StokesState, ThermalState
from justrelax_tpu_torch.models import (
    blankenbach,
    burstedde,
    diffusion2d,
    elastic_buildup,
    shearband,
    shearband3d,
    solcx,
    solkz,
    solvi3d,
    taylor_green,
)
from justrelax_tpu_torch.ops import hopper_stokes as hs
from justrelax_tpu_torch.ops import hopper_stokes3d as h3
from justrelax_tpu_torch.ops import hopper_stokes_vep as hv
from justrelax_tpu_torch.ops import hopper_thermal as ht
from justrelax_tpu_torch.ops import hopper_vep3d_edges as he
from justrelax_tpu_torch.rheology.materials import Material, MaterialStack

torch.set_num_threads(1)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default device is the card")


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None) == torch.device("cuda")
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)


@pytest.mark.parametrize("entry", [
    lambda: StokesState.make((8, 8)),
    lambda: MaterialStack.make([Material(G=1.0)]),
    lambda: convert.stokes_state_from_dict(convert.to_state_dict(
        StokesState.make((4, 4), device="cpu"))),
    lambda: shearband.run(n=8, nt=1),
    lambda: shearband.run_softening(n=8, nt=1),
    lambda: shearband.run_dpcap(n=8, nt=1),
    lambda: solcx.run(nx=8, ny=8),
    lambda: solkz.run(nx=8, ny=8),
    lambda: elastic_buildup.run(nx=8, ny=8, endtime_kyr=0.05),
    lambda: ThermalState.make((8, 8)),
    lambda: diffusion2d.run(nx=8, ny=8),
    lambda: blankenbach.run(nx=8, ny=8, nit=1),
    lambda: StokesState.make((4, 4, 4)),
    lambda: solvi3d.run(nx=8, ny=8, nz=8, iter_max=10, nout=5),
    lambda: burstedde.run(nx=8, ny=8, nz=8, iter_max=10, nout=5),
    lambda: taylor_green.run(n=8, iter_max=10, nout=5),
    lambda: shearband3d.run(n=6, nt=1, iter_max=10, nout=5),
    lambda: shearband3d.run_multi(n=6, nt=1, iter_max=10, nout=5),
    lambda: convert.phase_ratios_from_dict({"center": [[[0.0, 1.0]]], "vertex": [0.0],
                                            "face_x": [0.0], "face_y": [0.0]}),
], ids=["StokesState", "MaterialStack", "convert", "shearband", "softening", "dpcap",
        "solcx", "solkz", "elastic_buildup", "ThermalState", "diffusion2d", "blankenbach",
        "StokesState3d", "solvi3d", "burstedde", "taylor_green", "shearband3d",
        "shearband3d_multi", "phase_ratios"])
def test_entry_points_raise_without_a_card(no_card, entry):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_use_kernel_resolution():
    cpu = torch.zeros(2)
    assert resolve_use_kernel(None, cpu) is False
    for v in (False, True, "blocked"):
        assert resolve_use_kernel(v, cpu) == v
    with pytest.raises(ValueError, match="use_kernel"):
        resolve_use_kernel("edges", cpu)
    # each solver passes the values it admits
    routes = (False, True, "edges", "edges_split", "canvas", "blocked")
    for v in routes:
        assert resolve_use_kernel(v, cpu, allowed=routes) == v
    assert resolve_use_kernel(None, cpu, allowed=routes) is False
    with pytest.raises(ValueError, match="'edges_split'"):
        resolve_use_kernel("fused", cpu, allowed=routes)


def test_default_path_on_cpu_is_plain():
    """On CPU tensors the default runs the plain path: no launches, and the
    same result as ``use_kernel=False``."""
    hs.stokes_chunk.launches = 0
    kw = dict(nx=12, ny=12, iter_max=1_000, nout=500, device="cpu")
    _, a, info_a, _ = solcx.run(**kw)
    _, b, info_b, _ = solcx.run(use_kernel=False, **kw)
    assert hs.stokes_chunk.launches == 0
    assert info_a.iters == info_b.iters
    assert torch.equal(a.V.Vx, b.V.Vx) and torch.equal(a.P, b.P)
    hv.stokes_vep_chunk.launches = 0
    sa = shearband.run(n=8, nt=1, iter_max=200, nout=100, device="cpu")
    sb = shearband.run(n=8, nt=1, iter_max=200, nout=100, device="cpu", use_kernel=False)
    assert hv.stokes_vep_chunk.launches == 0
    assert torch.equal(sa[0].V.Vx, sb[0].V.Vx)
    assert math.isclose(sa[2][-1], sb[2][-1], rel_tol=0.0)


def test_default_thermal_path_on_cpu_is_plain():
    """heatdiffusion_PT with no use_kernel on CPU tensors: no launches, the
    same result as ``use_kernel=False``."""
    from chip_smoke import pallas_thermal_setup
    from justrelax_tpu_torch.core.coeffs import PTThermalCoeffs
    from justrelax_tpu_torch.solvers.thermal import heatdiffusion_PT

    g, K, rc, bc, Tg = pallas_thermal_setup(12, torch.float64, "cpu")
    th = ThermalState.make((12, 12), device="cpu").replace(T=Tg, Told=Tg)
    pt = PTThermalCoeffs.make(K, rc, 0.3, g.di, g.li)
    ht.thermal_chunk.launches = 0
    a, ia = heatdiffusion_PT(th, pt, bc, 0.3, g, K=K, rho_Cp=rc, iter_max=400, nout=100)
    b, ib = heatdiffusion_PT(th, pt, bc, 0.3, g, K=K, rho_Cp=rc, iter_max=400, nout=100,
                             use_kernel=False)
    assert ht.thermal_chunk.launches == 0
    assert ia.iters == ib.iters and torch.equal(a.T, b.T)


def test_default_3d_path_on_cpu_is_plain():
    """solvi3d with no use_kernel on CPU tensors: no launches, and the same
    result as ``use_kernel=False``; ``solve_ve_3d`` resolves the path from
    the state's device."""
    h3.stokes3d_chunk.launches = 0
    kw = dict(nx=8, ny=8, nz=8, rc=2.0, iter_max=20, nout=10, device="cpu")
    _, a, ia = solvi3d.run(**kw)
    _, b, ib = solvi3d.run(use_kernel=False, **kw)
    assert h3.stokes3d_chunk.launches == 0
    assert ia.iters == ib.iters
    assert torch.equal(a.V.Vx, b.V.Vx) and torch.equal(a.P, b.P) and torch.equal(a.R.RP, b.R.RP)
    _, c, _ = solvi3d.run(use_kernel=True, **kw)  # the kernel route: the plain chunk on CPU
    assert h3.stokes3d_chunk.launches == 0
    assert not torch.equal(c.R.RP, a.R.RP)  # post-update residuals
    assert float((c.V.Vx - a.V.Vx).abs().max()) <= 1e-12 * float(a.V.Vx.abs().max())


def test_default_3d_vep_path_on_cpu_is_plain():
    """shearband3d with no use_kernel on CPU tensors runs the serial path:
    no edge-kernel launch, and the same result as ``use_kernel=False``."""
    he.vep3d_edges.launches = he.vep3d_edges.split_launches = 0
    kw = dict(n=6, nt=1, iter_max=20, nout=10, device="cpu")
    a, ia, ta, _ = shearband3d.run(**kw)
    b, ib, tb, _ = shearband3d.run(use_kernel=False, **kw)
    assert he.vep3d_edges.launches == he.vep3d_edges.split_launches == 0
    assert ia.iters == ib.iters and ta == tb
    assert torch.equal(a.V.Vx, b.V.Vx) and torch.equal(a.tau.xz, b.tau.xz)
