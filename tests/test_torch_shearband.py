"""PyTorch port, the flagship solve end to end on the CPU in float64:

- ``solve_vep`` (``use_kernel`` False and True; on CPU tensors both run the
  array path) against the JAX ``solve_vep`` at n=16 with stresses near yield,
  at a fixed iteration count (``iter_min == iter_max``: an ulp in ``_norm``'s
  reduction order may move a converged solve by one chunk);
- the shear band models against the JAX models over their first steps;
- the frozen f64 shear band values of tests/test_shearband2d.py at n=32,
  nt=10 (marked slow: the run takes over 60 s on this CPU);
- the guards, and that importing the port leaves JAX unloaded.
"""

import math
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from justrelax_tpu.core.coeffs import PTStokesCoeffs as JCoeffs
from justrelax_tpu.core.grid import Geometry as JGeometry
from justrelax_tpu.core.state import StokesState as JStokesState
from justrelax_tpu.models import shearband as jshearband
from justrelax_tpu.models.shearband import _circle_phase_ratios
from justrelax_tpu.ops import bc as jbc
from justrelax_tpu.rheology import materials as jm
from justrelax_tpu.solvers.stokes2d_vep import solve_vep as j_solve_vep
from justrelax_tpu_torch import convert
from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.models import shearband
from justrelax_tpu_torch.ops import bc as pbc
from justrelax_tpu_torch.rheology import materials as pm
from justrelax_tpu_torch.solvers.stokes2d_vep import solve_vep

torch.set_num_threads(1)

_C = 1.6 / math.cos(math.radians(30.0))
_COMMON = dict(rho0=0.0, Kb=5.0, eta0=1.0, is_plastic=1.0, C=_C,
               friction_angle=30.0, dilation_angle=10.0, eta_reg=1e-2)


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif v is not None:
            out[prefix + k] = np.asarray(v)
    return out


def _setup(n=16):
    """The solve inputs of tests/test_pallas_vep.py, with the stress and the
    old stress near yield so that the return mapping acts."""
    ni = (n, n)
    jg = JGeometry(ni, (1.0, 1.0))
    pr_c = _circle_phase_ratios(jg.xci[0], jg.xci[1], (0.5, 0.5), 0.1)
    pr_v = _circle_phase_ratios(jg.xvi[0], jg.xvi[1], (0.5, 0.5), 0.1)
    bc = dict(free_slip=dict(left=True, right=True, top=True, bot=True))
    st = JStokesState.make(ni)
    xv = jnp.asarray(jg.xvi[0])
    Vx, Vy = jbc.flow_bcs(
        (jnp.broadcast_to(xv[:, None], (n + 1, n + 2)),
         jnp.broadcast_to(-xv[None, :], (n + 2, n + 1))),
        jbc.VelocityBoundaryConditions(**bc))
    tau = st.tau.replace(xx=st.tau.xx + 1.6, yy=st.tau.yy - 1.6,
                         xy_c=st.tau.xy_c + 1.0, xy=st.tau.xy + 1.0)
    st = st.replace(V=st.V.replace(Vx=Vx, Vy=Vy), tau=tau, tau_o=tau,
                    EII_pl=st.EII_pl + 0.001)
    mats = [dict(G=1.0, **_COMMON), dict(G=0.5, **_COMMON)]
    return dict(n=n, state=serialization.to_state_dict(st), mats=mats,
                pr=(pr_c, pr_v), bc=bc)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_solve_vep_matches_jax(use_kernel):
    c = _setup()
    n, kw = c["n"], dict(iter_max=300, iter_min=300, nout=100)
    jst = serialization.from_state_dict(JStokesState.make((n, n)), c["state"])
    jmat = jm.MaterialStack.make([jm.Material(**m) for m in c["mats"]])
    jg = JGeometry((n, n), (1.0, 1.0))
    jpt = JCoeffs.make(jg.li, jg.di, CFL=0.75 / math.sqrt(2.1))
    j_out, j_info = j_solve_vep(
        jst, jpt, jg, jbc.VelocityBoundaryConditions(**c["bc"]), jmat,
        jnp.asarray(c["pr"][0]), jnp.asarray(c["pr"][1]), 0.25, **kw)

    pst = convert.stokes_state_from_dict(c["state"], device="cpu")
    pmat = pm.MaterialStack.make([pm.Material(**m) for m in c["mats"]], device="cpu")
    g = Geometry((n, n), (1.0, 1.0))
    pt = PTStokesCoeffs.make(g.li, g.di, CFL=0.75 / math.sqrt(2.1))
    p_out, p_info = solve_vep(
        pst, pt, g, pbc.VelocityBoundaryConditions(**c["bc"]), pmat,
        torch.tensor(c["pr"][0]), torch.tensor(c["pr"][1]), 0.25,
        use_kernel=use_kernel, **kw)

    assert p_info.iters == int(j_info.iters) == 300
    assert float(np.asarray(j_out.lam).max()) > 0.0  # plasticity acts
    np.testing.assert_allclose(float(p_info.err), float(j_info.err), rtol=1e-9)
    np.testing.assert_allclose(p_info.err_history.numpy(), np.asarray(j_info.err_history),
                               rtol=1e-9)
    a = _flat(convert.to_state_dict(p_out))
    b = _flat(serialization.to_state_dict(j_out))
    assert a.keys() == b.keys()
    for k in a:
        scale = max(float(np.abs(b[k]).max(initial=0.0)), 1.0)
        assert np.abs(a[k] - b[k]).max(initial=0.0) <= 1e-10 * scale, k


def test_shearband_first_steps_match_jax():
    p_st, p_info, p_tmax, p_sol, p_tII = shearband.run(n=32, nt=2, device="cpu")
    j_st, j_info, j_tmax, j_sol, j_tII = jshearband.run(n=32, nt=2)
    assert p_info.iters == int(j_info.iters)
    assert float(p_info.err) < 1e-6
    np.testing.assert_allclose(p_tmax, j_tmax, rtol=1e-10)
    assert p_sol == j_sol
    np.testing.assert_allclose(p_tII.numpy(), np.asarray(j_tII), rtol=1e-10)
    np.testing.assert_allclose(p_st.V.Vx.numpy(), np.asarray(j_st.V.Vx), rtol=0, atol=1e-10)


def test_shearband_variants_match_jax():
    p = shearband.run_softening(n=16, nt=1, device="cpu")
    j = jshearband.run_softening(n=16, nt=1)
    assert p[1].iters == int(j[1].iters)
    np.testing.assert_allclose(p[2], j[2], rtol=1e-10)
    p_st, p_info, p_tII = shearband.run_dpcap(n=16, nt=1, device="cpu")
    j_st, j_info, j_tII = jshearband.run_dpcap(n=16, nt=1)
    assert p_info.iters == int(j_info.iters)
    np.testing.assert_allclose(p_tII.numpy(), np.asarray(j_tII), rtol=1e-10)
    np.testing.assert_allclose(p_st.EVol_pl.numpy(), np.asarray(j_st.EVol_pl), rtol=0, atol=1e-12)


@pytest.mark.slow
def test_shearband_golden_f64():
    """Frozen f64 values of the JAX package (tests/test_shearband2d.py)."""
    stokes, info, tau_max, sol, tau_II = shearband.run(n=32, nt=10, device="cpu")
    assert float(info.err) < 1.0e-6
    assert sol[-1] == pytest.approx(1.8358, abs=1.0e-4)
    assert float(tau_II.min()) == pytest.approx(1.512963, abs=1e-4)
    assert float(tau_II.max()) == pytest.approx(1.641536, abs=1e-4)
    assert tau_max[-1] == pytest.approx(1.637653, abs=1e-4)


def test_guards():
    # the displacement-driven band runs (it raised before ops/displacement.py)
    st_u, info_u, _, _, _ = shearband.run(n=8, nt=1, displacement_driven=True, device="cpu",
                                          iter_max=200)
    assert info_u.iters > 0 and torch.equal(st_u.U.Ux, st_u.V.Vx * 0.25)
    # visc_plastic_tau: the kernel route refuses it, the plain route runs it
    with pytest.raises(ValueError, match="use_kernel=False"):
        shearband.run(n=8, nt=1, visc_plastic_tau=True, device="cpu", use_kernel=True)
    _, info, _, _, tII = shearband.run(n=8, nt=1, visc_plastic_tau=True, device="cpu",
                                       use_kernel=False, iter_max=200)
    assert info.iters > 0 and bool(torch.isfinite(tII).all())
    g = Geometry((8, 8), (1.0, 1.0))
    pt = PTStokesCoeffs.make(g.li, g.di)
    st = shearband.StokesState.make((8, 8), device="cpu")
    fs = pbc.VelocityBoundaryConditions(free_slip=dict(left=True, right=True, top=True, bot=True))
    bad_bc = pbc.VelocityBoundaryConditions(free_slip=dict(left=True, right=True, top=True))
    lin = pm.MaterialStack.make([pm.Material(G=1.0, Kb=5.0)], device="cpu")
    beta = pm.MaterialStack.make([pm.Material(G=1.0, beta=0.1)], device="cpu")
    peierls = pm.MaterialStack.make([pm.Material(G=1.0, peierls_A=1.0, peierls_tauP=10.0)],
                                     device="cpu")
    for mat, bc_ in ((lin, bad_bc), (beta, fs), (peierls, fs)):
        with pytest.raises(ValueError):
            solve_vep(st, pt, g, bc_, mat, None, None, 0.25, use_kernel=True,
                      iter_max=100, nout=50)
    with pytest.raises(ValueError):
        solve_vep(st, pt, g, fs, lin, None, None, 0.25, use_kernel="edges")


def test_import_leaves_jax_out():
    modules = ("models.shearband", "models.solcx", "models.solkz", "models.elastic_buildup",
               "convert", "models.sinking_block", "models.solvi2d",
               "models.global_convection2d", "models.diffusion3d", "models.thermal_stresses",
               "models.shearheating", "models.shearheating3d", "ops.interpolation",
               "ops.heating", "ops.thermal", "ops.bc", "rheology.melting",
               "rheology.viscosity", "solvers.thermal", "solvers.stokes2d_vep",
               "solvers.dyrel", "solvers.thermal_explicit", "models.shearband_dyrel",
               "models.thermal_stresses_dyrel", "utils.units", "ops.displacement",
               "ops.principal_stresses", "ops.stress_rotation", "rheology.plasticity",
               "rheology.materials", "core.grid", "models.shearband_refined",
               "models.taylor_green", "solvers.stokes2d", "solvers.stokes2d_variational",
               "solvers.stokes3d", "solvers.stokes3d_vep", "solvers.stokes3d_variational",
               "ops.stokes", "ops.stokes3d", "ops.stokes_vep")
    code = ("import sys, justrelax_tpu_torch, "
            + ", ".join(f"justrelax_tpu_torch.{m}" for m in modules)
            + "; assert 'jax' not in sys.modules and 'justrelax_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
