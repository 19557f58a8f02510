"""PyTorch port, the six free-surface models of the variational solvers
against the JAX package on the CPU in float64, each with the JAX model's
arguments at a small size: Volcano2D and its DYREL twin at 16×8, the
Rayleigh-Taylor overturn and the two plumes at 16², Crameri's relaxation
at 16², the 2D subduction at 32×12 and the 3D subduction at 16×4×8, one
step each (two for the overturn). Where the JAX model's ``run`` takes no
Stokes cap, the same cap is set on the solver both models call (the
``capped`` fixture), so that a case stays within seconds.

Held as tests/test_torch_models_particles.py holds its models: equal
iterations, equal active masks and marker chains within 1e-10 of the
domain's height, every grid field within 1e-10 of its family's max, and
the models' own diagnostics (max |Vy| per step, the topography modes)
within 1e-10. Each model also runs with ``use_kernel=None`` resolved as on
the card: every solve the kernels refuse is passed ``use_kernel=False`` by
the model itself.
"""

import numpy as np
import pytest
import torch

from justrelax_tpu.models import crameri2d as jcrameri
from justrelax_tpu.models import rayleigh_taylor as jrt
from justrelax_tpu.models import subduction2d as jsub2d
from justrelax_tpu.models import subduction3d as jsub3d
from justrelax_tpu.models import volcano2d as jvolcano
from justrelax_tpu.models import volcano2d_dyrel as jvolcano_dyrel
from justrelax_tpu_torch.models import (
    crameri2d,
    rayleigh_taylor,
    subduction2d,
    subduction3d,
    volcano2d,
    volcano2d_dyrel,
)
from chip_smoke import with_caps
from test_torch_models_particles import _np, close_family, same_info, same_particles, same_stokes

torch.set_num_threads(1)

SMALL_PARTICLES = dict(nxcell=6, max_xcell=12, min_xcell=3)


def capped(monkeypatch, modules, name, **caps):
    """Set ``caps`` (iter_max, nout, ...) on every call of the solver
    ``name`` of each of ``modules``, over the model's own arguments."""
    for mod in modules:
        monkeypatch.setattr(mod, name, with_caps(getattr(mod, name), caps))


def same_thermal(p, j):
    close_family([(p.T, j.T)])


def test_volcano2d_matches_jax(monkeypatch):
    capped(monkeypatch, (volcano2d, jvolcano), "solve_variational", iter_max=2_000, nout=500)
    p_st, p_th, p_par, p_chain, p_phim, p_info = volcano2d.run(nx=16, ny=8, nt=1, device="cpu")
    j_st, j_th, j_par, j_chain, j_phim, j_info = jvolcano.run(nx=16, ny=8, nt=1)
    same_info(p_info, j_info)
    same_stokes(p_st, j_st)
    close_family([(p_st.tau.II, j_st.tau.II)])
    same_thermal(p_th, j_th)
    close_family([(p_phim, j_phim)])
    same_particles(p_par, j_par, 30.0e3)
    assert np.abs(_np(p_chain.y) - _np(j_chain.y)).max() <= 1e-10 * 25.0e3


def test_volcano2d_dyrel_matches_jax(monkeypatch):
    """The volcano's nonlinear plastic DYREL solve amplifies rounding: a
    first chunk of the model's 200 DR iterations runs undamped (c = 0) and
    takes a 1e-16 difference of the packages' operation order to 2e-3 of
    Vx, and with 20-iteration chunks the difference reaches 2e-7 after
    2 220 iterations. So the two are held over their first 1 000 DR
    iterations in 20-iteration chunks, where they agree within 1e-12."""
    capped(monkeypatch, (volcano2d_dyrel, jvolcano_dyrel), "solve_dyrel", total_iter_max=1_000,
           iter_max=1_000, nout=20)
    p_st, p_th, p_par, p_phim, p_info, p_aux = volcano2d_dyrel.run(nx=16, ny=8, nt=1,
                                                                   device="cpu")
    j_st, j_th, j_par, j_phim, j_info, j_aux = jvolcano_dyrel.run(nx=16, ny=8, nt=1)
    same_info(p_info, j_info)
    same_stokes(p_st, j_st)
    same_thermal(p_th, j_th)
    close_family([(p_aux["rho_gy"], j_aux["rho_gy"])])
    same_particles(p_par, j_par, 30.0e3)


RT_CASES = {
    "run": (rayleigh_taylor.run, jrt.run, dict(nt=2, iter_max=1_000, nout=500)),
    "run_plume": (rayleigh_taylor.run_plume, jrt.run_plume, dict(nt=1, iter_max=2_000,
                                                                 nout=500)),
    "run_plume_variational": (rayleigh_taylor.run_plume_variational, jrt.run_plume_variational,
                              dict(nt=1, iter_max=2_000, nout=500)),
}


@pytest.mark.parametrize("case", sorted(RT_CASES))
def test_rayleigh_taylor_matches_jax(case):
    p_run, j_run, kw = RT_CASES[case]
    kw = dict(kw, nx=16, ny=16, **SMALL_PARTICLES)
    p_st, p_par, p_ph, p_info, p_vmax, p_t = p_run(**kw, device="cpu")
    j_st, j_par, j_ph, j_info, j_vmax, j_t = j_run(**kw)
    same_info(p_info, j_info)
    same_stokes(p_st, j_st)
    same_particles(p_par, j_par, 600.0e3)
    np.testing.assert_array_equal(_np(p_ph), _np(j_ph))
    np.testing.assert_allclose(p_vmax, j_vmax, rtol=1e-10)
    np.testing.assert_allclose(p_t, j_t, rtol=1e-10)


def test_crameri2d_matches_jax():
    kw = dict(nx=16, ny=16, nt=1, iter_max=4_000, nout=1_000, **SMALL_PARTICLES)
    p_st, p_par, p_ph, p_info, p_h, p_t = crameri2d.run(**kw, device="cpu")
    j_st, j_par, j_ph, j_info, j_h, j_t = jcrameri.run(**kw)
    same_info(p_info, j_info)
    same_stokes(p_st, j_st)
    same_particles(p_par, j_par, 2800.0e3)
    np.testing.assert_array_equal(_np(p_ph), _np(j_ph))
    np.testing.assert_allclose(p_h, j_h, rtol=1e-10)
    np.testing.assert_allclose(p_t, j_t, rtol=1e-10)


def test_subduction2d_matches_jax(monkeypatch):
    capped(monkeypatch, (subduction2d, jsub2d), "solve_variational", iter_max=1_500, nout=500)
    p_st, p_th, p_info, p_ph = subduction2d.run(nx=32, ny=12, nt=1, device="cpu")
    j_st, j_th, j_info, j_ph = jsub2d.run(nx=32, ny=12, nt=1)
    same_info(p_info, j_info)
    same_stokes(p_st, j_st)
    same_thermal(p_th, j_th)
    np.testing.assert_array_equal(p_ph, j_ph)
    close_family([(p_info.err_history, j_info.err_history)])


def test_subduction3d_matches_jax(monkeypatch):
    capped(monkeypatch, (subduction3d, jsub3d), "solve_vep_3d", iter_max=500, nout=500)
    p_st, p_th, p_info, p_ph = subduction3d.run(nx=16, ny=4, nz=8, nt=1, device="cpu")
    j_st, j_th, j_info, j_ph = jsub3d.run(nx=16, ny=4, nz=8, nt=1)
    same_info(p_info, j_info)
    same_stokes(p_st, j_st)
    close_family([(p_st.tau.II, j_st.tau.II)])
    same_thermal(p_th, j_th)
    np.testing.assert_array_equal(p_ph, j_ph)


def _as_on_the_card(monkeypatch):
    """``use_kernel=None`` resolved as on the card (the kernel) in every
    solver the six models reach."""
    from justrelax_tpu_torch.core import device
    from justrelax_tpu_torch.solvers import stokes2d_vep, stokes3d_vep, thermal

    def resolve(use_kernel, tensor, allowed=(False, True, "blocked")):
        return device.resolve_use_kernel(True if use_kernel is None else use_kernel, tensor,
                                         allowed)

    for mod in (stokes2d_vep, stokes3d_vep, thermal):
        monkeypatch.setattr(mod, "resolve_use_kernel", resolve)


ROUTE_RUNS = {
    "volcano2d": (volcano2d, "solve_variational",
                  lambda: volcano2d.run(nx=8, ny=6, nt=1, device="cpu")),
    "volcano2d_dyrel": (volcano2d_dyrel, "solve_dyrel",
                        lambda: volcano2d_dyrel.run(nx=8, ny=6, nt=1, device="cpu")),
    "rayleigh_taylor": (rayleigh_taylor, "solve_variational",
                        lambda: rayleigh_taylor.run(nx=8, ny=8, nt=1, **SMALL_PARTICLES,
                                                    device="cpu")),
    "run_plume": (rayleigh_taylor, "solve_vep",
                  lambda: rayleigh_taylor.run_plume(nx=8, ny=8, nt=1, **SMALL_PARTICLES,
                                                    device="cpu")),
    "crameri2d": (crameri2d, "solve_variational",
                  lambda: crameri2d.run(nx=8, ny=8, nt=1, **SMALL_PARTICLES, device="cpu")),
    "subduction2d": (subduction2d, "solve_variational",
                     lambda: subduction2d.run(nx=16, ny=6, nt=1, device="cpu")),
    "subduction3d": (subduction3d, "solve_vep_3d",
                     lambda: subduction3d.run(nx=8, ny=4, nz=6, nt=1, device="cpu")),
}


@pytest.mark.parametrize("model", sorted(ROUTE_RUNS))
def test_default_routes_as_on_the_card(model, monkeypatch):
    """With ``use_kernel=None`` resolved as on the card, each model runs (a
    few Stokes iterations): every solve a kernel refuses (the masked 3D VEP
    solve, ``run_plume``'s free-surface VEP solve, the thermal solves with
    a material) is passed ``use_kernel=False`` by the model, so none raises
    the kernel guard's ``ValueError``."""
    _as_on_the_card(monkeypatch)
    mod, name, run = ROUTE_RUNS[model]
    caps = dict(total_iter_max=200, nout=100) if name == "solve_dyrel" else dict(
        iter_max=200, iter_min=0, nout=100)
    capped(monkeypatch, (mod,), name, **caps)
    out = run()
    assert all(o is not None for o in out)
