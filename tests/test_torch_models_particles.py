"""PyTorch port, the particle models against the JAX package on the CPU in
float64, each with the JAX model's arguments at a small size: Van Keken at
10² over 2 steps, the rising blob at 6³ over 2 steps, the multi-phase
diffusion in 2D (8²) and 3D (6³) over 2 steps, and Blankenbach with
particle-carried T at 8² over 2 steps.

Held: equal iteration counts, equal active masks, every grid field within
1e-10 of its family's max (velocities, pressure, stresses, temperature)
and the particle positions within 1e-10 of the domain's length.
"""

import numpy as np
import pytest
import torch

from justrelax_tpu.models import blankenbach as jblankenbach
from justrelax_tpu.models import diffusion2d_multiphase as jd2m
from justrelax_tpu.models import diffusion3d as jdiffusion3d
from justrelax_tpu.models import rising_blob3d as jblob
from justrelax_tpu.models import vankeken as jvankeken
from justrelax_tpu_torch.models import (
    blankenbach,
    diffusion2d_multiphase,
    diffusion3d,
    rising_blob3d,
    vankeken,
)

torch.set_num_threads(1)

KYR = 1.0e3 * 3600 * 24 * 365.25


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close_family(pairs, tol=1e-10):
    """Each port array of (port, JAX) ``pairs`` within ``tol`` of the
    family's max |JAX value|."""
    scale = max(np.abs(_np(j)).max() for _, j in pairs)
    for p, j in pairs:
        assert _np(p).shape == _np(j).shape
        assert np.abs(_np(p) - _np(j)).max() <= tol * scale


def same_particles(p, j, length, axes=("px", "py")):
    """Equal active masks and slot counts; positions within 1e-10 of the
    domain's ``length``."""
    assert np.array_equal(_np(p.active), _np(j.active))
    assert (p.min_xcell, p.nxcell, p.max_xcell) == (j.min_xcell, j.nxcell, j.max_xcell)
    for a in axes:
        assert np.abs(_np(getattr(p, a)) - _np(getattr(j, a))).max() <= 1e-10 * length


def same_info(p, j):
    assert int(p.iters) == int(j.iters) > 0


def same_stokes(p, j):
    close_family([(a, getattr(j.V, k)) for k in ("Vx", "Vy", "Vz")
                  if (a := getattr(p.V, k)) is not None])
    close_family([(p.P, j.P)])
    close_family([(getattr(p.tau, k), getattr(j.tau, k)) for k in ("xx", "yy", "xy")])


def test_vankeken_matches_jax():
    kw = dict(nx=10, ny=10, nt=2, nxcell=12, max_xcell=24, min_xcell=6)
    p_urms, p_info, p_st, p_par, p_ph = vankeken.run(**kw, device="cpu")
    j_urms, j_info, j_st, j_par, j_ph = jvankeken.run(**kw)
    same_info(p_info, j_info)
    np.testing.assert_allclose(p_urms, j_urms, rtol=1e-10)
    same_stokes(p_st, j_st)
    same_particles(p_par, j_par, 1.0)
    np.testing.assert_array_equal(_np(p_ph), _np(j_ph))
    assert int(p_par.count().min()) >= p_par.min_xcell


def test_rising_blob3d_matches_jax():
    p_st, p_par, p_ph, p_info, p_zc = rising_blob3d.run(n=6, nt=2, device="cpu")
    j_st, j_par, j_ph, j_info, j_zc = jblob.run(n=6, nt=2)
    same_info(p_info, j_info)
    same_stokes(p_st, j_st)
    same_particles(p_par, j_par, 1.0e6, ("px", "py", "pz"))
    np.testing.assert_array_equal(_np(p_ph), _np(j_ph))
    np.testing.assert_allclose(p_zc, j_zc, rtol=1e-10)
    assert p_zc[1] > p_zc[0]


def test_diffusion2d_multiphase_matches_jax():
    kw = dict(nx=8, ny=8, ttot=100 * KYR)
    p_th, p_info = diffusion2d_multiphase.run(**kw, device="cpu")
    j_th, j_info = jd2m.run(**kw)
    same_info(p_info, j_info)
    close_family([(p_th.T, j_th.T)])
    close_family([(p_th.qTx, j_th.qTx), (p_th.qTy, j_th.qTy)])


def test_diffusion3d_multiphase_matches_jax():
    kw = dict(n=6, ttot=100 * KYR)
    p_th, p_info = diffusion3d.run_multiphase(**kw, device="cpu")
    j_th, j_info = jdiffusion3d.run_multiphase(**kw)
    same_info(p_info, j_info)
    close_family([(p_th.T, j_th.T)])
    close_family([(getattr(p_th, k), getattr(j_th, k)) for k in ("qTx", "qTy", "qTz")])


def test_blankenbach_particles_matches_jax():
    p_u, p_nu, p_info, p_st, p_th = blankenbach.run_particles(nx=8, ny=8, nit=2, device="cpu")
    j_u, j_nu, j_info, j_st, j_th = jblankenbach.run_particles(nx=8, ny=8, nit=2)
    same_info(p_info, j_info)
    np.testing.assert_allclose(p_u, j_u, rtol=1e-10)
    np.testing.assert_allclose(p_nu, j_nu, rtol=1e-10)
    same_stokes(p_st, j_st)
    close_family([(p_th.T, j_th.T)])


@pytest.mark.parametrize("model", ["vankeken", "rising_blob3d", "blankenbach"])
def test_default_route_on_the_cpu_is_plain(model, monkeypatch):
    """``use_kernel=None`` resolves as on the card: the model hands the
    Stokes solver ``None``, which takes the plain path for CPU tensors and
    the kernel for CUDA ones (the kernel's wrapper is not reached here)."""
    seen = []
    mod = {"vankeken": vankeken, "rising_blob3d": rising_blob3d,
           "blankenbach": blankenbach}[model]
    name = "solve_ve_3d" if model == "rising_blob3d" else "solve_vep"
    solver = getattr(mod, name)

    def spy(*a, **k):
        seen.append(k.get("use_kernel"))
        return solver(*a, **{**k, "iter_max": 20, "nout": 10})

    monkeypatch.setattr(mod, name, spy)
    if model == "vankeken":
        vankeken.run(nx=6, ny=6, nt=1, nxcell=4, max_xcell=8, min_xcell=2, device="cpu")
    elif model == "rising_blob3d":
        rising_blob3d.run(n=4, nt=1, device="cpu")
    else:
        blankenbach.run_particles(nx=6, ny=6, nit=1, device="cpu")
    assert seen and all(v is None for v in seen)
