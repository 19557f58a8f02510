"""PyTorch port, ``subduction2d.run_particles`` (the particle-transport
subduction with checkpoints and restart) on the CPU in float64: against the
JAX model at JAX's 48×16 over 2 steps, both packages' Stokes solves capped
alike by a wrapper of the model's ``solve_variational`` (equal iterations,
equal active masks and phases, grid fields within 1e-10 of their family's
max, particle positions within 1e-10 of the domain's length); a restart
from a step-1 checkpoint bit for bit equal to the straight run; and, as a
``slow`` test, tests/test_subduction2d.py's restart equivalence at 48×16
over 4 steps with the model's own caps."""

import os

import numpy as np
import pytest
import torch

from chip_smoke import PARTICLES_RESTART, particles_run_diffs
from justrelax_tpu.models import subduction2d as jsub2d
from justrelax_tpu_torch.io.checkpoint import load_checkpoint_particles
from justrelax_tpu_torch.models import subduction2d
from test_torch_models_particles import _np, close_family, same_info, same_particles, same_stokes
from test_torch_models_variational import capped

torch.set_num_threads(1)

CAP = dict(iter_max=1_000, nout=500)
LENGTH = 3000.0e3


def test_run_particles_matches_jax(monkeypatch):
    capped(monkeypatch, (subduction2d, jsub2d), "solve_variational", **CAP)
    p_st, p_th, p_par, (p_ph, p_T), p_info = subduction2d.run_particles(
        **PARTICLES_RESTART, nt=2, device="cpu")
    j_st, j_th, j_par, (j_ph, j_T), j_info = jsub2d.run_particles(**PARTICLES_RESTART, nt=2)
    same_info(p_info, j_info)
    same_stokes(p_st, j_st)
    close_family([(p_th.T, j_th.T)])
    same_particles(p_par, j_par, LENGTH)
    assert p_ph.dtype == torch.float64
    np.testing.assert_array_equal(_np(p_ph), _np(j_ph))
    close_family([(p_T, j_T)])


def test_run_particles_restart_bitwise(tmp_path, monkeypatch):
    """Two steps straight equal, bit for bit, one step with a checkpoint
    and a restart from it; the restart's own step-2 checkpoint holds its
    returned particles."""
    capped(monkeypatch, (subduction2d,), "solve_variational", **CAP)
    first, second = str(tmp_path / "step1"), str(tmp_path / "step2")
    straight = subduction2d.run_particles(**PARTICLES_RESTART, nt=2, device="cpu")
    subduction2d.run_particles(**PARTICLES_RESTART, nt=1, out_dir=first, checkpoint_every=1,
                               device="cpu")
    restarted = subduction2d.run_particles(**PARTICLES_RESTART, nt=2, restart_from=first,
                                           out_dir=second, checkpoint_every=1, device="cpu")
    assert int(straight[4].iters) == int(restarted[4].iters)
    diffs = particles_run_diffs(straight, restarted)
    assert max(diffs.values()) == 0.0, diffs

    particles, fields, t, dt, it = load_checkpoint_particles(
        os.path.join(second, "particles.npz"), device="cpu")
    assert it == 2 and t > dt > 0
    for k in ("px", "py", "active"):
        assert torch.equal(getattr(particles, k), getattr(restarted[2], k))
    assert torch.equal(fields["phase"], restarted[3][0])
    assert torch.equal(fields["T"], restarted[3][1])


@pytest.mark.slow
def test_run_particles_restart_equivalence_full(tmp_path):
    """tests/test_subduction2d.py::test_subduction2d_particles_restart_equivalence
    on the port, with the model's own caps: a 2-step run checkpointing at
    step 2, a restart from it to step 4, a straight 4-step run equal to the
    restart bit for bit (EII_pl is NaN in every cell, as in the JAX model,
    and compared by its bits), and the JAX test's frozen slab descent
    rates."""
    d_full, d_restart = str(tmp_path / "full"), str(tmp_path / "restart")
    s2, _, _, _, info2 = subduction2d.run_particles(
        **PARTICLES_RESTART, nt=2, out_dir=d_full, checkpoint_every=2, device="cpu")
    assert float(info2.err) < 1.0e-4
    s4, th4, p4, (ph4, pT4), info4 = subduction2d.run_particles(
        **PARTICLES_RESTART, nt=4, out_dir=d_restart, checkpoint_every=2, restart_from=d_full,
        device="cpu")
    assert float(info4.err) < 1.0e-4
    pr, pf, _, _, it4 = load_checkpoint_particles(os.path.join(d_restart, "particles.npz"),
                                                  device="cpu")
    assert it4 == 4
    assert torch.equal(pr.px, p4.px) and torch.equal(pf["T"], pT4)

    straight = subduction2d.run_particles(**PARTICLES_RESTART, nt=4, device="cpu")
    diffs = particles_run_diffs(straight, (s4, th4, p4, (ph4, pT4), info4))
    assert max(diffs.values()) == 0.0, diffs

    yr = 3.15576e7
    assert float(s2.V.Vy.min()) * 100 * yr == pytest.approx(-4.1227, rel=2e-2)
    assert float(s4.V.Vy.min()) * 100 * yr == pytest.approx(-5.6428, rel=2e-2)
    assert bool(torch.isfinite(s4.V.Vy).all())
