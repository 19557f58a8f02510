"""PyTorch port, solve → checkpoint → restore → solve against an
uninterrupted run, the counterparts of tests/test_restart_equivalence.py on
the CPU: the JAX test's 16² VE time loop (pure shear of a Maxwell body)
checkpointed after 2 of 4 steps, reloaded into fresh states and continued,
bit for bit equal to never stopping (the checkpoint holds all the state
carried across steps: τ_o, P, V), and the uninterrupted run against the JAX
package's within 1e-10 with equal iterations; and the float32 loop's
residual floor and its Maxwell curve. The set-up is ``chip_smoke.py``'s
phase 41 (``ve_restart_setup``), which runs it through B1/B4 on the card."""

import dataclasses

import numpy as np
import torch
from flax import serialization
from test_restart_equivalence import _setup as jax_setup
from test_restart_equivalence import _step as jax_step

from chip_smoke import (
    VE_RESTART_DT,
    bit_equal,
    flat_state,
    ve_restart,
    ve_restart_setup,
    ve_restart_step,
)
from justrelax_tpu_torch import convert
from justrelax_tpu_torch.models.elastic_buildup import KYR, analytic_solution
from test_torch_models_particles import close_family

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif v is not None:
            out[prefix + k] = np.asarray(v)
    return out


def test_solve_restart_solve_bitwise(tmp_path):
    straight, restarted, it_straight, it_restarted, t, dt = ve_restart(CPU, str(tmp_path))
    assert (t, dt) == (2 * VE_RESTART_DT, VE_RESTART_DT) == (2 * 0.05 * KYR, 0.05 * KYR)
    assert it_straight == it_restarted
    for name, a, b in flat_state(straight, restarted):
        assert bit_equal(a, b), name

    # the uninterrupted run against the JAX package's: equal iterations, each
    # field within 1e-10 of its family's max (velocities; pressure with the
    # stresses, the pressure of pure shear being rounding; strain rates)
    js, *jproblem, _ = jax_setup()
    for n in it_straight:
        js, info = jax_step(js, *jproblem)
        assert int(info.iters) == n
    port, ref = _flat(convert.to_state_dict(straight)), _flat(serialization.to_state_dict(js))
    assert set(port) == set(ref)
    stresses = ["P"] + [f"{t}.{c}" for t in ("tau", "tau_o") for c in ("xx", "yy", "xy", "xy_c")]
    for family in (["V.Vx", "V.Vy"], stresses, [f"eps.{c}" for c in ("xx", "yy", "xy", "II")]):
        close_family([(port[k], ref[k]) for k in family])


def test_f32_ve_solver_behavior():
    """float32 end to end: the residual stalls near its f32 floor (the JAX
    test pins < 5e-4) and τyy follows the analytic Maxwell curve within 1 %
    after 5 steps. The f32 residual sits at its floor (2.1–2.7e-4) from the
    first 500-iteration chunk on, so no step reaches eps 1e-5 and each runs
    to its cap: here 1 000 iterations a step, 20 000 in the JAX test (on the
    card, tests/test_torch_cuda.py::test_ve_restart_setup_f32_on_the_card
    runs that cap through B1/B4)."""
    stokes, pt, *problem, (eta0, G, eps_bg) = ve_restart_setup(torch.float32, CPU)
    assert stokes.P.dtype == torch.float32
    pt = dataclasses.replace(pt, eps_abs=1.0e-5, eps_rel=1.0e-5)
    t = 0.0
    for _ in range(5):
        stokes, info = ve_restart_step(stokes, pt, *problem, iter_max=1_000)
        t += VE_RESTART_DT
    assert stokes.tau.yy.dtype == torch.float32
    assert np.isfinite(float(info.err))
    assert float(info.err) < 5.0e-4
    got = float(stokes.tau.yy.abs().max())
    want = analytic_solution(eps_bg, t, G, eta0)
    assert abs(got - want) / want < 1.0e-2
