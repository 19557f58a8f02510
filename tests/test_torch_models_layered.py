"""PyTorch port, the layered-convection particle models against the JAX
package on the CPU in float64, with the JAX model's arguments at a small
size: the nondimensional 2D model at 8² over 1 step and the 3D model at 6³
over 2 steps. Held as tests/test_torch_models_particles.py holds its
models: equal iterations and active masks, grid fields within 1e-10 of
their family's max, positions within 1e-10 of the domain's length.

The 3D model's first Stokes solve runs to its 20 000-iteration cap at 6³,
about three minutes of the port's serial 3D VEP iteration on one CPU
thread: the full run is ``slow`` (phase 33 of chip_smoke.py runs the JAX
test's 12³ golden on the card), and the default run holds both packages
with every Stokes solve capped at 500 iterations alike.
"""

import numpy as np
import pytest
import torch

from justrelax_tpu.models import layered_convection3d as jl3d
from justrelax_tpu.models import layered_convection_nondim as jlnd
from justrelax_tpu_torch.models import layered_convection3d, layered_convection_nondim
from justrelax_tpu_torch.ops.hopper_stokes_vep import vep_chunk_supported
from justrelax_tpu_torch.rheology.materials import MaterialStack
from justrelax_tpu_torch.solvers.stokes3d_vep import _visc_exponent
from test_torch_models_particles import close_family, same_info, same_particles, same_stokes

torch.set_num_threads(1)

KW2 = dict(nx=8, ny=8, nt=1, nxcell=6, max_xcell=12, min_xcell=3)
KW3 = dict(nx=6, ny=6, nz=6, nt=2, nxcell=6, max_xcell=12, min_xcell=3)


def test_layered_convection_nondim_matches_jax():
    p = layered_convection_nondim.run(**KW2, device="cpu")
    j = jlnd.run(**KW2)
    (p_st, p_th, p_par, p_ph, p_info, p_u, p_vmax) = p
    (j_st, j_th, j_par, j_ph, j_info, j_u, j_vmax) = j
    same_info(p_info, j_info)
    same_stokes(p_st, j_st)
    close_family([(p_st.viscosity.eta, j_st.viscosity.eta)])
    close_family([(p_th.T, j_th.T)])
    same_particles(p_par, j_par, 110.0e3 / 40.0e3)  # the nondimensional height
    np.testing.assert_array_equal(p_ph.numpy(), np.asarray(j_ph))
    np.testing.assert_allclose(p_vmax, j_vmax, rtol=1e-10)


def _compare_3d(p, j):
    (p_st, p_th, p_par, p_ph, p_info, p_vmax) = p
    (j_st, j_th, j_par, j_ph, j_info, j_vmax) = j
    same_info(p_info, j_info)
    same_stokes(p_st, j_st)
    close_family([(getattr(p_st.tau, k), getattr(j_st.tau, k)) for k in ("zz", "yz", "xz")])
    close_family([(p_th.T, j_th.T)])
    same_particles(p_par, j_par, 110.0e3, ("px", "py", "pz"))
    np.testing.assert_array_equal(p_ph.numpy(), np.asarray(j_ph))
    np.testing.assert_allclose(p_vmax, j_vmax, rtol=1e-10)


def test_layered_convection3d_capped_matches_jax(monkeypatch):
    """Both packages' Stokes solves capped at 500 iterations alike."""
    for mod in (jl3d, layered_convection3d):
        solve = mod.solve_vep_3d
        monkeypatch.setattr(mod, "solve_vep_3d",
                            lambda *a, solve=solve, **k: solve(*a, **{**k, "iter_max": 500}))
    _compare_3d(layered_convection3d.run(**KW3, device="cpu"), jl3d.run(**KW3))


@pytest.mark.slow
def test_layered_convection3d_matches_jax():
    _compare_3d(layered_convection3d.run(**KW3, device="cpu"), jl3d.run(**KW3))


def test_layered_creep_tables_are_plain_by_contract():
    """The models pass ``use_kernel=False`` to their Stokes solves because
    their creep tables mix stress exponents: the 2D VEP chunk kernel and the
    3D kernel routes refuse such a table."""
    s = layered_convection_nondim._setup(4, 4, 2, 4, 1, None, "cpu")
    assert not vep_chunk_supported(s.material, s.geometry, s.flow_bc, False)
    assert isinstance(s.material, MaterialStack)
    with pytest.raises(ValueError, match="shared-exponent"):
        _visc_exponent(s.material)
