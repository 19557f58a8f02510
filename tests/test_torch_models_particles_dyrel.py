"""PyTorch port, the particle-coupled DYREL models against the JAX package
on the CPU in float64, with the JAX model's arguments at a small size: the
nondimensional layered convection at 8² over one step and the sticky-air
subduction at 16×8 over two. Held as tests/test_torch_models_particles.py
holds its models: equal DR iterations and active masks, grid fields within
1e-10 of their family's max, positions within 1e-10 of the domain's
length; and the subduction's diagnostics (slab tip, slab center of mass)
within 1e-10.
"""

import numpy as np
import torch

from justrelax_tpu.models import layered_convection_dyrel as jlcd
from justrelax_tpu.models import subduction2d_dyrel as jsub
from justrelax_tpu_torch.models import layered_convection_dyrel, subduction2d_dyrel
from test_torch_models_particles import close_family, same_info, same_particles, same_stokes

torch.set_num_threads(1)


def test_layered_convection_dyrel_matches_jax():
    kw = dict(nx=8, ny=8, nt=1, nxcell=6, max_xcell=12, min_xcell=3)
    p_st, p_th, p_par, p_ph, p_info, _, p_vmax = layered_convection_dyrel.run(**kw, device="cpu")
    j_st, j_th, j_par, j_ph, j_info, _, j_vmax = jlcd.run(**kw)
    same_info(p_info, j_info)
    same_stokes(p_st, j_st)
    close_family([(p_st.viscosity.eta, j_st.viscosity.eta)])
    close_family([(p_th.T, j_th.T)])
    same_particles(p_par, j_par, 110.0e3 / 40.0e3)
    np.testing.assert_array_equal(p_ph.numpy(), np.asarray(j_ph))
    np.testing.assert_allclose(p_vmax, j_vmax, rtol=1e-10)


def test_subduction2d_dyrel_matches_jax():
    kw = dict(nx=16, ny=8, nt=2)
    p_st, p_par, p_ph, p_prc, p_info, p_tip, p_aux = subduction2d_dyrel.run(**kw, device="cpu")
    j_st, j_par, j_ph, j_prc, j_info, j_tip, j_aux = jsub.run(**kw)
    same_info(p_info, j_info)
    same_stokes(p_st, j_st)
    close_family([(p_prc, j_prc)])
    for k in ("rho_gy", "eta", "eta_v"):
        close_family([(p_aux[k], j_aux[k])])
    same_particles(p_par, j_par, 3.0e6)
    np.testing.assert_array_equal(p_ph.numpy(), np.asarray(j_ph))
    np.testing.assert_allclose(p_tip, j_tip, rtol=1e-10)
    np.testing.assert_allclose(p_aux["ycm_hist"], j_aux["ycm_hist"], rtol=1e-10)
