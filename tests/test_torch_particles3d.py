"""PyTorch port, 3D particles (``justrelax_tpu_torch/particles/particles3d.py``)
against the JAX package on the CPU in float64, as tests/test_torch_particles.py
holds the 2D module: one JAX particle set carried across, advected by a
divergence-free field across cell faces, thinned and with two cells emptied;
init, advection, the move (whole-grid and in x-slabs) and injection bit for
bit, the transfers and phase ratios within 1e-14 of each field's max.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from justrelax_tpu.core.grid import Geometry as JGeometry
from justrelax_tpu.particles import particles3d as jp
from justrelax_tpu_torch import convert
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.particles import particles3d as pp
from chip_smoke import swirl_3d
from test_torch_particles import _close, _equal, starve

torch.set_num_threads(1)

NI, LI, ORIGIN = (6, 5, 4), (1.2, 1.0, 0.9), (0.0, 0.2, -0.9)
NXCELL, MAX_XCELL, MIN_XCELL = 6, 10, 4
AXES = ("px", "py", "pz")


@pytest.fixture(scope="module")
def case():
    jg, g = JGeometry(NI, LI, origin=ORIGIN), Geometry(NI, LI, origin=ORIGIN)
    p0 = jp.init_particles_3d(jg, NXCELL, MAX_XCELL, MIN_XCELL, seed=4)
    V = swirl_3d(g)
    dt = 0.8 * min(g.di) / max(np.abs(v).max() for v in V)
    ja = jp.advect_rk2_3d(p0, tuple(jnp.asarray(v) for v in V), jg, dt)
    ja = ja.replace(active=jnp.asarray(starve(ja, g, ((1, 2, 1), (4, 0, 3)))))
    rng = np.random.default_rng(8)
    phase = np.floor(rng.random(ja.px.shape) * 3.0)
    T = 300.0 + 50.0 * rng.random(ja.px.shape)
    d = dict(px=ja.px, py=ja.py, pz=ja.pz, active=ja.active, min_xcell=MIN_XCELL,
             nxcell=NXCELL)
    return jg, g, p0, ja, convert.particles_from_dict(d, device="cpu"), V, dt, phase, T


def _moved(case, x_slab=None):
    jg, g, _, ja, pc, _, _, phase, T = case
    jm, jf = jp.move_particles_3d(ja, jg, {"phase": jnp.asarray(phase), "T": jnp.asarray(T)})
    pm, pf = pp.move_particles_3d(pc, g, {"phase": torch.as_tensor(phase),
                                          "T": torch.as_tensor(T)}, x_slab=x_slab)
    return jm, jf, pm, pf


def _pairs(j, p, jf=None, pf=None):
    out = [(getattr(j, a), getattr(p, a)) for a in AXES + ("active",)]
    if jf is not None:
        out += [(jf[k], pf[k]) for k in jf]
    return out


def test_init_particles_3d_bit_equal():
    jg, g = JGeometry(NI, LI, origin=ORIGIN), Geometry(NI, LI, origin=ORIGIN)
    j = jp.init_particles_3d(jg, 5, 9, 2, seed=11)
    p = pp.init_particles_3d(g, 5, 9, 2, seed=11, device="cpu")
    for a, b in _pairs(j, p) + [(j.count(), p.count())]:
        _equal(a, b)
    assert (p.min_xcell, p.nxcell, p.max_xcell) == (2, 5, 9)


def test_advect_rk2_3d_bit_equal(case):
    jg, g, p0, _, _, V, dt, *_ = case
    j = jp.advect_rk2_3d(p0, tuple(jnp.asarray(v) for v in V), jg, dt)
    pc = convert.particles_from_dict({a: getattr(p0, a) for a in AXES + ("active",)},
                                     device="cpu")
    p = pp.advect_rk2_3d(pc, tuple(torch.as_tensor(v) for v in V), g, dt)
    for a, b in _pairs(j, p):
        _equal(a, b)
    moved = [np.floor((np.asarray(getattr(j, a)) - o) / d) != np.arange(n).reshape(
        [n if k == ax else 1 for k in range(3)] + [1])
        for ax, (a, o, d, n) in enumerate(zip(AXES, ORIGIN, g.di, NI))]
    assert all(m.any() for m in moved)


@pytest.mark.parametrize("x_slab", [None, 1, 4])
def test_move_particles_3d_bit_equal(case, x_slab):
    jm, jf, pm, pf = _moved(case, x_slab)
    for a, b in _pairs(jm, pm, jf, pf):
        _equal(a, b)
    assert int(pm.count().min()) == 0


def test_move_3d_slabs_equal_whole_grid(case):
    """A slab boundary cuts the 27-cell neighbourhoods; each width gives the
    whole-grid slots bit for bit."""
    _, _, whole, wf = _moved(case)
    for width in (1, 2, 5):
        _, _, pm, pf = _moved(case, width)
        for a, b in _pairs(whole, pm, wf, pf):
            assert torch.equal(a, b)


@pytest.mark.parametrize("phases", [3, None])
def test_inject_particles_3d_bit_equal(case, phases):
    jg, g = case[0], case[1]
    jm, jf, pm, pf = _moved(case)
    Tc = 300.0 + np.arange(np.prod(NI), dtype=float).reshape(NI)
    ji, jfi = jp.inject_particles_3d(jm, jg, {"T": jnp.asarray(Tc)}, phases=phases, fields=jf)
    pi, pfi = pp.inject_particles_3d(pm, g, {"T": torch.as_tensor(Tc)}, phases=phases,
                                     fields=pf)
    for a, b in _pairs(ji, pi, jfi, pfi):
        _equal(a, b)
    assert int(pi.count().min()) >= MIN_XCELL


def test_inject_3d_rounds_half_to_even():
    """3D compares round(phase): 1.5 and 2.5 both count as phase 2 (half to
    even, jnp.round and torch.round alike), so the survivors' 2 wins."""
    jg, g = JGeometry((1, 1, 1), (1.0, 1.0, 1.0)), Geometry((1, 1, 1), (1.0, 1.0, 1.0))
    j0 = jp.init_particles_3d(jg, 3, 6, 5, seed=0)
    j0 = jp.Particles3D(px=j0.px, py=j0.py, pz=j0.pz, active=j0.active, min_xcell=5, nxcell=6)
    phase = np.array([[[[1.5, 2.5, 1.0, 0.0, 0.0, 0.0]]]])
    p0 = convert.particles_from_dict({**{a: getattr(j0, a) for a in AXES + ("active",)},
                                      "min_xcell": 5, "nxcell": 6}, device="cpu")
    _, jf = jp.inject_particles_3d(j0, jg, {}, phases=3, fields={"phase": jnp.asarray(phase)})
    _, pf = pp.inject_particles_3d(p0, g, {}, phases=3, fields={"phase": torch.as_tensor(phase)})
    _equal(jf["phase"], pf["phase"])
    assert (pf["phase"][..., 3:] == 2.0).all()


def test_transfers_3d_match_jax(case):
    jg, g = case[0], case[1]
    jm, jf, pm, pf = _moved(case)
    rng = np.random.default_rng(6)
    vert = rng.random(tuple(n + 1 for n in NI))
    center = rng.random(NI)
    _close(jp.particle2grid_3d(jf["T"], jm, jg), pp.particle2grid_3d(pf["T"], pm, g))
    _close(jp.particle2centroid_3d(jf["T"], jm, jg), pp.particle2centroid_3d(pf["T"], pm, g))
    _equal(jp.grid2particle_3d(jnp.asarray(vert), jm, jg),
           pp.grid2particle_3d(torch.as_tensor(vert), pm, g))
    _equal(jp.centroid2particle_3d(jnp.asarray(center), jm, jg),
           pp.centroid2particle_3d(torch.as_tensor(center), pm, g))


def test_phase_ratios_3d_match_jax(case):
    jg, g = case[0], case[1]
    jm, jf, pm, pf = _moved(case)
    jc, jv = jp.phase_ratios_from_particles_3d(jm, jf["phase"], 3, jg)
    pc, pv = pp.phase_ratios_from_particles_3d(pm, pf["phase"], 3, g)
    _close(jc, pc)
    _close(jv, pv)
    assert float(pc[1, 2, 1].sum()) == 0.0
