"""PyTorch port, 2D particles (``justrelax_tpu_torch/particles/particles.py``)
against the JAX package on the CPU in float64.

Both packages start from one particle set: the JAX one, carried across by
``convert.particles_from_dict``, advected by a divergence-free field that
moves particles across cell faces (0.8 cells per step at its fastest), with
cells thinned below ``min_xcell`` and two cells emptied. Held:

- ``init_particles``, ``advect_rk2``, ``move_particles`` (whole-grid and in
  x-slabs) and ``inject_particles`` bit for bit, inactive slots included;
- the transfers, the phase ratios and the subgrid diffusion within 1e-14 of
  each field's max.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from chip_smoke import swirl_2d
from justrelax_tpu.core.grid import Geometry as JGeometry
from justrelax_tpu.particles import particles as jp
from justrelax_tpu.rheology.materials import Material as JMaterial
from justrelax_tpu_torch import convert
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.particles import particles as pp
from justrelax_tpu_torch.rheology.materials import Material

torch.set_num_threads(1)

NI, LI, ORIGIN = (12, 10), (2.0, 1.5), (0.3, -1.0)
NXCELL, MAX_XCELL, MIN_XCELL = 6, 12, 4


def _equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy())


def _close(a, b, tol=1e-14):
    a = np.asarray(a, dtype=np.float64)
    b = b.cpu().numpy().astype(np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max(initial=0.0) <= tol * np.abs(a).max(initial=0.0)


def starve(particles, geometry, empty, seed=1):
    """Drop 45 % of the particles at random and every particle whose
    position lies in one of the cells ``empty``: cells below ``min_xcell``
    and cells with none once the particles are moved."""
    rng = np.random.default_rng(seed)
    active = np.asarray(particles.active) & (rng.random(np.shape(particles.active)) > 0.45)
    cell = tuple(np.floor((np.asarray(getattr(particles, ax)) - o) / d).astype(int)
                 for ax, o, d in zip(("px", "py", "pz"), geometry.origin, geometry.di))
    for c in empty:
        active &= ~np.logical_and.reduce([ci == k for ci, k in zip(cell, c)])
    return active


@pytest.fixture(scope="module")
def case():
    """(JAX geometry, port geometry, JAX advected particles, the same in the
    port, velocity, dt, per-particle phase and T, center T)."""
    jg, g = JGeometry(NI, LI, origin=ORIGIN), Geometry(NI, LI, origin=ORIGIN)
    p0 = jp.init_particles(jg, NXCELL, MAX_XCELL, MIN_XCELL, seed=3)
    Vx, Vy = swirl_2d(g)
    dt = 0.8 * g.di[0] / np.abs(Vx).max()
    ja = jp.advect_rk2(p0, (jnp.asarray(Vx), jnp.asarray(Vy)), jg, dt)
    ja = ja.replace(active=jnp.asarray(starve(ja, g, ((2, 3), (7, 1)))))
    rng = np.random.default_rng(7)
    phase = np.floor(rng.random(ja.px.shape) * 3.0)
    T = 300.0 + 50.0 * rng.random(ja.px.shape)
    Tc = 300.0 + 50.0 * rng.random(NI)
    d = dict(px=ja.px, py=ja.py, active=ja.active, min_xcell=MIN_XCELL, nxcell=NXCELL)
    pc = convert.particles_from_dict(d, device="cpu")
    return jg, g, p0, ja, pc, (Vx, Vy), dt, phase, T, Tc


def _moved(case, x_slab=None):
    jg, g, _, ja, pc, _, _, phase, T, _ = case
    jm, jf = jp.move_particles(ja, jg, {"phase": jnp.asarray(phase), "T": jnp.asarray(T)})
    pm, pf = pp.move_particles(pc, g, {"phase": torch.as_tensor(phase), "T": torch.as_tensor(T)},
                               x_slab=x_slab)
    return jm, jf, pm, pf


def test_init_particles_bit_equal():
    jg, g = JGeometry(NI, LI, origin=ORIGIN), Geometry(NI, LI, origin=ORIGIN)
    j = jp.init_particles(jg, 5, 9, 2, seed=11)
    p = pp.init_particles(g, 5, 9, 2, seed=11, device="cpu")
    for a, b in ((j.px, p.px), (j.py, p.py), (j.active, p.active), (j.count(), p.count())):
        _equal(a, b)
    assert (p.min_xcell, p.nxcell, p.max_xcell) == (2, 5, 9)
    assert p.px.dtype == torch.float64
    assert pp.init_particles(g, 5, 9, 2, seed=11, dtype=torch.float32,
                             device="cpu").px.dtype == torch.float32


def test_advect_rk2_bit_equal(case):
    jg, g, p0, *_ = case
    Vx, Vy = case[5]
    dt = case[6]
    j = jp.advect_rk2(p0, (jnp.asarray(Vx), jnp.asarray(Vy)), jg, dt)
    pc = convert.particles_from_dict(dict(px=p0.px, py=p0.py, active=p0.active), device="cpu")
    p = pp.advect_rk2(pc, (torch.as_tensor(Vx), torch.as_tensor(Vy)), g, dt)
    _equal(j.px, p.px)
    _equal(j.py, p.py)
    # the field carries particles across cell faces
    ci = np.floor((np.asarray(j.px) - ORIGIN[0]) / g.di[0])
    assert (ci != np.arange(NI[0])[:, None, None]).any()


@pytest.mark.parametrize("x_slab", [None, 1, 5, 12])
def test_move_particles_bit_equal(case, x_slab):
    jm, jf, pm, pf = _moved(case, x_slab)
    for a, b in ((jm.px, pm.px), (jm.py, pm.py), (jm.active, pm.active),
                 (jf["phase"], pf["phase"]), (jf["T"], pf["T"])):
        _equal(a, b)
    assert (pm.min_xcell, pm.nxcell) == (MIN_XCELL, NXCELL)
    assert int(pm.count().min()) == 0 and int(pm.count().max()) > NXCELL


def test_move_slabs_equal_whole_grid(case):
    """A slab boundary cuts the 3×3 neighbourhoods; each slab width gives the
    whole-grid slots bit for bit."""
    _, _, whole, wf = _moved(case)
    for width in (1, 2, 3, 7):
        _, _, pm, pf = _moved(case, width)
        for a, b in ((whole.px, pm.px), (whole.py, pm.py), (whole.active, pm.active),
                     (wf["phase"], pf["phase"]), (wf["T"], pf["T"])):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="x_slab"):
        _moved(case, 0)


@pytest.mark.parametrize("phases", ["int", "field", "none"])
def test_inject_particles_bit_equal(case, phases):
    jg, g, *_ = case
    Tc = case[9]
    jm, jf, pm, pf = _moved(case)
    cell_phase = np.tile(np.arange(NI[1]) % 3, (NI[0], 1)).astype(float)
    jph = {"int": 3, "field": jnp.asarray(cell_phase), "none": None}[phases]
    pph = {"int": 3, "field": torch.as_tensor(cell_phase), "none": None}[phases]
    ji, jfi = jp.inject_particles(jm, jg, {"T": jnp.asarray(Tc)}, phases=jph, fields=jf)
    pi, pfi = pp.inject_particles(pm, g, {"T": torch.as_tensor(Tc)}, phases=pph, fields=pf)
    for a, b in ((ji.px, pi.px), (ji.py, pi.py), (ji.active, pi.active),
                 (jfi["phase"], pfi["phase"]), (jfi["T"], pfi["T"])):
        _equal(a, b)
    assert int(pi.count().min()) >= MIN_XCELL
    if phases == "field":  # the emptied cells take the cell field's phase
        assert float(pfi["phase"][2, 3][pi.active[2, 3]].max()) == cell_phase[2, 3]


def test_inject_argmax_tie_takes_first_phase():
    """A cell whose survivors tie between phases 1 and 2 fills with phase 1,
    as jnp.argmax and torch.argmax take the first maximum."""
    jg, g = JGeometry((2, 2), (1.0, 1.0)), Geometry((2, 2), (1.0, 1.0))
    j0 = jp.init_particles(jg, 4, 8, 6, seed=0)
    active = np.zeros((2, 2, 8), bool)
    active[..., :4] = True
    phase = np.zeros((2, 2, 8))
    phase[0, 0, :4] = [2.0, 1.0, 2.0, 1.0]
    phase[1, 1, :4] = [0.0, 2.0, 0.0, 2.0]
    j0 = jp.Particles(px=j0.px, py=j0.py, active=jnp.asarray(active), min_xcell=6, nxcell=8)
    p0 = convert.particles_from_dict(dict(px=j0.px, py=j0.py, active=active, min_xcell=6,
                                          nxcell=8), device="cpu")
    ji, jf = jp.inject_particles(j0, jg, {}, phases=3, fields={"phase": jnp.asarray(phase)})
    pi, pf = pp.inject_particles(p0, g, {}, phases=3, fields={"phase": torch.as_tensor(phase)})
    _equal(jf["phase"], pf["phase"])
    _equal(ji.active, pi.active)
    assert (pf["phase"][0, 0, 4:] == 1.0).all() and (pf["phase"][1, 1, 4:] == 0.0).all()


def test_transfers_match_jax(case):
    jg, g, _, _, _, _, _, _, T, Tc = case
    jm, jf, pm, pf = _moved(case)
    rng = np.random.default_rng(5)
    vert = rng.random((NI[0] + 1, NI[1] + 1))
    ghost = rng.random((NI[0] + 2, NI[1] + 2))
    _close(jp.particle2grid(jf["T"], jm, jg), pp.particle2grid(pf["T"], pm, g))
    _close(jp.particle2centroid(jf["T"], jm, jg), pp.particle2centroid(pf["T"], pm, g))
    _equal(jp.grid2particle(jnp.asarray(vert), jm, jg),
           pp.grid2particle(torch.as_tensor(vert), pm, g))
    for center in (Tc, ghost):
        _equal(jp.centroid2particle(jnp.asarray(center), jm, jg),
               pp.centroid2particle(torch.as_tensor(center), pm, g))


def test_phase_ratios_match_jax(case):
    jg, g = case[0], case[1]
    jm, jf, pm, pf = _moved(case)
    jc, jv = jp.phase_ratios_from_particles(jm, jf["phase"], 3, jg)
    pc, pv = pp.phase_ratios_from_particles(pm, pf["phase"], 3, g)
    _close(jc, pc)
    _close(jv, pv)
    # empty cells have no center ratio; every vertex is a partition of one
    assert float(pc[2, 3].sum()) == 0.0
    assert torch.allclose(pv.sum(-1), torch.ones(()).double())


def test_subgrid_diffusion_matches_jax(case):
    jg, g = case[0], case[1]
    jm, jf, pm, pf = _moved(case)
    rng = np.random.default_rng(9)
    T = 300.0 + 100.0 * rng.random((NI[0] + 2, NI[1] + 2))
    dT = 5.0 * rng.random((NI[0] + 2, NI[1] + 2))
    P = rng.random(NI)
    kw = dict(rho0=3.3e3, alpha=2e-5, Cp=1.1e3, k=3.0)
    jdt0 = jp.subgrid_characteristic_time(JMaterial(**kw), jnp.asarray(T[1:-1, 1:-1]),
                                          jnp.asarray(P), None, g.di)
    pdt0 = pp.subgrid_characteristic_time(Material(**kw), torch.as_tensor(T[1:-1, 1:-1]),
                                          torch.as_tensor(P), None, g.di)
    _close(jdt0, pdt0)
    dt = 0.3 * float(np.asarray(jdt0).min())
    for Tg, dTg in ((T, dT), (T[1:-1, 1:-1], dT[1:-1, 1:-1])):  # ghosted and plain
        j = jp.subgrid_diffusion(jf["T"], jnp.asarray(Tg), jnp.asarray(dTg), jdt0, jm, jg, dt)
        p = pp.subgrid_diffusion(pf["T"], torch.as_tensor(Tg), torch.as_tensor(dTg), pdt0,
                                 pm, g, dt)
        _close(j, p)
