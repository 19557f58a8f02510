"""PyTorch port, the marker chain (``justrelax_tpu_torch/particles/
marker_chain.py``) against the JAX package on the CPU in float64: the
port's ``interp`` against ``jnp.interp`` (inside, on the nodes, outside on
both sides, repeated nodes) within 1e-15 of the values' max, and the
chain's advection within 1e-14 of the domain height: XLA contracts
``fp[i-1] + (delta/dx)·df`` into one fused multiply-add on the CPU, which
PyTorch's separate operations round twice. The initial chain, the
topography correction and the phase field are held bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from justrelax_tpu.core.grid import Geometry as JGeometry
from justrelax_tpu.particles import marker_chain as jmc
from justrelax_tpu.particles import particles as jp
from justrelax_tpu_torch import convert
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.particles import marker_chain as pmc
from chip_smoke import swirl_2d
from test_torch_particles import _close, _equal

torch.set_num_threads(1)

NI, LI, ORIGIN = (10, 8), (2.0, 1.0), (0.0, -0.7)


def test_interp_matches_jnp_interp():
    rng = np.random.default_rng(0)
    xp = np.sort(rng.random(17)) * 3.0 - 1.0
    xp[5] = xp[6]  # a repeated node: jnp.interp's zero-width segment
    fp = rng.standard_normal(17)
    x = np.concatenate([rng.random(200) * 5.0 - 2.0,  # inside and outside both ends
                        xp, [xp[0] - 1e-300, xp[-1] + 1e-12, -np.inf, np.inf]])
    j = jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp))
    p = pmc.interp(torch.as_tensor(x), torch.as_tensor(xp), torch.as_tensor(fp))
    _close(j, p, 1e-15)
    # on the nodes and outside the range no product is formed: bit for bit
    _equal(j[200:], p[200:])
    assert float(p[-2]) == fp[0] and float(p[-1]) == fp[-1]
    # 2D query points, as the topography correction passes particle arrays
    x2 = x[:200].reshape(10, 20)
    _close(jnp.interp(jnp.asarray(x2), jnp.asarray(xp), jnp.asarray(fp)),
           pmc.interp(torch.as_tensor(x2), torch.as_tensor(xp), torch.as_tensor(fp)), 1e-15)


@pytest.fixture(scope="module")
def chains():
    jg, g = JGeometry(NI, LI, origin=ORIGIN), Geometry(NI, LI, origin=ORIGIN)

    def height(x):
        return -0.2 + 0.08 * np.cos(2.0 * np.pi * x / LI[0])

    jc = jmc.init_marker_chain(jg, height, n_per_cell=3)
    pc = pmc.init_marker_chain(g, height, n_per_cell=3, device="cpu")
    return jg, g, jc, pc


def test_init_marker_chain_bit_equal(chains):
    jg, g, jc, pc = chains
    _equal(jc.x, pc.x)
    _equal(jc.y, pc.y)
    flat = pmc.init_marker_chain(g, -0.3, device="cpu")
    _equal(jmc.init_marker_chain(jg, -0.3).y, flat.y)
    moved = convert.marker_chain_from_dict(jc._asdict(), device="cpu")
    _equal(jc.y, moved.y)


def test_advect_marker_chain_bit_equal(chains):
    jg, g, jc, pc = chains
    Vx, Vy = swirl_2d(g, amplitude=0.4)
    dt = 0.9 * g.di[0] / np.abs(Vx).max()
    j, p = jc, pc
    for _ in range(3):
        j = jmc.advect_marker_chain(j, (jnp.asarray(Vx), jnp.asarray(Vy)), jg, dt)
        p = pmc.advect_marker_chain(p, (torch.as_tensor(Vx), torch.as_tensor(Vy)), g, dt)
        _equal(j.x, p.x)
        assert np.abs(np.asarray(j.y) - p.y.numpy()).max() <= 1e-14 * LI[1]
    assert not np.array_equal(np.asarray(j.y), np.asarray(jc.y))


def test_topography_correction_bit_equal(chains):
    jg, g, jc, pc = chains
    jpar = jp.init_particles(jg, 6, 10, 3, seed=2)
    ppar = convert.particles_from_dict(dict(px=jpar.px, py=jpar.py, active=jpar.active,
                                            min_xcell=3, nxcell=6), device="cpu")
    rng = np.random.default_rng(3)
    # phases that disagree with the chain here and there: air is 2
    h = np.interp(np.asarray(jpar.px), np.asarray(jc.x), np.asarray(jc.y))
    phase = np.where(np.asarray(jpar.py) > h, 2.0, 0.0)
    flip = rng.random(phase.shape) < 0.1
    phase = np.where(flip, 2.0 - phase, phase)
    jn, jbad = jmc.update_phases_given_markerchain(jc, jpar, jnp.asarray(phase), 2)
    pn, pbad = pmc.update_phases_given_markerchain(pc, ppar, torch.as_tensor(phase), 2)
    _equal(jn.active, pn.active)
    assert int(jbad) == int(pbad) > 0
    _equal(jmc.phases_from_marker_chain(jc, jg, 0, 2), pmc.phases_from_marker_chain(pc, g, 0, 2))
