"""PyTorch port, core and stencil layer: Geometry, state shapes,
PTStokesCoeffs, stencil primitives and velocity BCs against the JAX package
on the same numpy inputs, in float64. Elementwise slices and sums match to
1e-15."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from justrelax_tpu.core.coeffs import PTStokesCoeffs as JCoeffs
from justrelax_tpu.core.grid import Geometry as JGeometry
from justrelax_tpu.core.state import StokesState as JStokesState
from justrelax_tpu.ops import bc as jbc
from justrelax_tpu.ops import stencil as jst
from justrelax_tpu_torch import convert
from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.core.state import StokesState
from justrelax_tpu_torch.ops import bc
from justrelax_tpu_torch.ops import stencil as st

torch.set_num_threads(1)

TOL = 1e-15


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.max(np.abs(a - b), initial=0.0) <= tol


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("ni,li,origin", [((8, 6), (1.0, 2.0), None),
                                          ((5, 7), (3.0, 1.5), (0.0, -1.0))])
def test_geometry(ni, li, origin):
    g, j = Geometry(ni, li, origin), JGeometry(ni, li, origin)
    assert (g.ni, g.li, g.origin, g.di) == (j.ni, j.li, j.origin, j.di)
    assert (g.max_li, g.min_li, g.min_di, g.inv_di) == (j.max_li, j.min_li, j.min_di, j.inv_di)
    for a, b in zip(g.xci + g.xvi, j.xci + j.xvi):
        _close(a, b, 0.0)
    for comp_a, comp_b in zip(g.xi_vel, j.xi_vel):
        for a, b in zip(comp_a, comp_b):
            _close(a, b, 0.0)
    assert g == Geometry(ni, li, origin) and hash(g) == hash(Geometry(ni, li, origin))


def _shapes(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _shapes(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    return None if obj is None else tuple(obj.shape)


def test_state_shapes_and_replace():
    ni = (7, 5)
    port = StokesState.make(ni, device="cpu")
    jax_state = JStokesState.make(ni)

    def jshapes(obj):
        if hasattr(obj, "__dataclass_fields__"):
            return {k: jshapes(getattr(obj, k)) for k in obj.__dataclass_fields__}
        return None if obj is None else tuple(obj.shape)

    assert _shapes(port) == jshapes(jax_state)
    assert port.P.dtype == torch.float64 and port.ni == ni and port.ndim == 2
    assert float(port.viscosity.eta.min()) == 1.0
    new = port.replace(P=port.P + 1.0)
    assert float(new.P.max()) == 1.0 and float(port.P.max()) == 0.0
    f32 = StokesState.make(ni, dtype=torch.float32, device="cpu")
    assert f32.tau.xy.dtype == torch.float32


def _jshapes(obj):
    if hasattr(obj, "__dataclass_fields__"):
        return {k: _jshapes(getattr(obj, k)) for k in obj.__dataclass_fields__}
    return None if obj is None else tuple(obj.shape)


def _leaves(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_state_shapes_3d_and_convert_round_trip():
    """3D shapes equal the JAX package's, every field a tensor; a JAX 3D
    state goes to the port and back unchanged (JAX → port → JAX)."""
    ni = (5, 4, 3)
    port = StokesState.make(ni, device="cpu")
    assert _shapes(port) == _jshapes(JStokesState.make(ni))
    assert port.ni == ni and port.ndim == 3
    assert all(v is not None for v in _leaves(convert.to_state_dict(port)).values())
    assert len(port.V.components) == 3 and len(port.U.components) == 3
    assert len(port.tau.normal) == 3 and len(port.tau.shear) == 3
    assert tuple(port.tau.shear[0].shape) == (5, 5, 4)  # yz on the x-edges
    rng = np.random.default_rng(5)
    template = JStokesState.make(ni)
    d = _leaves(serialization.to_state_dict(template))
    values = {k: rng.standard_normal(v.shape) for k, v in d.items()}

    def nest(flat):
        out = {}
        for k, v in flat.items():
            node = out
            *path, leaf = k.split(".")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
        return out

    j = serialization.from_state_dict(template, nest({k: jnp.asarray(v) for k, v in values.items()}))
    p = convert.stokes_state_from_dict(serialization.to_state_dict(j), device="cpu")
    assert p.tau.yz.dtype == torch.float64 and p.V.Vz.shape == (7, 6, 4)
    back = serialization.from_state_dict(template, convert.to_state_dict(p))
    for k, v in _leaves(serialization.to_state_dict(back)).items():
        np.testing.assert_array_equal(np.asarray(v), values[k], err_msg=k)
    with pytest.raises(ValueError):
        StokesState.make((4,), device="cpu")


@pytest.mark.parametrize("kw", [dict(), dict(eps_rel=1e-8, CFL=0.75 / np.sqrt(2.1)),
                                dict(Re=5.0, r=0.5, eps_abs=1e-6)])
def test_pt_stokes_coeffs(kw):
    li, di = (1.0, 2.0), (1.0 / 32, 2.0 / 48)
    a, b = PTStokesCoeffs.make(li, di, **kw), JCoeffs.make(li, di, **kw)
    for name in ("CFL", "eps_rel", "eps_abs", "Re", "r", "Vpdtau", "theta_dtau", "etadtau"):
        assert getattr(a, name) == pytest.approx(getattr(b, name), rel=TOL, abs=0)


@pytest.fixture
def A():
    return np.random.default_rng(0).standard_normal((6, 5))


@pytest.mark.parametrize("name,args", [
    ("d_xa", (2.0,)), ("d_ya", (3.0,)), ("d_xi", (1.5,)), ("d_yi", (0.5,)),
    ("av_xa", ()), ("av_ya", ()), ("av_a", ()), ("av_vertex_to_center", ()),
    ("av_center_to_vertex", ()), ("expand_edges", ()),
])
def test_stencil_2d(A, name, args):
    _close(getattr(st, name)(_t(A), *args), getattr(jst, name)(jnp.asarray(A), *args))


@pytest.mark.parametrize("name", ["av_a", "harm_a", "expand_edges", "d_za", "av_za"])
def test_stencil_3d(name):
    A = np.random.default_rng(1).uniform(0.5, 2.0, (4, 5, 3))
    _close(getattr(st, name)(_t(A)), getattr(jst, name)(jnp.asarray(A)))


def test_harm_a_2d():
    A = np.random.default_rng(2).uniform(0.5, 2.0, (6, 5))
    _close(st.harm_a(_t(A)), jst.harm_a(jnp.asarray(A)))


@pytest.mark.parametrize("window", [1, 2])
def test_maxloc(A, window):
    _close(st.maxloc(_t(A), window), jst.maxloc(jnp.asarray(A), window), 0.0)


@pytest.mark.parametrize("pads", [None, ((0, 0), (1, 1)), ((1, 2), (0, 1))])
def test_interior_set_add(A, pads):
    shape = tuple(n - lo - hi for n, (lo, hi) in zip(A.shape, pads or ((1, 1), (1, 1))))
    v = np.random.default_rng(3).standard_normal(shape)
    _close(st.interior_add(_t(A), _t(v), pads), jst.interior_add(jnp.asarray(A), jnp.asarray(v), pads))
    _close(st.interior_set(_t(A), _t(v), pads), jst.interior_set(jnp.asarray(A), jnp.asarray(v), pads))


_BCS = {
    "free_slip": dict(free_slip=dict(left=True, right=True, top=True, bot=True)),
    "no_slip": dict(no_slip=dict(left=True, right=True, top=True, bot=True)),
    "mixed": dict(free_slip=dict(left=True, right=True), no_slip=dict(top=True, bot=True)),
    "mixed_lr": dict(free_slip=dict(top=True, bot=True), no_slip=dict(left=True, right=True)),
}


@pytest.mark.parametrize("case", sorted(_BCS))
def test_flow_bcs(case):
    rng = np.random.default_rng(4)
    Vx, Vy = rng.standard_normal((9, 8)), rng.standard_normal((10, 7))
    kw = _BCS[case]
    p = bc.flow_bcs((_t(Vx), _t(Vy)), bc.VelocityBoundaryConditions(**kw))
    j = jbc.flow_bcs((jnp.asarray(Vx), jnp.asarray(Vy)), jbc.VelocityBoundaryConditions(**kw))
    _close(p[0], j[0], 0.0)
    _close(p[1], j[1], 0.0)


def test_flow_bcs_leaves_inputs():
    Vx, Vy = torch.ones(5, 6, dtype=torch.float64), torch.ones(6, 5, dtype=torch.float64)
    bc.flow_bcs((Vx, Vy), bc.VelocityBoundaryConditions(no_slip=dict(left=True, bot=True)))
    assert float(Vx.min()) == 1.0 and float(Vy.min()) == 1.0


def test_faces():
    f = bc.Faces(left=True, top=0.5)
    assert f.any() and not bc.Faces().any()
    assert bc.Faces.active(0.5) and not bc.Faces.active(True)
    assert bc.Faces.on(True) and not bc.Faces.on(0.5)
