"""PyTorch port, IO against the JAX package on the CPU: checkpoints written
by either package load in the other (the whole-state ``.npz`` in 2D and 3D,
float64 and float32, with and without a rank; the particle ``.npz``; the
float32 HDF5 file), with every array, its dtype, the key set and the
scalars equal; the VTK writers' files (``.vti``, ``.pvd``, ``.vtp`` of 2D and
3D particles and of a marker chain, ``.pvti`` and its pieces) byte for byte
the JAX package's; and the loaders' refusals (no card for the default
device, no h5py)."""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from justrelax_tpu.core.grid import Geometry as JGeometry
from justrelax_tpu.core.state import StokesState as JStokesState
from justrelax_tpu.core.state import ThermalState as JThermalState
from justrelax_tpu.io import checkpoint as jcheckpoint
from justrelax_tpu.io import vtk as jvtk
from justrelax_tpu.parallel.decomp import Decomp2D as JDecomp2D
from justrelax_tpu.particles.marker_chain import MarkerChain as JMarkerChain
from justrelax_tpu.particles.particles import Particles as JParticles
from justrelax_tpu.particles.particles3d import Particles3D as JParticles3D
from justrelax_tpu_torch import convert
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.core.state import StokesState, ThermalState
from justrelax_tpu_torch.io import checkpoint, vtk
from justrelax_tpu_torch.parallel.decomp import Decomp2D
from justrelax_tpu_torch.particles.marker_chain import MarkerChain
from justrelax_tpu_torch.particles.particles import Particles
from justrelax_tpu_torch.particles.particles3d import Particles3D

NI = {2: (6, 5), 3: (4, 3, 5)}


def _random_like(tree, rng, dtype):
    """The nested state dict with every array replaced by seeded normals."""
    if isinstance(tree, dict):
        return {k: _random_like(v, rng, dtype) for k, v in tree.items()}
    if tree is None:
        return None
    return rng.standard_normal(np.shape(tree)).astype(dtype)


def _states(ndim, dtype, seed=0):
    """(JAX stokes, JAX thermal, port stokes, port thermal) holding the same
    seeded values."""
    ni = NI[ndim]
    rng = np.random.default_rng(seed)
    sd = _random_like(serialization.to_state_dict(JStokesState.make(ni)), rng, dtype)
    td = _random_like(serialization.to_state_dict(JThermalState.make(ni)), rng, dtype)
    js = serialization.from_state_dict(JStokesState.make(ni), sd)
    jt = serialization.from_state_dict(JThermalState.make(ni), td)
    return (js, jt, convert.stokes_state_from_dict(sd, device="cpu"),
            convert.thermal_state_from_dict(td, device="cpu"))


def _jax_leaves(prefix, state):
    return jcheckpoint._flatten_state(prefix, state)


def _port_leaves(prefix, state):
    return {k: v.numpy() for k, v in checkpoint._leaves(prefix, state)}


def _assert_same(port, jax_flat, dtype):
    assert list(port) == list(jax_flat)
    for k, v in port.items():
        assert v.dtype == dtype, k
        np.testing.assert_array_equal(v, jax_flat[k], err_msg=k)


@pytest.mark.parametrize("ndim", [2, 3])
def test_state_keys_match_jax(ndim):
    """The port's field paths are the JAX pytree paths, in order (58 + 12
    in 2D)."""
    js, jt, ps, pt = _states(ndim, np.float64)
    assert list(_port_leaves("stokes/", ps)) == list(_jax_leaves("stokes/", js))
    assert list(_port_leaves("thermal/", pt)) == list(_jax_leaves("thermal/", jt))
    if ndim == 2:
        assert (len(_port_leaves("", ps)), len(_port_leaves("", pt))) == (58, 12)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("rank", [None, 3])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("ndim", [2, 3])
def test_npz_checkpoint_across_packages(tmp_path, ndim, dtype, rank, writer):
    js, jt, ps, pt = _states(ndim, dtype)
    ni = NI[ndim]
    if writer == "jax":
        path = jcheckpoint.checkpointing(str(tmp_path), js, jt, 1.5, 3.0, rank=rank)
    else:
        path = checkpoint.checkpointing(str(tmp_path), ps, pt, 1.5, 3.0, rank=rank)
    assert os.path.basename(path) == f"checkpoint{'' if rank is None else rank}.npz"
    with np.load(path) as data:
        keys = set(data)
    assert keys == {"time", "timestep"} | set(_jax_leaves("stokes/", js)) | set(
        _jax_leaves("thermal/", jt))

    # the port reads, into float64 templates: each field keeps its stored dtype
    s2, t2, time, step = checkpoint.load_checkpoint(
        path, StokesState.make(ni, device="cpu"), ThermalState.make(ni, device="cpu"))
    assert (time, step) == (1.5, 3.0)
    _assert_same(_port_leaves("stokes/", s2), _jax_leaves("stokes/", js), dtype)
    _assert_same(_port_leaves("thermal/", t2), _jax_leaves("thermal/", jt), dtype)
    assert all(v.is_contiguous() for _, v in checkpoint._leaves("", s2))

    # JAX reads
    s3, t3, time, step = jcheckpoint.load_checkpoint(
        path, JStokesState.make(ni), JThermalState.make(ni))
    assert (time, step) == (1.5, 3.0)
    _assert_same(_jax_leaves("stokes/", s3), _port_leaves("stokes/", ps), dtype)
    _assert_same(_jax_leaves("thermal/", t3), _port_leaves("thermal/", pt), dtype)


def test_load_keeps_template_fields_the_file_lacks(tmp_path):
    """A state written without its thermal part loads with the thermal
    template's own tensors, as in the JAX package; a field left ``None``
    (Vz in 2D) is not written."""
    _, _, ps, _ = _states(2, np.float64)
    path = checkpoint.checkpointing(str(tmp_path), ps, None, 0.0, 1.0)
    with np.load(path) as data:
        assert not any(k.startswith("thermal/") for k in data)
        assert "stokes/V/Vz" not in data
    template = ThermalState.make(NI[2], device="cpu")
    _, t2, _, _ = checkpoint.load_checkpoint(path, StokesState.make(NI[2], device="cpu"),
                                             template)
    for f in dataclasses.fields(template):
        assert getattr(t2, f.name) is getattr(template, f.name)


def _particles(seed=1):
    rng = np.random.default_rng(seed)
    shape = (4, 3, 6)
    d = dict(px=rng.random(shape), py=rng.random(shape), active=rng.random(shape) < 0.6)
    fields = dict(phase=np.floor(rng.random(shape) * 3.0), T=rng.standard_normal(shape))
    jp = JParticles(px=jnp.asarray(d["px"]), py=jnp.asarray(d["py"]),
                    active=jnp.asarray(d["active"]), min_xcell=2, nxcell=4)
    pp = convert.particles_from_dict(dict(d, min_xcell=2, nxcell=4), device="cpu")
    return jp, pp, fields


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_particle_checkpoint_across_packages(tmp_path, writer):
    jp, pp, fields = _particles()
    if writer == "jax":
        path = jcheckpoint.checkpointing_particles(
            str(tmp_path), jp, fields={k: jnp.asarray(v) for k, v in fields.items()},
            t=2.5, dt=0.5, it=7, rank=1)
    else:
        path = checkpoint.checkpointing_particles(
            str(tmp_path), pp, fields={k: torch.as_tensor(v) for k, v in fields.items()},
            t=2.5, dt=0.5, it=7, rank=1)
    assert path.endswith("particles1.npz")

    p2, f2, t, dt, it = checkpoint.load_checkpoint_particles(path, device="cpu")
    j2, jf2, jt, jdt, jit = jcheckpoint.load_checkpoint_particles(path)
    assert (t, dt, it) == (jt, jdt, jit) == (2.5, 0.5, 7)
    assert isinstance(p2, Particles) and p2.active.dtype == torch.bool
    assert (p2.min_xcell, p2.nxcell) == (j2.min_xcell, j2.nxcell) == (2, 4)
    for k in ("px", "py", "active"):
        np.testing.assert_array_equal(getattr(p2, k).numpy(), np.asarray(getattr(j2, k)))
        np.testing.assert_array_equal(getattr(p2, k).numpy(), np.asarray(getattr(pp, k)))
    assert set(f2) == set(jf2) == set(fields)
    for k, v in fields.items():
        assert f2[k].dtype == torch.float64
        np.testing.assert_array_equal(f2[k].numpy(), v)
        np.testing.assert_array_equal(np.asarray(jf2[k]), v)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("ndim", [2, 3])
def test_hdf5_checkpoint_across_packages(tmp_path, ndim, writer):
    js, jt, ps, pt = _states(ndim, np.float64)
    if writer == "jax":
        path = jcheckpoint.checkpointing_hdf5(str(tmp_path), js, jt, 2.0, 4.0)
    else:
        path = checkpoint.checkpointing_hdf5(str(tmp_path), ps, pt, 2.0, 4.0)
    fields, time, step = checkpoint.load_checkpoint_hdf5(path, device="cpu")
    jfields, jtime, jstep = jcheckpoint.load_checkpoint_hdf5(path)
    assert (time, step) == (jtime, jstep) == (2.0, 4.0)
    names = {"P", "Vx", "Vy", "txx", "tyy", "txy", "T"}
    if ndim == 3:
        names |= {"Vz", "tzz", "tyz", "txz"}
    assert set(fields) == set(jfields) == names
    want = {"P": js.P, "Vx": js.V.Vx, "txy": js.tau.xy, "T": jt.T}
    for k, v in fields.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), jfields[k])
    for k, v in want.items():
        np.testing.assert_array_equal(fields[k].numpy(), np.asarray(v, dtype=np.float32))


def test_loaders_default_to_the_card(tmp_path):
    """With no device, the particle and HDF5 loaders raise on a host
    without a card, as ``core/device.py::resolve_device`` does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, pp, _ = _particles()
    path = checkpoint.checkpointing_particles(str(tmp_path), pp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        checkpoint.load_checkpoint_particles(path)
    _, _, ps, pt = _states(2, np.float64)
    h5 = checkpoint.checkpointing_hdf5(str(tmp_path), ps, pt, 0.0, 1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        checkpoint.load_checkpoint_hdf5(h5)


def test_hdf5_without_h5py_raises(tmp_path, monkeypatch):
    """No fallback: without h5py both HDF5 functions raise ImportError."""
    _, _, ps, pt = _states(2, np.float64)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError):
        checkpoint.checkpointing_hdf5(str(tmp_path), ps, pt, 0.0, 1.0)
    with pytest.raises(ImportError):
        checkpoint.load_checkpoint_hdf5(str(tmp_path / "checkpoint.h5"), device="cpu")


# --- VTK: byte for byte the JAX package's files -----------------------------
def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), (a, b)


def _grids(ndim):
    if ndim == 2:
        args = ((8, 6), (2.0, 1.5), (0.0, -1.5))
    else:
        args = ((5, 4, 3), (1.0, 0.8, 0.3), (0.1, -0.8, 0.0))
    return Geometry(*args), JGeometry(*args)


@pytest.mark.parametrize("ndim", [2, 3])
def test_vti_and_series_byte_identical(tmp_path, ndim):
    g, jg = _grids(ndim)
    rng = np.random.default_rng(2)
    cell = {"P": rng.standard_normal(g.ni), "eta": rng.random(g.ni) * 1e21}
    point = {"T": rng.standard_normal(tuple(n + 1 for n in g.ni))}
    port = vtk.save_vti(str(tmp_path / "port" / "out"), g,
                        cell_data={k: torch.as_tensor(v) for k, v in cell.items()},
                        point_data={k: torch.as_tensor(v) for k, v in point.items()})
    ref = jvtk.save_vti(str(tmp_path / "jax" / "out"), jg,
                        cell_data={k: jnp.asarray(v) for k, v in cell.items()},
                        point_data={k: jnp.asarray(v) for k, v in point.items()})
    _same_bytes(port, ref)

    series = vtk.VTKSeries(str(tmp_path / "port" / "series"))
    jseries = jvtk.VTKSeries(str(tmp_path / "jax" / "series"))
    for time in (0.0, 1.25):
        files = (series.append(g, time, cell_data={"P": torch.as_tensor(cell["P"])}),
                 jseries.append(jg, time, cell_data={"P": jnp.asarray(cell["P"])}))
        _same_bytes(*files)
    _same_bytes(series.path, jseries.path)


def test_pvtk_byte_identical(tmp_path):
    g, jg = _grids(2)
    cell = {"P": np.random.default_rng(3).standard_normal(g.ni)}
    port = vtk.save_pvtk(str(tmp_path / "port" / "par"), g, Decomp2D.make(g.ni, (2, 3)),
                         cell_data={"P": torch.as_tensor(cell["P"])})
    ref = jvtk.save_pvtk(str(tmp_path / "jax" / "par"), jg, JDecomp2D.make(jg.ni, (2, 3)),
                         cell_data={"P": jnp.asarray(cell["P"])})
    _same_bytes(port, ref)
    pieces = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == pieces and len(pieces) == 7
    for name in pieces:
        _same_bytes(tmp_path / "port" / name, tmp_path / "jax" / name)


@pytest.mark.parametrize("ndim", [2, 3])
def test_save_particles_byte_identical(tmp_path, ndim):
    rng = np.random.default_rng(4)
    shape = (3, 4, 5) if ndim == 2 else (3, 2, 2, 4)
    axes = ("px", "py") if ndim == 2 else ("px", "py", "pz")
    pos = {a: rng.random(shape) * 1.0e3 for a in axes}
    active = rng.random(shape) < 0.7
    phase, T = np.floor(rng.random(shape) * 3.0), rng.standard_normal(shape)
    jcls, cls = (JParticles, Particles) if ndim == 2 else (JParticles3D, Particles3D)
    jp = jcls(**{a: jnp.asarray(v) for a, v in pos.items()}, active=jnp.asarray(active))
    pp = cls(**{a: torch.as_tensor(v) for a, v in pos.items()}, active=torch.as_tensor(active))
    port = vtk.save_particles(str(tmp_path / "port" / "p"), pp, phases=torch.as_tensor(phase),
                              fields={"T": torch.as_tensor(T)}, conversion=1.0e3)
    ref = jvtk.save_particles(str(tmp_path / "jax" / "p"), jp, phases=jnp.asarray(phase),
                              fields={"T": jnp.asarray(T)}, conversion=1.0e3)
    _same_bytes(port, ref)


def test_save_marker_chain_byte_identical(tmp_path):
    rng = np.random.default_rng(5)
    x, y = np.sort(rng.random(17)), rng.random(17)
    port = vtk.save_marker_chain(str(tmp_path / "port" / "chain"),
                                 MarkerChain(torch.as_tensor(x), torch.as_tensor(y)))
    ref = jvtk.save_marker_chain(str(tmp_path / "jax" / "chain"),
                                 JMarkerChain(jnp.asarray(x), jnp.asarray(y)))
    _same_bytes(port, ref)
