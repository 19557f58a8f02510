"""PyTorch port, ``rheology/phases.py`` against the JAX package, in float64
on the CPU: ``phase_ratios_from_field`` in 2D and 3D for an integer index
field and for a fractional ratio field (every staggered location within
1e-15), ``one_hot_phases``, and ``convert.phase_ratios_from_dict``, which
hands the JAX ratios to the port unchanged."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from justrelax_tpu.rheology import phases as jph
from justrelax_tpu_torch import convert
from justrelax_tpu_torch.rheology import phases as pph

torch.set_num_threads(1)

_SHAPES = {"2d": (7, 5), "3d": (6, 5, 4)}


def _index_field(ni, nphase, seed):
    return np.random.default_rng(seed).integers(0, nphase, size=ni)


def _fractional_field(ni, nphase, seed):
    r = np.random.default_rng(seed).random(ni + (nphase,))
    r[..., 0] += (r[..., 0] > 0.7) * 3.0   # some cells mostly one phase
    return r / r.sum(axis=-1, keepdims=True)


def _assert_ratios_close(port, jax_ratios):
    assert type(port).__name__ == type(jax_ratios).__name__
    for name in port._fields:
        a, b = getattr(port, name).numpy(), np.asarray(getattr(jax_ratios, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-15, err_msg=name)


@pytest.mark.parametrize("dim", sorted(_SHAPES))
@pytest.mark.parametrize("nphase", [2, 3])
def test_phase_ratios_from_index_field(dim, nphase):
    idx = _index_field(_SHAPES[dim], nphase, seed=nphase)
    port = pph.phase_ratios_from_field(torch.as_tensor(idx), nphase)
    _assert_ratios_close(port, jph.phase_ratios_from_field(jnp.asarray(idx), nphase))
    for name in port._fields:   # each location's ratios sum to one
        s = getattr(port, name).sum(-1)
        assert torch.allclose(s, torch.ones_like(s), rtol=0, atol=1e-15)


@pytest.mark.parametrize("dim", sorted(_SHAPES))
@pytest.mark.parametrize("given_nphase", [False, True])
def test_phase_ratios_from_fractional_field(dim, given_nphase):
    """A (ni…, nphase) float field is taken as ratios, with or without
    ``nphase`` (a matching ``nphase`` does not make it an index field)."""
    r = _fractional_field(_SHAPES[dim], 3, seed=5)
    nphase = 3 if given_nphase else None
    port = pph.phase_ratios_from_field(torch.as_tensor(r), nphase)
    _assert_ratios_close(port, jph.phase_ratios_from_field(jnp.asarray(r), nphase))


def test_one_hot_phases():
    idx = _index_field((4, 3, 2), 3, seed=1)
    np.testing.assert_array_equal(pph.one_hot_phases(torch.as_tensor(idx), 3).numpy(),
                                  np.asarray(jph.one_hot_phases(jnp.asarray(idx), 3)))
    assert pph.one_hot_phases(torch.as_tensor(idx), 3, torch.float32).dtype == torch.float32


def test_index_ratios_follow_device_and_dtype():
    idx = torch.as_tensor(_index_field((4, 4, 4), 2, seed=2))
    r = pph.phase_ratios_from_field(idx, 2, dtype=torch.float32)
    assert all(t.dtype == torch.float32 and t.device == idx.device for t in r)
    r64 = pph.phase_ratios_from_field(idx, 2)
    assert all(torch.equal(a, b.float()) for a, b in zip(r, r64))


@pytest.mark.parametrize("dim", sorted(_SHAPES))
def test_phase_ratios_from_dict(dim):
    """The JAX ratios (their ``_asdict()``) become the port's type with the
    same arrays, on the given device and dtype."""
    idx = _index_field(_SHAPES[dim], 2, seed=9)
    j = jph.phase_ratios_from_field(jnp.asarray(idx), 2)
    p = convert.phase_ratios_from_dict(j._asdict(), device="cpu")
    _assert_ratios_close(p, j)
    for name in p._fields:
        assert np.array_equal(getattr(p, name).numpy(), np.asarray(getattr(j, name)))
    p32 = convert.phase_ratios_from_dict(j._asdict(), device="cpu", dtype=torch.float32)
    assert all(t.dtype == torch.float32 for t in p32)
