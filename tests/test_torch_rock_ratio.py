"""PyTorch port, the rock-ratio masks against the JAX package on the CPU
in float64: ``update_rock_ratio{,_3d}`` and ``valid_masks{,_3d}`` bit for
bit on random phase fields with partial cells (8², 6³), on layouts with
air on each face, and on the JAX test's own 4×4 case; and
``convert.rock_ratio_from_dict`` carrying a JAX rock ratio across.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from justrelax_tpu.ops import rock_ratio as jrr
from justrelax_tpu.rheology.phases import phase_ratios_from_field as j_ratios
from justrelax_tpu_torch import convert
from justrelax_tpu_torch.ops import rock_ratio as prr
from justrelax_tpu_torch.rheology.phases import phase_ratios_from_field as p_ratios

torch.set_num_threads(1)


def _random_ratios(shape, nphase, seed):
    """Fractional ratios with whole and partial cells: each cell one-hot, or
    a random mix of two phases, or one at a ratio near the cutoff."""
    rng = np.random.default_rng(seed)
    r = np.zeros(shape + (nphase,))
    kind = rng.integers(0, 3, size=shape)
    a = rng.integers(0, nphase, size=shape)
    b = (a + 1) % nphase
    w = np.where(kind == 0, 1.0, np.where(kind == 1, rng.random(shape), 1.0 - 5.0e-6))
    np.put_along_axis(r, a[..., None], w[..., None], axis=-1)
    np.put_along_axis(r, b[..., None], (1.0 - w)[..., None], axis=-1)
    return r


def _face_layout(shape, face):
    """Air (phase 1) in the outer quarter of the cells next to ``face``
    (axis, side)."""
    axis, side = face
    n = shape[axis]
    idx = np.arange(n).reshape([-1 if d == axis else 1 for d in range(len(shape))])
    air = idx < max(1, n // 4) if side == 0 else idx >= n - max(1, n // 4)
    return np.broadcast_to(air, shape).astype(int)


def _both(field, nphase, air):
    """(JAX, port) rock ratios and masks from the same phase field."""
    jpr = j_ratios(jnp.asarray(field), nphase)
    ppr = p_ratios(torch.as_tensor(field), nphase)
    if len(jpr) == 4:
        jphi, pphi = jrr.update_rock_ratio(jpr, air), prr.update_rock_ratio(ppr, air)
        jvm, pvm = jrr.valid_masks(jphi), prr.valid_masks(pphi)
    else:
        jphi, pphi = jrr.update_rock_ratio_3d(jpr, air), prr.update_rock_ratio_3d(ppr, air)
        jvm, pvm = jrr.valid_masks_3d(jphi), prr.valid_masks_3d(pphi)
    return (jphi, jvm), (pphi, pvm)


def _bit_equal(j, p):
    (jphi, jvm), (pphi, pvm) = j, p
    assert jphi._fields == pphi._fields and jvm._fields == pvm._fields
    for a, b in zip(pphi, jphi):
        assert a.dtype == torch.float64
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(pvm, jvm):
        assert a.dtype == torch.bool
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("shape", [(8, 8), (6, 6, 6)], ids=["2d", "3d"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_partial_cells_bit_equal(shape, seed):
    r = _random_ratios(shape, 3, seed)
    j, p = _both(r, 3, air=1)
    _bit_equal(j, p)
    (pphi, pvm) = p
    # the random fields hold partial, near-cutoff and invalid nodes
    assert 0.0 < float(pphi.center.mean()) < 1.0
    assert bool(pvm.c.any()) and not bool(pvm.c.all())


@pytest.mark.parametrize("face", [(0, 0), (0, 1), (1, 0), (1, 1)],
                         ids=["left", "right", "bottom", "top"])
def test_air_on_each_face_2d(face):
    j, p = _both(_face_layout((8, 8), face), 2, air=1)
    _bit_equal(j, p)
    assert not bool(p[1].c.all())


@pytest.mark.parametrize("face", [(a, s) for a in range(3) for s in range(2)],
                         ids=["x0", "x1", "y0", "y1", "z0", "z1"])
def test_air_on_each_face_3d(face):
    j, p = _both(_face_layout((6, 6, 6), face), 2, air=1)
    _bit_equal(j, p)
    assert not bool(p[1].c.all())


def test_jax_test_case_4x4():
    """tests/test_variational.py::test_rock_ratio_masks's layout."""
    phase = np.repeat([0, 0, 1, 1], 4).reshape(4, 4).T  # air = 1 on top
    j, p = _both(phase, 2, air=1)
    _bit_equal(j, p)
    pphi, pvm = p
    assert pphi.center.shape == (4, 4)
    np.testing.assert_allclose(pphi.center[:, 0].numpy(), 1.0)
    np.testing.assert_allclose(pphi.center[:, -1].numpy(), 0.0)
    assert bool(pvm.c[0, 0]) and not bool(pvm.c[0, -1])


@pytest.mark.parametrize("shape", [(8, 8), (6, 6, 6)], ids=["2d", "3d"])
def test_rock_ratio_from_dict(shape):
    (jphi, _), _ = _both(_random_ratios(shape, 3, 5), 3, air=1)
    pphi = convert.rock_ratio_from_dict(jphi._asdict(), device="cpu")
    assert type(pphi) is (prr.RockRatio if len(shape) == 2 else prr.RockRatio3D)
    for a, b in zip(pphi, jphi):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
