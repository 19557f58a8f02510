"""PyTorch port, the quick-look plots (``utils/plotting.py``) against the
JAX package's: each figure's PNG, read back with
``matplotlib.image.imread``, pixel for pixel the JAX package's for the same
inputs (tensors into the port, arrays into JAX)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from justrelax_tpu.core.grid import Geometry as JGeometry
from justrelax_tpu.utils import plotting as jplotting
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.utils import plotting

ARGS = ((12, 8), (3.0, 2.0), (0.0, -2.0))


def _same_pixels(a, b):
    from matplotlib.image import imread

    pa, pb = imread(a), imread(b)
    assert pa.shape == pb.shape
    np.testing.assert_array_equal(pa, pb)


@pytest.fixture
def fields():
    rng = np.random.default_rng(6)
    return {name: rng.standard_normal(ARGS[0]) for name in ("T", "eta", "tauII")}


@pytest.mark.parametrize("log", [False, True])
def test_heatmap_pixel_equal(tmp_path, fields, log):
    A = np.abs(fields["eta"]) * 1e21
    got = plotting.heatmap(torch.as_tensor(A), Geometry(*ARGS), str(tmp_path / "p" / "h.png"),
                           title="eta", log=log)
    want = jplotting.heatmap(jnp.asarray(A), JGeometry(*ARGS), str(tmp_path / "j" / "h.png"),
                             title="eta", log=log)
    _same_pixels(got, want)


def test_multipanel_pixel_equal(tmp_path, fields):
    got = plotting.multipanel({k: torch.as_tensor(v) for k, v in fields.items()},
                              Geometry(*ARGS), str(tmp_path / "p" / "m.png"))
    want = jplotting.multipanel({k: jnp.asarray(v) for k, v in fields.items()},
                                JGeometry(*ARGS), str(tmp_path / "j" / "m.png"))
    _same_pixels(got, want)


def test_convergence_plot_pixel_equal(tmp_path):
    hist = np.array([1.0, 3e-2, 4e-4, 2e-6, 8e-9, np.nan, np.nan])
    got = plotting.convergence_plot(torch.as_tensor(hist), str(tmp_path / "p" / "c.png"),
                                    eps=1e-8, nout=500)
    want = jplotting.convergence_plot(jnp.asarray(hist), str(tmp_path / "j" / "c.png"),
                                      eps=1e-8, nout=500)
    _same_pixels(got, want)


def test_velocity_quiver_pixel_equal(tmp_path, fields):
    rng = np.random.default_rng(7)
    Vx, Vy = rng.standard_normal(ARGS[0]), rng.standard_normal(ARGS[0])
    got = plotting.velocity_quiver(torch.as_tensor(Vx), torch.as_tensor(Vy), Geometry(*ARGS),
                                   str(tmp_path / "p" / "q.png"), stride=2,
                                   background=torch.as_tensor(fields["T"]))
    want = jplotting.velocity_quiver(jnp.asarray(Vx), jnp.asarray(Vy), JGeometry(*ARGS),
                                     str(tmp_path / "j" / "q.png"), stride=2,
                                     background=jnp.asarray(fields["T"]))
    _same_pixels(got, want)
