"""PyTorch port, the 2D dynamic-window copy (``ops/hopper_window_copy.py``),
on the CPU:

- the plain version against the TPU kernel of ``scripts/repro_2d_dma.py``
  itself, run in interpret mode: the script's text is executed with
  ``interpret=True`` inserted into its ``pl.pallas_call`` (the file is not
  changed), and its ``out`` must equal the port's exactly (a copy);
- the plain version against a numpy transcription of the index rule, at the
  script's shape and at others;
- the wrapper's checks and the command line with ``--device cpu``.

The kernel itself runs on the card (``tests/test_torch_cuda.py``).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from justrelax_tpu_torch.ops import hopper_window_copy as hw
from justrelax_tpu_torch.scripts import repro_2d_dma

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "repro_2d_dma.py"
SUMS = {"2d": 128244.781, "x": 127238.141, "loop": 128244.781}


def _jax_out(mode, monkeypatch):
    text = SCRIPT.read_text()
    anchor = "pl.pallas_call(\n    kern,\n"
    assert text.count(anchor) == 1
    text = text.replace(anchor, anchor + "    interpret=True,\n")
    monkeypatch.setattr(sys, "argv", [str(SCRIPT), mode])
    ns = {"__name__": "repro_2d_dma_interpret"}
    exec(compile(text, str(SCRIPT), "exec"), ns)
    return np.asarray(ns["out"]), np.array(ns["x"])


def _numpy_rule(src, mode, W, Wy, R, Ry):
    _, X, Y, Z = src.shape
    out = np.full((1, X, Y, Z), np.nan, dtype=src.dtype)
    for i in range(X // R):
        for j in range(Y // Ry):
            x0 = min(max(i * R - 4, 0), X - W)
            y0 = 0 if mode == "x" else min(max(j * Ry - 4, 0), Y - Wy)
            for a in range(R):
                for b in range(Ry):
                    out[0, i * R + a, j * Ry + b] = src[0, x0 + a, y0 + b]
    return out


@pytest.mark.parametrize("mode", hw.MODES)
def test_reference_equals_tpu_kernel_interpret(mode, monkeypatch):
    ref, x = _jax_out(mode, monkeypatch)
    out = hw.window_copy_reference(torch.as_tensor(x), mode)
    assert out.shape == (1, 64, 64, 128)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert f"{out.numpy().sum():.3f}" == f"{SUMS[mode]:.3f}"


@pytest.mark.parametrize("mode", hw.MODES)
@pytest.mark.parametrize("shape,params", [
    ((4, 64, 64, 128), (32, 40, 32, 16)),
    ((2, 24, 30, 8), (12, 10, 8, 6)),
    ((1, 16, 12, 4), (16, 12, 4, 3)),
])
def test_reference_equals_numpy_rule(mode, shape, params):
    rng = np.random.default_rng(11)
    src = rng.standard_normal(shape).astype(np.float32)
    out = hw.window_copy(torch.as_tensor(src), mode, *params)  # CPU: the plain version
    np.testing.assert_array_equal(out.numpy(), _numpy_rule(src, mode, *params))


def test_cpu_route_launches_nothing():
    before = hw.window_copy.launches
    hw.window_copy(torch.zeros((4, 64, 64, 128)))
    assert hw.window_copy.launches == before


@pytest.mark.parametrize("kwargs", [
    dict(mode="3d"),
    dict(R=24),              # does not divide X
    dict(Ry=24),             # does not divide Y
    dict(W=16),              # window narrower than R
    dict(Wy=80),             # window wider than Y
])
def test_wrapper_rejects_bad_inputs(kwargs):
    with pytest.raises(ValueError):
        hw.window_copy(torch.zeros((4, 64, 64, 128)), **kwargs)


def test_wrapper_rejects_bad_rank():
    with pytest.raises(ValueError):
        hw.window_copy(torch.zeros((64, 64, 128)))


@pytest.mark.parametrize("mode", hw.MODES)
def test_cli_runs_on_cpu(mode, capsys):
    out = repro_2d_dma.main([mode, "--device", "cpu"])
    text = capsys.readouterr().out.splitlines()
    assert text[0].startswith(f"mode={mode} build")
    assert text[-1] == "PASS"
    assert all(f"finite=True sum={SUMS[mode]:.3f}" in ln for ln in text[1:4])
    assert out.shape == (1, 64, 64, 128)


@pytest.mark.parametrize("Z,R,Ry,mode,want", [
    # the script's shape: 1 x row of 8 KiB a block, 64 x (64 / 16) = 256 blocks
    (128, 32, 16, "2d", (1, 128, 8192, 8448)),
    (128, 32, 16, "loop", (1, 128, 512, 8448)),
    # Z = 512: two boxes of 256 along z, one x row of 32 KiB a block
    (512, 64, 16, "x", (1, 256, 16384, 33024)),
    # Z = 4: five rows of 96 bytes a block, each y row's box rounded up to 128 bytes
    (4, 5, 6, "2d", (5, 4, 512, 768)),
    (4, 5, 6, "loop", (5, 4, 128, 1024)),
    # Z = 300: boxes of 100, the largest multiple of 4 up to 256 dividing 300
    (300, 8, 4, "2d", (1, 100, 1664, 5248)),
])
def test_plan(Z, R, Ry, mode, want):
    """``plan``: (x rows a block, z values a box, bytes a box's region,
    bytes of shared memory a block)."""
    assert hw.plan(Z, R, Ry, mode) == want


@pytest.mark.parametrize("shape,kwargs,match", [
    ((4, 64, 64, 126), {}, "multiple of 4"),
    ((1, 8, 512, 4), dict(W=8, Wy=512, R=8, Ry=512), "TMA box"),
    ((1, 4, 64, 4096), dict(W=4, Wy=64, R=4, Ry=16), "shared memory"),
])
def test_kernel_check_rejects(shape, kwargs, match):
    """What the kernel does not take is refused before a launch."""
    kw = dict(dict(mode="2d", W=32, Wy=40, R=32, Ry=16), **kwargs)
    src = torch.zeros(shape)
    hw._check(src, kw["mode"], kw["W"], kw["Wy"], kw["R"], kw["Ry"])
    with pytest.raises(ValueError, match=match):
        hw._kernel_check(src, kw["mode"], kw["R"], kw["Ry"], None)
