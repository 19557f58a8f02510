"""The 2D dynamic-window copy: Hopper CUDA kernel and its plain PyTorch
version.

Counterpart of ``scripts/repro_2d_dma.py::kern``, the TPU kernel that
reproduces a DMA with dynamic offsets in two dims. Block ``(i, j)`` of the
``(X / R, Y / Ry)`` grid takes ``x0 = clip(i·R − 4, 0, X − W)`` and
``y0 = clip(j·Ry − 4, 0, Y − Wy)`` and writes, for ``a < R`` and ``b < Ry``,

- ``out[0, i·R + a, j·Ry + b, :] = src[0, x0 + a, y0 + b, :]`` in modes
  ``"2d"`` and ``"loop"``;
- ``out[0, i·R + a, j·Ry + b, :] = src[0, x0 + a, b, :]`` in mode ``"x"``
  (a window with no y offset).

- ``window_copy`` is the wrapper. On a CUDA tensor it launches the kernel of
  ``csrc/window_copy.cu`` (built with ``nvcc`` at first use by
  ``ops/_cuda_build.py`` and loaded with ``ctypes``) or raises; on a CPU
  tensor it runs the plain version. ``window_copy.launches`` counts kernel
  launches.
- ``window_copy_reference`` is the plain version: index arithmetic and one
  advanced-indexing gather.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from justrelax_tpu_torch.ops._cuda_build import CSRC, load_library

__all__ = ["MODES", "window_indices", "window_copy", "window_copy_reference"]

MODES = ("2d", "x", "loop")
_MODE_CODE = {"2d": 0, "x": 1, "loop": 2}
_SMEM_MAX = 227 * 1024

SOURCE = CSRC / "window_copy.cu"


def _check(src, mode, W, Wy, R, Ry):
    if mode not in MODES:
        raise ValueError(f"window_copy: mode must be one of {MODES}, not {mode!r}")
    if src.ndim != 4:
        raise ValueError(f"window_copy: src must be (N, X, Y, Z), got {tuple(src.shape)}")
    _, X, Y, Z = src.shape
    if R <= 0 or Ry <= 0 or X % R or Y % Ry:
        raise ValueError(f"window_copy: R={R} and Ry={Ry} must divide X={X} and Y={Y}")
    if not (R <= W <= X and Ry <= Wy <= Y):
        raise ValueError(f"window_copy: need R <= W <= X and Ry <= Wy <= Y "
                         f"(W={W}, Wy={Wy}, X={X}, Y={Y})")
    return X, Y, Z


def window_indices(X, Y, mode="2d", W=32, Wy=40, R=32, Ry=16, device=None):
    """The source row and column of every output row and column:
    ``(xi (X,), yi (Y,))``."""
    x = torch.arange(X, device=device)
    y = torch.arange(Y, device=device)
    xi = torch.clamp((x // R) * R - 4, 0, X - W) + x % R
    y0 = 0 if mode == "x" else torch.clamp((y // Ry) * Ry - 4, 0, Y - Wy)
    return xi, y0 + y % Ry


def window_copy_reference(src, mode="2d", W=32, Wy=40, R=32, Ry=16):
    """Plain version of :func:`window_copy`: ``(1, X, Y, Z)``."""
    X, Y, _ = _check(src, mode, W, Wy, R, Ry)
    xi, yi = window_indices(X, Y, mode, W, Wy, R, Ry, device=src.device)
    return src[0][xi[:, None], yi[None, :]][None]


def window_copy(src, mode="2d", W=32, Wy=40, R=32, Ry=16):
    """Copy the dynamic windows of ``src`` (N, X, Y, Z) into a new
    ``(1, X, Y, Z)`` tensor, as the TPU kernel does (see the module note)."""
    X, Y, Z = _check(src, mode, W, Wy, R, Ry)
    if src.device.type == "cpu":
        return window_copy_reference(src, mode, W, Wy, R, Ry)
    if src.device.type != "cuda":
        raise ValueError(f"window_copy: unsupported device {src.device}")
    if src.dtype != torch.float32:
        raise ValueError(f"window_copy: dtype {src.dtype} is not float32")
    if not src.is_contiguous():
        raise ValueError("window_copy: src is not contiguous")
    if Z % 4 or Ry * Z * 4 > _SMEM_MAX:
        raise ValueError(f"window_copy: Z={Z} must be a multiple of 4 and one x row "
                         f"of the window, Ry·Z·4 bytes, at most {_SMEM_MAX}")
    with torch.cuda.device(src.device):
        out = _launch(_library(), torch.cuda.current_stream().cuda_stream, src, mode,
                      W, Wy, R, Ry)
    window_copy.launches += 1
    return out


def _launch(lib, stream, src, mode, W, Wy, R, Ry):
    """Run the C function of ``lib`` (bound by ``_bind``) on ``stream`` into a
    new output; raises on a launch error."""
    _, X, Y, Z = src.shape
    out = torch.empty((1, X, Y, Z), dtype=src.dtype, device=src.device)
    err = lib.jr_window_copy_f32(src.data_ptr(), out.data_ptr(), X, Y, Z, W, Wy,
                                 R, Ry, _MODE_CODE[mode], stream)
    if err != 0:
        raise RuntimeError(
            f"window_copy: CUDA error {err}: {lib.jr_cuda_error_string(err).decode()}")
    return out


window_copy.launches = 0


@functools.lru_cache(maxsize=None)
def _library():
    return _bind(load_library(SOURCE))


def _bind(lib):
    """``lib`` with the C function of ``csrc/window_copy.cu`` typed."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.jr_window_copy_f32.argtypes = [vp, vp, i, i, i, i, i, i, i, i, vp]
    lib.jr_window_copy_f32.restype = i
    return lib
