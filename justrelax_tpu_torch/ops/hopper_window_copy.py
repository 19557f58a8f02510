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
- ``plan`` is the kernel's cut of the copy: one block per ``rows`` x rows of
  a window (at most 8 KiB each where one row fits: 256 blocks at the
  script's shape), TMA boxes of ``zb`` z values (a box dimension holds at
  most 256 elements), and the shared memory that takes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from justrelax_tpu_torch.ops._cuda_build import CSRC, load_library

__all__ = ["MODES", "plan", "window_indices", "window_copy", "window_copy_reference"]

MODES = ("2d", "x", "loop")
_MODE_CODE = {"2d": 0, "x": 1, "loop": 2}
_SMEM_MAX = 232_448   # bytes of shared memory a block can have (227 KB)
_BOX_MAX = 256        # elements along one dimension of a TMA box
_ALIGN = 128          # bytes: a box's shared-memory address; the barrier's slot
_BLOCK_BYTES = 8 * 1024  # the copy a block takes on, at most, when one x row fits

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


@functools.lru_cache(maxsize=None)
def plan(Z, R, Ry, mode, rows=None):
    """The kernel's cut of the copy: ``(rows, zb, region, smem)``.

    - ``rows``: x rows per block, the largest divisor of R (at most 256)
      whose rows of Ry·Z floats fit in 8 KiB, at least 1 (on an H100, one
      row of 8 KiB a block copies 4 % faster than two, 20 % faster than
      eight: a block's load and store are latency-bound);
    - ``zb``: z values per TMA box, Z itself up to 256, else the largest
      multiple of 4 up to 256 that divides Z;
    - ``region``: bytes of shared memory per box, rounded up to 128;
    - ``smem``: the block's shared memory: its regions (Z / zb boxes, times
      Ry in mode ``"loop"``) after a 128-byte barrier slot and 128 bytes to
      align them."""
    zb = Z if Z <= _BOX_MAX else max(d for d in range(4, _BOX_MAX + 1, 4) if Z % d == 0)
    if rows is None:
        rows = max(d for d in range(1, min(R, _BOX_MAX) + 1)
                   if R % d == 0 and (d == 1 or d * Ry * Z * 4 <= _BLOCK_BYTES))
    box_y = 1 if mode == "loop" else Ry
    region = -(-rows * box_y * zb * 4 // _ALIGN) * _ALIGN
    return rows, zb, region, 2 * _ALIGN + (Z // zb) * (Ry // box_y) * region


def window_copy(src, mode="2d", W=32, Wy=40, R=32, Ry=16):
    """Copy the dynamic windows of ``src`` (N, X, Y, Z) into a new
    ``(1, X, Y, Z)`` tensor, as the TPU kernel does (see the module note)."""
    _check(src, mode, W, Wy, R, Ry)
    if src.device.type == "cpu":
        return window_copy_reference(src, mode, W, Wy, R, Ry)
    if src.device.type != "cuda":
        raise ValueError(f"window_copy: unsupported device {src.device}")
    with torch.cuda.device(src.device):
        out = _launch(_library(), torch.cuda.current_stream().cuda_stream, src, mode,
                      W, Wy, R, Ry)
    window_copy.launches += 1
    return out


def _kernel_check(src, mode, R, Ry, rows):
    """What the kernel takes beyond ``_check``; returns ``plan``'s cut."""
    if src.dtype != torch.float32:
        raise ValueError(f"window_copy: dtype {src.dtype} is not float32")
    if not src.is_contiguous():
        raise ValueError("window_copy: src is not contiguous")
    if src.data_ptr() % 16:
        raise ValueError("window_copy: src is not 16-byte aligned (a TMA tensor map's base)")
    _, _, _, Z = src.shape
    if Z % 4:
        raise ValueError(f"window_copy: Z={Z} must be a multiple of 4 (a TMA box's "
                         "inner 16 bytes and the tensor map's strides)")
    if mode != "loop" and Ry > _BOX_MAX:
        raise ValueError(f"window_copy: Ry={Ry} is past a TMA box's {_BOX_MAX} elements")
    cut = plan(Z, R, Ry, mode, rows)
    if not (0 < cut[0] <= _BOX_MAX and R % cut[0] == 0):
        raise ValueError(f"window_copy: rows={cut[0]} must divide R={R} and be at most "
                         f"{_BOX_MAX}")
    if cut[3] > _SMEM_MAX:
        raise ValueError(f"window_copy: a block needs {cut[3]} bytes of shared memory "
                         f"(one x row of the window is Ry·Z·4 bytes), past {_SMEM_MAX}")
    return cut


def _launch(lib, stream, src, mode, W, Wy, R, Ry, rows=None):
    """Run the C function of ``lib`` (bound by ``_bind``) on ``stream`` into a
    new output, ``rows`` x rows per block (``plan``'s by default); raises on
    what the kernel does not take, a failed tensor-map encode and a launch
    error."""
    N, X, Y, Z = src.shape
    rows, zb, region, smem = _kernel_check(src, mode, R, Ry, rows)
    out = torch.empty((1, X, Y, Z), dtype=src.dtype, device=src.device)
    err = lib.jr_window_copy_f32(src.data_ptr(), out.data_ptr(), N, X, Y, Z, W, Wy, R, Ry,
                                 rows, zb, region, smem, _MODE_CODE[mode], stream)
    if err < 0:
        raise RuntimeError(f"window_copy: cuTensorMapEncodeTiled failed with CUresult {-err}")
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
    lib.jr_window_copy_f32.argtypes = [vp, vp] + [i] * 13 + [vp]
    lib.jr_window_copy_f32.restype = i
    return lib
