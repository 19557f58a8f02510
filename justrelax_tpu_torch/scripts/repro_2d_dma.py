"""The 2D dynamic-window copy (``scripts/repro_2d_dma.py``'s kernel) on the
card: build, three runs, and a check that every value is finite.

    python -m justrelax_tpu_torch.scripts.repro_2d_dma [2d|x|loop] [--device cpu]

It copies windows with dynamic offsets in x and y from a float32
``(4, 64, 64, 128)`` array, ``arange / 1e6``, into ``(1, 64, 64, 128)``
through ``ops/hopper_window_copy.py::window_copy``. It runs on the card by
default and raises without one; ``--device cpu`` runs the plain version.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from justrelax_tpu_torch.core.device import resolve_device
from justrelax_tpu_torch.ops.hopper_window_copy import MODES, _library, window_copy

N, X, Y, Z = 4, 64, 64, 128
W, Wy = 32, 40
R, Ry = 32, 16


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", nargs="?", default="2d", choices=MODES)
    p.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    x = (torch.arange(N * X * Y * Z, dtype=torch.float32, device=dev)
         .reshape(N, X, Y, Z) / 1e6)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        _library()
    print(f"mode={a.mode} build {time.perf_counter() - t0:.1f}s", flush=True)
    out = None
    for rep in range(3):
        t0 = time.perf_counter()
        out = window_copy(x, a.mode, W, Wy, R, Ry).cpu().numpy()
        print(f"run[{rep}] {time.perf_counter() - t0:.2f}s "
              f"finite={np.isfinite(out).all()} "
              f"sum={out.sum():.3f}", flush=True)
    print("PASS", flush=True)
    return out


if __name__ == "__main__":
    main()
