"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` has a plain C interface. ``build_library`` compiles one
with ``nvcc`` for sm_90a into ``justrelax_tpu_torch/_build/``, named by the
source's hash (reused when it exists), and ``load_library`` opens it with
``ctypes`` once per process. No ``--use_fast_math``: the kernels divide by
∞ (``1/(G·dt)`` with G = ∞) and need IEEE results.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC", "build_library", "load_library"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"


def build_library(source: Path) -> Path:
    """Compile ``source`` into a shared library and return its path. The
    compiler output, with ptxas' register and spill report, goes to a
    ``.log`` file beside it."""
    source = Path(source)
    src = source.read_bytes()
    out = _BUILD_DIR / f"lib{source.stem}_{hashlib.sha256(src).hexdigest()[:12]}.so"
    if out.exists():
        return out
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found: {source.name} is built on a machine "
                           "with the CUDA toolkit")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
           "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load_library(source: Path) -> ctypes.CDLL:
    """The built library of ``source``, opened once per process, with
    ``jr_cuda_error_string`` typed (every source exports it)."""
    lib = ctypes.CDLL(str(build_library(source)))
    lib.jr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.jr_cuda_error_string.restype = ctypes.c_char_p
    return lib
