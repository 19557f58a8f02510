"""Shared pieces of the accelerated pseudo-transient Stokes solvers, 2D.

Counterpart of ``justrelax_tpu/solvers/stokes2d.py``'s ``StokesSolveInfo``
and ``_norm``. The linear VE solve ``solve_ve`` is not ported yet.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

__all__ = ["StokesSolveInfo"]


class StokesSolveInfo(NamedTuple):
    iters: Any
    err: Any
    err_history: Any  # (max_chunks,) max-norm history, nan-padded
    norm_Rx: Any
    norm_Ry: Any
    norm_RP: Any


def _norm(x):
    return torch.linalg.vector_norm(x.reshape(-1))
