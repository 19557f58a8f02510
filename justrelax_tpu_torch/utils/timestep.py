"""Time-step control.

Counterpart of ``justrelax_tpu/utils/timestep.py``.
"""

from __future__ import annotations

import math

import torch

__all__ = ["compute_dt"]


def compute_dt(V, di, dt_diff: float = math.inf):
    """Advective CFL limit min_d(di_d / max|V_d|)·0.9, capped by the
    diffusive limit ``dt_diff``; a 0-d tensor on the velocities' device."""
    kw = dict(dtype=V[0].dtype, device=V[0].device)
    dt_adv = torch.tensor(math.inf, **kw)
    for v, d in zip(V, di):
        # a tensor numerator: ``float / tensor`` is reciprocal·float in torch
        dt_adv = torch.minimum(dt_adv, torch.tensor(d, **kw) / torch.max(torch.abs(v)))
    return torch.clamp_max(dt_adv * 0.9, dt_diff)
