"""State and material conversion between the JAX package and the port.

The JAX package's containers turn into nested dicts of arrays with
``flax.serialization.to_state_dict`` (done by the caller, so this module
needs no JAX). ``stokes_state_from_dict`` and ``material_from_dict`` build
the port's :class:`StokesState` and :class:`MaterialStack` from such dicts
on a given device and dtype; ``to_state_dict`` turns a port container back
into the same nested dict of numpy arrays (``None`` where the JAX container
has an unused 3D field).
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from justrelax_tpu_torch.core.state import StokesState
from justrelax_tpu_torch.rheology.materials import MaterialStack

__all__ = ["stokes_state_from_dict", "material_from_dict", "to_state_dict"]


def _build(cls, d, dtype, device):
    hints = typing.get_type_hints(cls)
    values = {}
    for f in dataclasses.fields(cls):
        v = d[f.name]
        if dataclasses.is_dataclass(hints[f.name]):
            values[f.name] = _build(hints[f.name], v, dtype, device)
        elif v is None:
            values[f.name] = None
        else:
            values[f.name] = torch.tensor(np.array(v), dtype=dtype, device=device)
    return cls(**values)


def stokes_state_from_dict(d, device=None, dtype=None) -> StokesState:
    """Port ``StokesState`` from the JAX state's dict (``dtype=None`` keeps
    the arrays' own dtype)."""
    return _build(StokesState, d, dtype, device)


def material_from_dict(d, device=None, dtype=None) -> MaterialStack:
    """Port ``MaterialStack`` from the JAX ``MaterialStack``'s dict."""
    return _build(MaterialStack, d, dtype, device)


def to_state_dict(obj):
    """Nested dict of numpy arrays with the JAX container's keys."""
    if dataclasses.is_dataclass(obj):
        return {f.name: to_state_dict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return obj
