"""State and material conversion between the JAX package and the port.

The JAX package's containers turn into nested dicts of arrays with
``flax.serialization.to_state_dict`` (done by the caller, so this module
needs no JAX). ``stokes_state_from_dict``, ``thermal_state_from_dict``, ``material_from_dict``,
``phase_ratios_from_dict``, ``particles_from_dict``,
``marker_chain_from_dict`` and ``rock_ratio_from_dict`` build the port's
:class:`StokesState`, :class:`ThermalState`, :class:`MaterialStack`,
:class:`PhaseRatios` / :class:`PhaseRatios3D`, :class:`Particles` /
:class:`Particles3D`, :class:`MarkerChain` and :class:`RockRatio` /
:class:`RockRatio3D` from such dicts on a given device (the card unless
given) and dtype; ``to_state_dict`` turns a port container back
into the same nested dict of numpy arrays (``None`` where the JAX container
has an unused 3D field). ``geometry_from_dict`` rebuilds a grid from the
JAX geometry's fields (``vars(geometry)``).
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from justrelax_tpu_torch.core.device import host, resolve_device
from justrelax_tpu_torch.core.grid import Geometry, NonuniformGeometry
from justrelax_tpu_torch.core.state import StokesState, ThermalState
from justrelax_tpu_torch.ops.rock_ratio import RockRatio, RockRatio3D
from justrelax_tpu_torch.particles.marker_chain import MarkerChain
from justrelax_tpu_torch.particles.particles import Particles
from justrelax_tpu_torch.particles.particles3d import Particles3D
from justrelax_tpu_torch.rheology.materials import MaterialStack
from justrelax_tpu_torch.rheology.phases import PhaseRatios, PhaseRatios3D

__all__ = ["stokes_state_from_dict", "thermal_state_from_dict", "material_from_dict",
           "phase_ratios_from_dict", "particles_from_dict", "marker_chain_from_dict",
           "rock_ratio_from_dict", "geometry_from_dict", "to_state_dict"]


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
    return _build(StokesState, d, dtype, resolve_device(device))


def thermal_state_from_dict(d, device=None, dtype=None) -> ThermalState:
    """Port ``ThermalState`` from the JAX state's dict (``dtype=None`` keeps
    the arrays' own dtype)."""
    return _build(ThermalState, d, dtype, resolve_device(device))


def material_from_dict(d, device=None, dtype=None) -> MaterialStack:
    """Port ``MaterialStack`` from the JAX ``MaterialStack``'s dict."""
    return _build(MaterialStack, d, dtype, resolve_device(device))


def phase_ratios_from_dict(d, device=None, dtype=None):
    """Port ``PhaseRatios`` (2D) or ``PhaseRatios3D`` (3D, told by its edge
    fields) from a mapping of the JAX ratios' field names to arrays, e.g.
    ``flax.serialization.to_state_dict`` of them or their ``_asdict()``
    (``dtype=None`` keeps the arrays' own dtype)."""
    cls = PhaseRatios3D if "edge_xy" in d else PhaseRatios
    device = resolve_device(device)
    return cls(**{f: torch.tensor(np.array(d[f]), dtype=dtype, device=device)
                  for f in cls._fields})


def particles_from_dict(d, device=None, dtype=None):
    """Port ``Particles`` (2D) or ``Particles3D`` (3D, told by a ``pz``
    field) from a mapping of the JAX particles' field names to arrays
    (``px``, ``py``[, ``pz``], ``active``) and its two static ints
    (``min_xcell``, ``nxcell``; 0 where absent, as flax's state dict leaves
    them out). ``dtype=None`` keeps the positions' own dtype."""
    device = resolve_device(device)
    axes = ("px", "py", "pz") if d.get("pz") is not None else ("px", "py")
    cls = Particles3D if len(axes) == 3 else Particles
    pos = {k: torch.tensor(np.array(d[k]), dtype=dtype, device=device) for k in axes}
    return cls(**pos, active=torch.tensor(np.array(d["active"]), dtype=torch.bool,
                                          device=device),
               min_xcell=int(d.get("min_xcell", 0)), nxcell=int(d.get("nxcell", 0)))


def marker_chain_from_dict(d, device=None, dtype=None) -> MarkerChain:
    """Port ``MarkerChain`` from a mapping with its ``x`` and ``y`` arrays
    (e.g. the JAX chain's ``_asdict()``; ``dtype=None`` keeps their own
    dtype)."""
    device = resolve_device(device)
    return MarkerChain(*(torch.tensor(np.array(d[k]), dtype=dtype, device=device)
                         for k in MarkerChain._fields))


def rock_ratio_from_dict(d, device=None, dtype=None):
    """Port ``RockRatio`` (2D) or ``RockRatio3D`` (3D, told by a ``Vz``
    field) from a mapping of the JAX rock ratio's field names to arrays
    (its ``_asdict()``, or numpy arrays; ``dtype=None`` keeps their own
    dtype)."""
    cls = RockRatio3D if "Vz" in d else RockRatio
    device = resolve_device(device)
    return cls(**{f: torch.tensor(np.array(d[f]), dtype=dtype, device=device)
                  for f in cls._fields})


def geometry_from_dict(d):
    """Port ``Geometry`` from a mapping of the JAX geometry's field names to
    values (``ni``, ``li`` and ``origin``), or ``NonuniformGeometry`` where
    it has the nonuniform spacing families (from the vertex vectors
    ``xvi``)."""
    if "di_center" in d:
        return NonuniformGeometry(tuple(np.asarray(v, dtype=float) for v in d["xvi"]))
    return Geometry(tuple(int(n) for n in d["ni"]), tuple(float(v) for v in d["li"]),
                    tuple(float(o) for o in d["origin"]))


def to_state_dict(obj):
    """Nested dict of numpy arrays with the JAX container's keys."""
    if dataclasses.is_dataclass(obj):
        return {f.name: to_state_dict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, torch.Tensor):
        return host(obj)
    return obj
