"""Checkpoint / restart.

Counterpart of ``justrelax_tpu/io/checkpoint.py``, with its file formats
unchanged, so that a checkpoint written by either package loads in the
other:

- :func:`checkpointing` / :func:`load_checkpoint`: the whole Stokes and
  thermal states plus (time, timestep) in one ``.npz``, written to a
  temporary file and renamed into place. Keys are the dataclass field paths
  under ``stokes/`` and ``thermal/`` (``stokes/tau_o/xy_c``,
  ``stokes/viscosity/eta_vep``, ``thermal/T``); a field that is ``None``
  (the 3D-only fields of a 2D state) is not written.
- :func:`checkpointing_particles` / :func:`load_checkpoint_particles`: a 2D
  particle set (positions, activity mask, ``min_xcell``, ``nxcell``), its
  per-particle fields under ``field/`` and (t, dt, it).
- :func:`checkpointing_hdf5` / :func:`load_checkpoint_hdf5`: the primary
  fields (τ, V, P, T) in float32, one HDF5 dataset each. ``h5py`` is
  imported inside these two functions, and a missing one raises.

Distributed runs pass a ``rank`` for per-rank files
(``checkpoint<rank>.npz``). Each tensor is copied to the host once per call.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional, Tuple

import numpy as np
import torch

from justrelax_tpu_torch.core.device import host, resolve_device
from justrelax_tpu_torch.core.state import StokesState, ThermalState
from justrelax_tpu_torch.particles.particles import Particles

__all__ = [
    "checkpointing",
    "load_checkpoint",
    "checkpointing_particles",
    "load_checkpoint_particles",
    "checkpointing_hdf5",
    "load_checkpoint_hdf5",
]


def _leaves(prefix: str, obj):
    """(key, tensor) of every field of a state, depth first in field order,
    keyed by its path as the JAX package's pytree paths are; ``None``
    fields are skipped."""
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            yield from _leaves(f"{prefix}{f.name}/", v)
        elif v is not None:
            yield prefix + f.name, v


def _atomic_savez(dst: str, payload: dict) -> None:
    d = os.path.dirname(os.path.abspath(dst)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **payload)
        os.replace(tmp, dst)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def checkpointing(
    dst: str,
    stokes: StokesState,
    thermal: Optional[ThermalState],
    time: float,
    timestep: float,
    rank: Optional[int] = None,
) -> str:
    """Atomic whole-state checkpoint → ``<dst>/checkpoint[rank].npz``."""
    name = f"checkpoint{rank if rank is not None else ''}.npz"
    path = os.path.join(dst, name)
    payload = {"time": np.asarray(time), "timestep": np.asarray(timestep)}
    payload.update((k, host(v)) for k, v in _leaves("stokes/", stokes))
    if thermal is not None:
        payload.update((k, host(v)) for k, v in _leaves("thermal/", thermal))
    _atomic_savez(path, payload)
    return path


def _unflatten_into(prefix: str, template, data: dict):
    """``template`` with each field stored under its key replaced by the
    stored array: its stored dtype, on the template field's device,
    contiguous. A field the file lacks keeps the template's tensor."""
    values = {}
    for f in dataclasses.fields(template):
        v = getattr(template, f.name)
        key = prefix + f.name
        if dataclasses.is_dataclass(v):
            values[f.name] = _unflatten_into(key + "/", v, data)
        elif v is not None and key in data:
            values[f.name] = torch.as_tensor(data[key], device=v.device).contiguous()
        else:
            values[f.name] = v
    return dataclasses.replace(template, **values)


def load_checkpoint(
    path: str,
    stokes_template: StokesState,
    thermal_template: Optional[ThermalState] = None,
) -> Tuple[StokesState, Optional[ThermalState], float, float]:
    """Restore (stokes, thermal, time, timestep) from a checkpoint file.

    The templates give the structure and the device (fresh states of the
    grid's size, ``StokesState.make(ni, device=...)``)."""
    with np.load(path) as data:
        d = dict(data)
    stokes = _unflatten_into("stokes/", stokes_template, d)
    thermal = (
        _unflatten_into("thermal/", thermal_template, d)
        if thermal_template is not None
        else None
    )
    return stokes, thermal, float(d["time"]), float(d["timestep"])


def checkpointing_particles(
    dst: str,
    particles: Particles,
    fields: Optional[dict] = None,
    t: float = 0.0,
    dt: float = 0.0,
    it: int = 0,
    rank: Optional[int] = None,
) -> str:
    """Atomic particle checkpoint → ``<dst>/particles[rank].npz``
    (reference ``checkpointing_particles``, miniapps/subduction/2D/
    Subduction2D.jl:271): positions, the activity mask, every per-particle
    field (phase, T, ...) and (t, dt, it)."""
    name = f"particles{rank if rank is not None else ''}.npz"
    path = os.path.join(dst, name)
    payload = {
        "t": np.asarray(t), "dt": np.asarray(dt), "it": np.asarray(it),
        "px": host(particles.px), "py": host(particles.py),
        "active": host(particles.active),
        "min_xcell": np.asarray(particles.min_xcell),
        "nxcell": np.asarray(particles.nxcell),
    }
    for k, v in (fields or {}).items():
        payload[f"field/{k}"] = host(v)
    _atomic_savez(path, payload)
    return path


def load_checkpoint_particles(path: str, device=None):
    """Restore ``(particles, fields, t, dt, it)`` saved by
    :func:`checkpointing_particles` (reference Subduction2D_restart.jl:81),
    each array in its stored dtype on ``device`` (the card by default)."""
    device = resolve_device(device)
    with np.load(path) as data:
        d = dict(data)

    def t(a):
        return torch.as_tensor(a, device=device).contiguous()

    particles = Particles(
        px=t(d["px"]), py=t(d["py"]), active=t(d["active"]),
        min_xcell=int(d["min_xcell"]), nxcell=int(d["nxcell"]),
    )
    fields = {k[len("field/"):]: t(v) for k, v in d.items() if k.startswith("field/")}
    return particles, fields, float(d["t"]), float(d["dt"]), int(d["it"])


def checkpointing_hdf5(
    dst: str,
    stokes: StokesState,
    thermal: Optional[ThermalState],
    time: float,
    timestep: float,
) -> str:
    """Field-wise float32 HDF5 checkpoint → ``<dst>/checkpoint.h5``
    (reference H5.jl:33-76)."""
    import h5py

    os.makedirs(dst, exist_ok=True)
    path = os.path.join(dst, "checkpoint.h5")
    fields = {
        "P": stokes.P,
        "Vx": stokes.V.Vx,
        "Vy": stokes.V.Vy,
        "txx": stokes.tau.xx,
        "tyy": stokes.tau.yy,
        "txy": stokes.tau.xy,
    }
    if stokes.V.Vz is not None:
        fields.update(Vz=stokes.V.Vz, tzz=stokes.tau.zz, tyz=stokes.tau.yz, txz=stokes.tau.xz)
    if thermal is not None:
        fields["T"] = thermal.T
    tmp = path + ".tmp"
    with h5py.File(tmp, "w") as f:
        f.attrs["time"] = float(time)
        f.attrs["timestep"] = float(timestep)
        for k, v in fields.items():
            f.create_dataset(k, data=host(v).astype(np.float32))
    os.replace(tmp, path)
    return path


def load_checkpoint_hdf5(path: str, device=None) -> Tuple[dict, float, float]:
    """``(fields, time, timestep)`` from :func:`checkpointing_hdf5`'s file:
    each field a float32 tensor on ``device`` (the card by default)."""
    import h5py

    device = resolve_device(device)
    out = {}
    with h5py.File(path, "r") as f:
        for k in f.keys():
            out[k] = torch.as_tensor(np.asarray(f[k]), device=device)
        time = float(f.attrs["time"])
        timestep = float(f.attrs["timestep"])
    return out, time, timestep
