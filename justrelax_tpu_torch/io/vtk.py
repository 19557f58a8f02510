"""VTK output for visualization (reference src/IO/VTK.jl:20-528).

Counterpart of ``justrelax_tpu/io/vtk.py``: dependency-free XML writers
whose files are byte for byte the JAX package's for the same inputs.

- :func:`save_vti`: uniform-grid ImageData (.vti) with cell and point data.
- :class:`VTKSeries`: a .pvd time series of .vti files.
- :func:`save_pvtk`: a .pvti index and one .vti piece per rank of a
  :class:`~justrelax_tpu_torch.parallel.decomp.Decomp2D`.
- :func:`save_particles`, :func:`save_marker_chain`: PolyData (.vtp).

Fields are tensors (on any device) or arrays, in this package's (x, y[, z])
axis order; each is copied to the host once and written in VTK's x-fastest
order as base64 of float32.
"""

from __future__ import annotations

import base64
import os
import struct
from typing import Any, Dict, Optional

import numpy as np

from justrelax_tpu_torch.core.device import host

__all__ = [
    "save_vti",
    "save_pvtk",
    "save_particles",
    "save_marker_chain",
    "VTKSeries",
]


def _vtk_order(A: np.ndarray) -> np.ndarray:
    """(x, y[, z]) indexed array → float32 in VTK x-fastest order."""
    if A.ndim == 2:
        A = A[:, :, None]
    return np.ascontiguousarray(A.transpose(2, 1, 0)).astype(np.float32)


def _data_array(name: str, A: np.ndarray) -> str:
    flat = _vtk_order(A).tobytes()
    payload = struct.pack("<Q", len(flat)) + flat
    b64 = base64.b64encode(payload).decode()
    return (
        f'<DataArray type="Float32" Name="{name}" format="binary" '
        f'NumberOfComponents="1">\n{b64}\n</DataArray>'
    )


def _write(path: str, parts) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(parts))


def save_vti(
    path: str,
    geometry,
    cell_data: Optional[Dict[str, Any]] = None,
    point_data: Optional[Dict[str, Any]] = None,
    extent_offset=None,
) -> str:
    """Write a .vti file with uniform spacing from ``geometry``.

    ``cell_data`` arrays have shape ``ni``; ``point_data`` arrays ``ni+1``.
    ``extent_offset`` shifts the written extent into global index space (used
    by :func:`save_pvtk` pieces; ``geometry.origin`` must then be the GLOBAL
    origin so VTK's ``origin + index·spacing`` lands correctly).
    """
    ni = geometry.ni
    ndim = len(ni)
    ext = tuple(ni) + (0,) * (3 - ndim)
    off = tuple(extent_offset or ()) + (0,) * (3 - len(extent_offset or ()))
    origin = tuple(geometry.origin) + (0.0,) * (3 - ndim)
    spacing = tuple(geometry.di) + (1.0,) * (3 - ndim)

    whole = (
        f"{off[0]} {off[0] + ext[0]} {off[1]} {off[1] + ext[1]} "
        f"{off[2]} {off[2] + ext[2]}"
    )
    parts = [
        '<?xml version="1.0"?>',
        '<VTKFile type="ImageData" version="1.0" byte_order="LittleEndian" header_type="UInt64">',
        f'<ImageData WholeExtent="{whole}" Origin="{origin[0]} {origin[1]} {origin[2]}" '
        f'Spacing="{spacing[0]} {spacing[1]} {spacing[2]}">',
        f'<Piece Extent="{whole}">',
    ]
    for tag, data in (("PointData", point_data), ("CellData", cell_data)):
        if data:
            parts.append(f"<{tag}>")
            parts += [_data_array(name, host(A)) for name, A in data.items()]
            parts.append(f"</{tag}>")
    parts += ["</Piece>", "</ImageData>", "</VTKFile>"]

    if not path.endswith(".vti"):
        path = path + ".vti"
    _write(path, parts)
    return path


class VTKSeries:
    """A .pvd collection of timestamped .vti files (reference VTKDataSeries)."""

    def __init__(self, path: str):
        if not path.endswith(".pvd"):
            path = path + ".pvd"
        self.path = path
        self._entries = []

    def append(self, geometry, time: float, cell_data=None, point_data=None) -> str:
        base = os.path.splitext(self.path)[0]
        fname = f"{base}_{len(self._entries):05d}.vti"
        save_vti(fname, geometry, cell_data=cell_data, point_data=point_data)
        self._entries.append((time, os.path.basename(fname)))
        self._write_index()
        return fname

    def _write_index(self) -> None:
        lines = [
            '<?xml version="1.0"?>',
            '<VTKFile type="Collection" version="1.0" byte_order="LittleEndian">',
            "<Collection>",
        ]
        for t, f in self._entries:
            lines.append(f'<DataSet timestep="{t}" group="" part="0" file="{f}"/>')
        lines += ["</Collection>", "</VTKFile>"]
        with open(self.path, "w") as fh:
            fh.write("\n".join(lines))


class _LocalGeometry:
    """A piece's grid: the rank's cells, the global spacing and origin."""

    def __init__(self, ni, di, origin):
        self.ni, self.di, self.origin = ni, di, origin


def save_pvtk(
    path: str,
    geometry,
    decomp,
    cell_data: Optional[Dict[str, Any]] = None,
) -> str:
    """Parallel VTK output: one ``.pvti`` index plus per-rank ``.vti`` pieces
    (reference ``save_pvtk`` for MPI runs, src/IO/VTK.jl).

    ``geometry`` describes the GLOBAL grid; ``decomp`` is a
    :class:`~justrelax_tpu_torch.parallel.decomp.Decomp2D`. ``cell_data``
    maps names to global (nx, ny) fields; each rank's owned block is sliced
    out and written as its own piece, as an MPI run would write it.
    """
    if not path.endswith(".pvti"):
        path = path + ".pvti"
    base = os.path.splitext(path)[0]

    nxl, nyl = decomp.nxl, decomp.nyl
    origin = tuple(geometry.origin) + (0.0,)
    spacing = tuple(geometry.di) + (1.0,)
    whole = f"0 {decomp.px * nxl} 0 {decomp.py * nyl} 0 0"
    fields = {name: host(A) for name, A in (cell_data or {}).items()}
    local_geometry = _LocalGeometry((nxl, nyl), geometry.di, geometry.origin)

    pieces = []
    for ix in range(decomp.px):
        for iy in range(decomp.py):
            piece_path = f"{base}_{ix}_{iy}.vti"
            local = {
                name: A[ix * nxl:(ix + 1) * nxl, iy * nyl:(iy + 1) * nyl]
                for name, A in fields.items()
            }
            save_vti(piece_path, local_geometry, cell_data=local,
                     extent_offset=(ix * nxl, iy * nyl))
            ext = f"{ix * nxl} {(ix + 1) * nxl} {iy * nyl} {(iy + 1) * nyl} 0 0"
            pieces.append((os.path.basename(piece_path), ext))

    lines = [
        '<?xml version="1.0"?>',
        '<VTKFile type="PImageData" version="1.0" byte_order="LittleEndian" header_type="UInt64">',
        f'<PImageData WholeExtent="{whole}" GhostLevel="0" '
        f'Origin="{origin[0]} {origin[1]} {origin[2]}" '
        f'Spacing="{spacing[0]} {spacing[1]} {spacing[2]}">',
        "<PCellData>",
    ]
    for name in fields:
        lines.append(f'<PDataArray type="Float32" Name="{name}" NumberOfComponents="1"/>')
    lines.append("</PCellData>")
    for fname, ext in pieces:
        lines.append(f'<Piece Extent="{ext}" Source="{fname}"/>')
    lines += ["</PImageData>", "</VTKFile>"]
    _write(path, lines)
    return path


# --- PolyData writers (particles, marker chain) ------------------------------
def _poly_array(name: str, data: np.ndarray, dtype: str, ncomp: int = 1) -> str:
    np_dt = {"Float32": np.float32, "Int64": np.int64}[dtype]
    flat = np.ascontiguousarray(data, dtype=np_dt).tobytes()
    payload = struct.pack("<Q", len(flat)) + flat
    b64 = base64.b64encode(payload).decode()
    return (
        f'<DataArray type="{dtype}" Name="{name}" format="binary" '
        f'NumberOfComponents="{ncomp}">\n{b64}\n</DataArray>'
    )


def _write_polydata(path, points, point_data, verts=False, lines=False):
    """Minimal .vtp writer: ``points`` (n, 3) f32; ``verts`` emits one VERTEX
    cell per point, ``lines`` one polyline through all points."""
    n = points.shape[0]
    parts = [
        '<?xml version="1.0"?>',
        '<VTKFile type="PolyData" version="1.0" byte_order="LittleEndian" header_type="UInt64">',
        "<PolyData>",
        f'<Piece NumberOfPoints="{n}" NumberOfVerts="{n if verts else 0}" '
        f'NumberOfLines="{1 if lines else 0}" NumberOfStrips="0" NumberOfPolys="0">',
        "<Points>",
        _poly_array("Points", points, "Float32", ncomp=3),
        "</Points>",
    ]
    if point_data:
        parts.append("<PointData>")
        for name, A in point_data.items():
            parts.append(_poly_array(name, A.ravel(), "Float32"))
        parts.append("</PointData>")
    for tag, on, offsets in (("Verts", verts, np.arange(1, n + 1, dtype=np.int64)),
                             ("Lines", lines, np.asarray([n], dtype=np.int64))):
        if on:
            parts += [
                f"<{tag}>",
                _poly_array("connectivity", np.arange(n, dtype=np.int64), "Int64"),
                _poly_array("offsets", offsets, "Int64"),
                f"</{tag}>",
            ]
    parts += ["</Piece>", "</PolyData>", "</VTKFile>"]
    if not path.endswith(".vtp"):
        path = path + ".vtp"
    _write(path, parts)
    return path


def save_particles(path, particles, phases=None, fields=None, conversion=1.0,
                   precision=np.float32):
    """Active particles as VTK PolyData vertices
    (reference ``save_particles``, src/IO/VTK.jl:344-435).

    ``particles`` is a 2D :class:`~justrelax_tpu_torch.particles.particles.Particles`
    or 3D ``Particles3D`` container (slot layout; only ``active`` slots are
    written). ``phases`` (slot-shaped) becomes the "phase" point array;
    ``fields`` adds further slot-shaped point arrays. Coordinates are divided
    by ``conversion`` (reference default km→m is the caller's choice)."""
    act = host(particles.active).ravel()
    px = host(particles.px).ravel()[act] / conversion
    py = host(particles.py).ravel()[act] / conversion
    if getattr(particles, "pz", None) is not None:
        pz = host(particles.pz).ravel()[act] / conversion
    else:
        pz = np.zeros_like(px)
    points = np.stack([px, py, pz], axis=-1).astype(precision)
    data = {}
    if phases is not None:
        data["phase"] = host(phases).ravel()[act]
    for name, A in (fields or {}).items():
        data[name] = host(A).ravel()[act]
    return _write_polydata(path, points, data, verts=True)


def save_marker_chain(path, chain, precision=np.float32):
    """Marker chain as a single VTK polyline
    (reference ``save_marker_chain``, src/IO/VTK.jl:319-341)."""
    x = host(chain.x).astype(precision)
    h = host(chain.y).astype(precision)
    points = np.stack([x, h, np.zeros_like(x)], axis=-1)
    return _write_polydata(path, points, None, lines=True)
