"""SolKz analytic Stokes benchmark.

Counterpart of ``justrelax_tpu/models/solkz.py``: unit box with
exponentially depth-dependent viscosity η = exp(B·y), B = ln(Δη) = ln(1e6),
buoyancy ρ = −sin(2y)·cos(3πx), free slip, Re = 5π. Oracle: final absolute
residual < 1e-8 at 32² in f64 (tests/test_more_benchmarks.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs
from justrelax_tpu_torch.core.device import resolve_device
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.core.state import StokesState
from justrelax_tpu_torch.ops.bc import Faces, VelocityBoundaryConditions
from justrelax_tpu_torch.solvers.stokes2d import solve_ve

__all__ = ["run"]


def run(nx=32, ny=32, d_eta=1.0e6, iter_max=500_000, nout=5_000, dtype=None,
        device=None, use_kernel=None):
    """The SolKz solve; returns (geometry, stokes, info). ``device`` and
    ``use_kernel`` as in ``models/solcx.py::run``."""
    device = resolve_device(device)
    ni = (nx, ny)
    geometry = Geometry(ni, (1.0, 1.0))
    stokes = StokesState.make(ni, dtype=dtype, device=device)
    f = dict(dtype=stokes.P.dtype, device=device)
    X, Y = geometry.cell_centers_mesh()
    eta = np.exp(math.log(d_eta) * Y)
    rho = -np.sin(2.0 * Y) * np.cos(3.0 * np.pi * X)
    stokes = stokes.replace(
        viscosity=stokes.viscosity.replace(eta=torch.as_tensor(eta, **f)))
    rho_g = (torch.zeros(ni, **f), torch.as_tensor(rho, **f))
    pt_stokes = PTStokesCoeffs.make(
        geometry.li, geometry.di, Re=5.0 * math.pi, CFL=1.0 / math.sqrt(2.1))
    flow_bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True))
    G = torch.full(ni, math.inf, **f)
    K = torch.full(ni, math.inf, **f)
    stokes, info = solve_ve(stokes, pt_stokes, geometry, flow_bc, rho_g, G, K, 0.1,
                            iter_max=iter_max, nout=nout, use_kernel=use_kernel)
    return geometry, stokes, info
